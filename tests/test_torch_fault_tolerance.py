"""`fleet.elastic.run_with_fault_tolerance` over the port's Checkpointer
(paddle_tpu_torch/distributed/fleet/elastic.py), against the JAX
package's supervision loop.

In one process: a fault injected at a step (a chaos plan on scope
``step``) restores the latest complete checkpoint and resumes to the
uninterrupted run's losses and parameters, exactly; the journal holds
the reference's events; a DivergenceRollback restores without consuming
a restart (max_restarts=0) and the sentinel's poisoned window is
skipped; an ElasticManager reporting a stale peer escalates at once;
restarts past max_restarts re-raise, with the RetryPolicy's backoff.

Launched (tests/torch_dist_worker.py `elastic`, 2 gloo processes, dp 2
DistributedTrainStep, a checkpoint every step): rank 1 SIGKILLs itself
after step 3, the launcher re-forms the pod under --max_restart, and the
resumed pod ends on the uninterrupted run's losses (equality: the same
two-process arithmetic).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import resilience as jres
from paddle_tpu.distributed.fleet import elastic as jel
from paddle_tpu_torch.distributed import chaos, resilience
from paddle_tpu_torch.distributed.checkpoint import Checkpointer
from paddle_tpu_torch.distributed.fleet import elastic as tel
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402
from test_torch_checkpoint import _loss_fn, _tiny_model_and_data  # noqa: E402
from test_torch_parallel_step import launch, reference_weights  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 6


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    monkeypatch.setattr(ckpt, "_FSYNC", False)
    resilience.reset()
    yield
    chaos.clear()


def _run(tmp_path, name, plan=None, **kw):
    """6 TrainStep steps under run_with_fault_tolerance, an async save
    every 3 steps; returns (losses by step, parameters, starts)."""
    m, xs, ys = _tiny_model_and_data()
    step = TrainStep(m, _loss_fn, AdamW(1e-2, parameters=m.parameters()))
    ck = Checkpointer(str(tmp_path / name), model=m, train_step=step,
                      async_save=True)
    losses, starts = {}, []

    def train_fn(start):
        starts.append(start)
        for s in range(start, STEPS):
            resilience.StepGuard().check(0.0, step=s)   # scope "step"
            losses[s] = float(step(xs, ys))
            if (s + 1) % 3 == 0:
                ck.save(s + 1)
        ck.wait()
        return STEPS

    if plan is not None:
        chaos.install(plan)
    assert tel.run_with_fault_tolerance(train_fn, ck, **kw) == STEPS
    return losses, {n: p.detach().clone()
                    for n, p in m.named_parameters()}, starts


def test_fault_restores_and_resumes_to_the_uninterrupted_run(tmp_path):
    ref, ref_params, ref_starts = _run(tmp_path, "ref")
    assert ref_starts == [0]
    # call 5 of scope "step": the 6th step (index 5) fails once
    got, params, starts = _run(
        tmp_path, "ft",
        plan={"injectors": [{"scope": "step", "kind": "error",
                             "at": [5]}]})
    assert starts == [0, 3]                  # restored the step-3 save
    assert got == ref
    assert all(torch.equal(params[n], ref_params[n]) for n in params)
    kinds = [e["kind"] for e in resilience.events()
             if e["kind"] in ("train_restart", "train_rollback")]
    assert kinds == ["train_restart"]


def test_divergence_rollback_consumes_no_restart(tmp_path):
    """A sentinel rollback restores through the loop even at
    max_restarts=0; the poisoned step is skipped on re-entry."""
    m, xs, ys = _tiny_model_and_data()
    step = TrainStep(m, _loss_fn, AdamW(1e-2, parameters=m.parameters()))
    ck = Checkpointer(str(tmp_path / "d"), model=m, train_step=step)
    sentinel = resilience.DivergenceSentinel(max_rollbacks=2)
    chaos.install({"injectors": [{"scope": "step.nan", "kind": "nan",
                                  "at": [4]}]})
    seen, starts = [], []

    def train_fn(start):
        starts.append(start)
        for s in range(start, STEPS):
            if sentinel.should_skip(s):
                continue
            loss = step(xs, ys)
            sentinel.check(loss, step=s)
            seen.append(s)
            ck.save(s + 1)
        return STEPS

    assert tel.run_with_fault_tolerance(train_fn, ck, max_restarts=0) == \
        STEPS
    assert starts == [0, 4] and seen == [0, 1, 2, 3, 5]
    assert [e["kind"] for e in resilience.events()
            if e["kind"].startswith("train_")] == ["train_rollback"]


class _StaleManager:
    enabled = True

    def watch(self):
        return tel.ElasticStatus.RESTART


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_stale_peer_escalates_and_restarts_are_bounded(tmp_path, pkg):
    """The same supervision contract in both packages: a stale peer
    escalates on the first failure; otherwise max_restarts bounds the
    retries (each journaled, with the policy's backoff between)."""
    el, res = (tel, resilience) if pkg == "port" else (jel, jres)
    res.reset()

    class _Ck:
        loads = 0

        def load_latest(self):
            _Ck.loads += 1
            return None

        def wait(self):
            pass

    calls = []

    def boom(start):
        calls.append(start)
        raise RuntimeError("worker lost")

    with pytest.raises(RuntimeError, match="worker lost"):
        el.run_with_fault_tolerance(boom, _Ck(), max_restarts=3,
                                    manager=_StaleManager())
    assert len(calls) == 1
    assert [e["kind"] for e in res.events()
            if e["kind"] in ("train_restart", "elastic_escalate")] == \
        ["train_restart", "elastic_escalate"]
    calls.clear()
    restarts = []
    policy = res.RetryPolicy(base_s=0.001, max_backoff_s=0.002)
    with pytest.raises(RuntimeError):
        el.run_with_fault_tolerance(boom, _Ck(), max_restarts=2,
                                    retry=policy,
                                    on_restart=restarts.append)
    assert len(calls) == 3 and restarts == [1, 2]


# ---- the launched SIGKILL ---------------------------------------------

def test_sigkill_worker_resumes_to_uninterrupted_loss(tmp_path):
    interrupted = tmp_path / "killed"
    ref = tmp_path / "ref"
    for d in (interrupted, ref):
        d.mkdir()
        reference_weights(str(d))
    (interrupted / "kill_marker").write_text("armed")
    rc, so, se = launch("elastic", interrupted, 2,
                        extra=("--max_restart=2",))
    assert rc == 0, f"{so}\n{se}"
    assert "restart 1/2" in se
    rc, so, se = launch("elastic", ref, 2)
    assert rc == 0, f"{so}\n{se}"
    for r in range(2):
        got = json.load(open(interrupted / f"elastic_r{r}.json"))
        want = json.load(open(ref / f"elastic_r{r}.json"))
        assert want["starts"] == [0] and got["attempt"] == "1"
        # the re-formed pod resumed from the checkpoint of step KILL_AT
        assert got["starts"] == [worker.KILL_AT]
        tail = {k: v for k, v in want["losses"].items()
                if int(k) >= worker.KILL_AT}
        assert got["losses"] == tail
        np.testing.assert_array_equal(
            got["losses"][str(worker.ELASTIC_STEPS - 1)],
            want["losses"][str(worker.ELASTIC_STEPS - 1)])
