"""Transient-fault hardening: the PyTorch port's resilience module
against the JAX package's on the same inputs.

`RetryPolicy` on one seeded `rng` draws the same backoff sequence,
retries the same number of times, sleeps the same lengths, raises the
same `RetryError` (exhaustion, `give_up_on`, deadline) and journals the
same kinds. `StepGuard` and `DivergenceSentinel` fed the same loss
sequences (NaN, Inf, spikes, the skip window, the rollback budget) make
the same decisions and raise the same exceptions; the port reads a torch
tensor as a loss. `PreemptionHandler` under a SIGTERM to this process
drains into a stub checkpointer. Mirrors the resilience cases of
tests/test_chaos.py.
"""
import math
import random
import signal

import pytest
import torch

from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu.distributed import resilience as jres
from paddle_tpu_torch.distributed import chaos as tchaos
from paddle_tpu_torch.distributed import resilience as tres

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


BOTH = ((jres, jchaos), (tres, tchaos))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PT_ANOMALY_DIR", "PADDLE_LOG_DIR", jchaos.ENV_PLAN):
        monkeypatch.delenv(var, raising=False)
    for res, ch in BOTH:
        ch.clear()
        res.reset()
    yield
    for res, ch in BOTH:
        ch.clear()
        res.reset()


@pytest.fixture
def sleeps(monkeypatch):
    """Record RetryPolicy's sleeps instead of sleeping (both modules
    call the one `time.sleep`)."""
    got = []
    monkeypatch.setattr(tres.time, "sleep", got.append)
    return got


def _kinds(res):
    return [e["kind"] for e in res.events()]


@pytest.mark.parametrize("kw", [
    dict(), dict(base_s=0.01, multiplier=3.0, max_backoff_s=0.5),
    dict(base_s=0.2, jitter=0.0), dict(base_s=0.05, jitter=1.0,
                                       max_backoff_s=10.0)])
def test_backoff_sequence_matches_reference(kw):
    seqs = []
    for res, _ in BOTH:
        pol = res.RetryPolicy(rng=random.Random(11), **kw)
        seqs.append([pol.backoff(a) for a in range(12)])
    assert seqs[0] == seqs[1]
    assert all(b > 0 for b in seqs[1])


@pytest.mark.parametrize("fails", [0, 1, 2, 4])
def test_retry_run_matches_reference(sleeps, fails):
    outs = []
    for res, _ in BOTH:
        del sleeps[:]
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise OSError(f"transient {calls['n']}")
            return 41

        seen = []
        pol = res.RetryPolicy(max_attempts=5, base_s=0.01, name="flaky:k",
                              rng=random.Random(3))
        got = pol.run(flaky, on_retry=lambda a, e: seen.append(
            (a, repr(e))))
        outs.append((got, calls["n"], list(sleeps), seen, _kinds(res),
                     dict(res.stats["retries"]), res.recent_failures()))
    assert outs[0] == outs[1]
    assert outs[1][1] == fails + 1 and len(outs[1][2]) == fails
    assert tres._RETRIES_TOTAL.labels(op="flaky").value >= fails


def test_retry_exhaustion_matches_reference(sleeps):
    outs = []
    for res, _ in BOTH:
        del sleeps[:]

        def always():
            raise OSError("nope")

        pol = res.RetryPolicy(max_attempts=3, base_s=0.001, name="x",
                              rng=random.Random(5))
        with pytest.raises(res.RetryError) as ei:
            pol.run(always)
        assert isinstance(ei.value, TimeoutError)
        outs.append((str(ei.value), repr(ei.value.last),
                     repr(ei.value.__cause__), list(sleeps), _kinds(res),
                     dict(res.stats["giveups"])))
    assert outs[0] == outs[1]
    assert outs[1][4] == ["retry"] * 3 + ["retry_exhausted"]
    assert tres._GIVEUPS_TOTAL.labels(op="x").value >= 1


def test_give_up_on_and_retry_on_match_reference(sleeps):
    outs = []
    for res, _ in BOTH:
        del sleeps[:]
        pol = res.RetryPolicy(max_attempts=5, base_s=0.001,
                              give_up_on=(FileNotFoundError,),
                              name="ckpt.read:a")

        def missing():
            raise FileNotFoundError("shard")

        with pytest.raises(res.RetryError) as ei:
            pol.run(missing)
        # an exception outside retry_on propagates untouched
        with pytest.raises(ValueError, match="not transient"):
            pol.run(lambda: (_ for _ in ()).throw(
                ValueError("not transient")))
        outs.append((str(ei.value), list(sleeps), _kinds(res),
                     [e["attempts"] for e in res.events(
                         "retry_exhausted")]))
    assert outs[0] == outs[1]
    assert outs[1][1] == [] and outs[1][3] == [1]


def test_deadline_cuts_unlimited_policy_short():
    for res, _ in BOTH:
        def always():
            raise OSError("down")

        pol = res.RetryPolicy(max_attempts=None, base_s=0.01, name="y")
        with pytest.raises(res.RetryError, match="gave up"):
            pol.run(always, deadline_s=0.1)
        assert res.events("retry_exhausted")[-1]["op"] == "y"


def _guard_run(res, ch, losses, **kw):
    res.reset()
    guard = res.StepGuard(**kw)
    got = []
    for step, loss in enumerate(losses):
        try:
            got.append(guard.check(loss, step=step))
        except res.StepAbort as e:
            got.append(("abort", str(e)))
            break
    return got, guard.skipped, guard.ok, _kinds(res)


NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("losses,kw", [
    ([1.5, NAN, INF, 0.5, NAN, NAN, NAN], dict(max_consecutive_skips=2)),
    ([1.0, 2.0, -INF, 3.0], dict()),
    ([NAN] * 7, dict(max_consecutive_skips=5)),
    ([0.1, NAN, 0.2, NAN, 0.3, NAN], dict(max_consecutive_skips=0)),
])
def test_step_guard_matches_reference(losses, kw):
    ref = _guard_run(jres, jchaos, losses, **kw)
    # the port reads torch tensors (0-d and [1], f32 and bf16) as losses
    dtypes = (torch.float32, torch.bfloat16)
    tl = [torch.tensor(v, dtype=dtypes[i % 2]).reshape(
        () if i % 3 else (1,)) for i, v in enumerate(losses)]
    assert _guard_run(tres, tchaos, tl, **kw) == ref
    assert _guard_run(tres, tchaos, losses, **kw) == ref


def test_step_guard_chaos_poison_matches_reference():
    outs = []
    for res, ch in BOTH:
        ch.install({"injectors": [
            {"scope": "step.nan", "kind": "nan", "at": [1, 3]}]})
        outs.append(_guard_run(res, ch, [1.0] * 5))
    assert outs[0] == outs[1]
    assert outs[1][:3] == ([True, False, True, False, True], 2, 3)
    assert outs[1][3].count("chaos_injected") == 2


def _sentinel_run(res, ch, losses, **kw):
    res.reset()
    s = res.DivergenceSentinel(**kw)
    got = []
    for step, loss in enumerate(losses):
        if s.should_skip(step):
            got.append("skip")
            continue
        try:
            got.append(s.check(loss, step=step))
        except res.DivergenceRollback as e:
            got.append(("rollback", e.reason, e.step, str(e)))
        except res.StepAbort as e:
            got.append(("abort", str(e)))
            break
    return (got, s.poisoned_steps(), s.rollbacks, s.ok, _kinds(res),
            [(e.get("reason"), e.get("rollbacks"))
             for e in res.events("rollback")])


@pytest.mark.parametrize("losses,kw", [
    ([1.0, NAN, 1.0], dict(max_rollbacks=2)),
    ([1.0, 1.01, 1.02, 1.03, 2.0, 50.0, 1.0, 1.0],
     dict(window=8, spike_factor=4.0, min_history=4)),
    ([INF, NAN, 1.0], dict(max_rollbacks=1)),
    ([1.0] * 6 + [NAN] + [1.0] * 4, dict(skip_window=3)),
    ([2.0, 2.0, 2.0, 9.0, 2.0, 2.0, 30.0, 2.0, NAN, NAN],
     dict(window=4, min_history=2, spike_factor=3.0, max_rollbacks=3)),
])
def test_divergence_sentinel_matches_reference(losses, kw):
    ref = _sentinel_run(jres, jchaos, losses, **kw)
    got = _sentinel_run(tres, tchaos, [torch.tensor(v) for v in losses],
                        **kw)
    assert got == ref
    assert any(isinstance(g, tuple) for g in got[0])


class _StubCheckpointer:
    def __init__(self):
        self.calls = []

    def wait(self):
        self.calls.append("wait")

    def save(self, step):
        self.calls.append(("save", step))


@pytest.mark.parametrize("res", [jres, tres], ids=["reference", "port"])
def test_preemption_handler_drains_on_sigterm(res):
    before = signal.getsignal(signal.SIGTERM)
    h = res.install_preemption_handler()
    try:
        assert not h.triggered()
        signal.raise_signal(signal.SIGTERM)
        assert h.triggered()
        ck = _StubCheckpointer()
        assert h.drain(ck, step=5)
        assert ck.calls == ["wait", ("save", 5), "wait"]
        assert _kinds(res) == ["preempt_signal", "preempt_drain"]
        assert res.events("preempt_drain")[-1]["step"] == 5
    finally:
        h.restore()
    assert signal.getsignal(signal.SIGTERM) == before


def test_scalar_reads_torch_and_python_losses():
    assert tres._scalar(torch.tensor([2.5, 9.0])) == 2.5
    assert tres._scalar(torch.tensor(1.5, dtype=torch.bfloat16)) == 1.5
    assert math.isnan(tres._scalar(torch.tensor(float("nan"))))
    assert tres._scalar(3) == 3.0 and tres._scalar([0.25]) == 0.25
