"""Disaggregated prefill → decode across two processes on the CPU: the
port's launcher runs paddle_tpu_torch/profile_disagg.py (gpt_tiny,
bf16 and int8 pools) under a seeded fault plan — a `sock.send` error on
rank 0's second frame, a 0.2 s `sock.recv` stall on rank 1's first.

Rank 1's tokens decoded from the streamed pages equal the JAX package's
single-process `LLMEngine` greedy tokens on the same weights (the port's
seeded init carried across by `convert.export_state_dict`), as do its
local engine's. Every page sent is imported, the trace ids arrive in
order and stamped `kv_transfer`, the send fault was absorbed by a
resend (`send_retries`), and both ranks' journals hold the injection.
chip_smoke phase 5l checks the same on the card at gpt_small.
"""
import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import profile_disagg
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 180
KV = ("bfloat16", "int8")
SPEC = profile_disagg.MODELS["gpt_tiny"]
SEED, PROMPT_SEED = profile_disagg.SEED, profile_disagg.PROMPT_SEED
PLAN = json.dumps({"seed": 77, "injectors": [
    {"scope": "sock.send", "kind": "error", "at": [1], "ranks": [0]},
    {"scope": "sock.recv", "kind": "delay", "at": [0], "delay_s": 0.2,
     "ranks": [1]}]})


def _run_launch(cmd, env, timeout=LAUNCH_TIMEOUT_S):
    """Run the launcher in a session of its own; on a timeout SIGTERM it
    (it kills its pod's process group), then SIGKILL what is left."""
    p = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGTERM)
        try:
            out, err = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, err = p.communicate()
        pytest.fail(f"launch timed out after {timeout} s\n{out}\n{err}")
    return p.returncode, out, err


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("disagg")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["PT_CHAOS_PLAN"] = PLAN
    rc, out, err = _run_launch(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--log_dir={tmp}/log",
         os.path.join(ROOT, "paddle_tpu_torch", "profile_disagg.py"),
         "--model", "gpt_tiny", "--device", "cpu", "--kv", ",".join(KV),
         "--out", str(tmp)], env)
    outs = []
    for r in range(2):
        path = tmp / f"disagg_out_{r}.json"
        outs.append(json.loads(path.read_text()) if path.exists() else None)
    return dict(rc=rc, out=out, err=err, tmp=tmp, r0=outs[0], r1=outs[1])


@pytest.fixture(scope="module")
def reference_tokens():
    """The JAX package's single-process engine, every prompt at once,
    greedy, on the port's seeded weights."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(SPEC["config"](), device="cpu", seed=SEED)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    prompts = profile_disagg.prompts_of(SPEC, tm.config.vocab_size,
                                        PROMPT_SEED)
    toks = {}
    for kv in KV:
        eng = jeng.LLMEngine(jm, jeng.LLMEngineConfig(kv_dtype=kv,
                                                      **SPEC["engine"]))
        reqs = [eng.add_request(p, max_new_tokens=SPEC["new_tokens"])
                for p in prompts]
        while eng.has_work():
            eng.step()
        toks[kv] = [np.asarray(r.future.result(timeout=0))[len(p):]
                    .tolist() for r, p in zip(reqs, prompts)]
    return toks


def test_launch_exits_zero(run):
    assert run["rc"] == 0, f"stdout:{run['out']}\nstderr:{run['err']}"
    assert run["r0"]["rank"] == 0 and run["r1"]["rank"] == 1
    assert run["r1"]["device_name"] == "cpu"


@pytest.mark.parametrize("kv", KV)
def test_disaggregated_tokens_equal_the_reference_engine(
        run, reference_tokens, kv):
    rows = run["r1"]["pools"][kv]["received"]
    assert sorted(r["prompt"] for r in rows) == list(range(len(
        SPEC["prompt_lens"])))
    for r in rows:
        assert r["tokens"] == reference_tokens[kv][r["prompt"]], r["prompt"]
        assert len(r["tokens"]) == SPEC["new_tokens"]


@pytest.mark.parametrize("kv", KV)
def test_local_engine_tokens_equal_the_reference_engine(
        run, reference_tokens, kv):
    for r in run["r1"]["pools"][kv]["received"]:
        assert r["local_tokens"] == reference_tokens[kv][r["prompt"]]
        assert r["equal"] is True and r["first_diff"] is None


@pytest.mark.parametrize("kv", KV)
def test_pages_and_trace_ids_cross_intact(run, kv):
    p0, p1 = run["r0"]["pools"][kv], run["r1"]["pools"][kv]
    assert p1["kv_pages_imported"] == p0["sent_pages"] > 0
    assert p0["sent_pages"] == sum(-(-(n - 1) // 16)
                                   for n in SPEC["prompt_lens"])
    assert p1["recv_trace_ids"] == p0["trace_ids"]
    assert len(set(p0["trace_ids"])) == len(p0["trace_ids"])
    assert all(r["transfer_stamped"] for r in p1["received"])
    assert [r["pages"] for r in p1["received"]] == [
        r["pages"] for r in p0["streamed"]]


def test_send_fault_absorbed_and_journaled(run):
    assert run["r0"]["send_retries"] >= 1
    for rank, scope in ((0, "sock.send"), (1, "sock.recv")):
        path = run["tmp"] / "log" / f"anomalies.rank{rank}.jsonl"
        events = [json.loads(line) for line in path.read_text().splitlines()]
        assert any(e["kind"] == "chaos_injected" and e["scope"] == scope
                   for e in events), scope
    assert any(e["kind"] == "retry" and e["op"] == "sock.send:1"
               for e in map(json.loads, (run["tmp"] / "log" /
                                         "anomalies.rank0.jsonl")
                            .read_text().splitlines()))


@pytest.mark.parametrize("kv", KV)
def test_legs_and_counts_are_reported(run, kv):
    p0, p1 = run["r0"]["pools"][kv], run["r1"]["pools"][kv]
    for row in p0["streamed"]:
        for key in ("prefill_ms", "gather_ms", "send_ms", "pack_ms"):
            assert math.isfinite(row[key]) and row[key] >= 0, key
        assert row["frame_bytes"] > 0 and row["t_send0"] > 0
    for row in p1["received"]:
        for key in ("unpack_ms", "import_ms", "ttft_ms"):
            assert math.isfinite(row[key]) and row[key] >= 0, key
    assert p1["decode_tok_s"] > 0 and p1["local"]["tok_s"] > 0
    # the counts move on the card only: present, and 0 on the CPU
    for counts in (p0, p1, p1["local"]):
        assert set(counts["launches"]) >= {"rpa", "rpa_int8"}
        assert not any(counts["launches"].values())
    assert p0["peak_mb"] is None
