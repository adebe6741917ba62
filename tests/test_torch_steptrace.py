"""The training goodput plane (observability/steptrace.py) and
TrainStep's telemetry: the PyTorch port against the JAX package on CPU.

Pins, after tests/test_steptrace.py: the segments-sum-to-wall-clock
identity (unrounded) for the instrumented TrainStep; quiet warm-up (a
step with a new batch signature stays out of pt_train_phase_seconds);
first-wins stamps and the ckpt_snapshot carve-out; off mode emitting
nothing; the recompile sentinel (counter + flight postmortem); the MFU /
goodput gauges against the H100's 989 TFLOP/s; straggler_of and
collective_bytes_per_second equal to the reference's on the same inputs;
full mode's loss / grad-norm metrics and chrome step events; and losses
bit-identical across telemetry modes (the plane only observes).
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.observability import steptrace as jst
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.rng import seed
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.observability import steptrace
from paddle_tpu_torch.observability import tracing as obs_tracing
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.torch_port

# the chain identity is exact up to float telescoping
SUM_TOL = 1e-9
EMITTING = {"data_wait", "h2d", "dispatch", "device_step", "opt_publish"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mode(tmp_path, monkeypatch):
    """Restore the mode and drop steptrace / tracing state after each
    test; full mode's exports go to a temporary directory."""
    monkeypatch.setenv("PT_TELEMETRY_DIR", str(tmp_path))
    prev = obs.mode()
    yield obs
    obs.set_mode(prev)
    obs_tracing.reset()
    steptrace.reset()


def _tiny_step(s=0):
    seed(s)
    m = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    g = torch.Generator().manual_seed(s)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    opt = AdamW(1e-3, parameters=m.parameters())
    step = TrainStep(m, lambda mm, x, y: TF.cross_entropy(mm(x), y), opt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (4,)))
    return m, opt, step, x, y


def _assert_identity(rec):
    dts = [e["dt_s"] for e in rec["timeline"]]
    assert all(dt >= 0.0 for dt in dts)
    assert abs(sum(dts) - rec["total_s"]) < SUM_TOL


def test_trainstep_phase_identity_and_quiet_warmup(mode):
    """4 calls → 3 ring records (the first signature's step runs quiet);
    each record's segments sum exactly to its wall time, stamps arrive
    in the canonical order, and the histogram carries every phase."""
    obs.set_mode("metrics")
    steptrace.reset()
    ps0 = steptrace.phase_summary()
    _, opt, step, x, y = _tiny_step()
    for _ in range(4):
        step(x, y)
    assert opt._step_count == 4
    recs = steptrace.recent_steps()
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(r["family"] == "train" for r in recs)
    order = {p: i for i, p in enumerate(("start",) + steptrace.PHASES)}
    for rec in recs:
        _assert_identity(rec)
        names = [e["phase"] for e in rec["timeline"]]
        assert names[0] == "start"
        idx = [order[n] for n in names]
        assert idx == sorted(idx), names
        assert EMITTING <= set(names)
    ps = steptrace.phase_summary()
    for phase in EMITTING:
        delta = ps[phase]["count"] - ps0.get(phase, {}).get("count", 0)
        assert delta == 3, (phase, delta)
    assert "start" not in ps
    reg = obs.registry()
    assert reg.get("pt_train_steps_total").value >= 4
    assert reg.get("pt_train_step_seconds").count >= 4


def test_stamp_first_wins_and_replay_noop(mode):
    obs.set_mode("metrics")
    tr = steptrace.begin_step("train", 7, prev_end=100.0, t_entry=100.25)
    assert tr.stamp("h2d", 100.3)
    assert not tr.stamp("h2d", 999.0)     # replay keeps the first truth
    assert tr.phases["h2d"] == 100.3
    tr.stamp("dispatch", 100.4)
    tr.stamp("opt_publish", 100.5)
    total, end_t = steptrace.end_step(tr)
    assert total == pytest.approx(0.5)
    assert end_t == 100.5
    tl = tr.timeline()
    assert [e["phase"] for e in tl] == \
        ["start", "data_wait", "h2d", "dispatch", "opt_publish"]
    assert sum(e["dt_s"] for e in tl) == pytest.approx(total, abs=SUM_TOL)
    assert tr.to_dict()["phases"] == tr.phases
    # the reference's trace of the same stamps: the same timeline
    jtr = jst.StepTrace("train", 7, phases=tr.phases)
    assert jtr.timeline() == tl and jtr.total_s() == tr.total_s()


def test_ckpt_snapshot_carved_from_data_wait(mode):
    obs.set_mode("metrics")
    steptrace.reset()
    steptrace.note_ckpt_snapshot(100.05, 100.2)
    tr = steptrace.begin_step("train", 3, prev_end=100.0, t_entry=100.25)
    assert [e["phase"] for e in tr.timeline()] == \
        ["start", "ckpt_snapshot", "data_wait"]
    tr2 = steptrace.begin_step("train", 4, prev_end=200.0, t_entry=200.1)
    assert "ckpt_snapshot" not in tr2.phases


def test_off_mode_emits_nothing(mode):
    obs.set_mode("off")
    steptrace.reset()
    _, _, step, x, y = _tiny_step()
    for _ in range(3):
        step(x, y)
    assert steptrace.recent_steps() == []
    assert not steptrace.active()


def test_recompile_sentinel_counts_and_dumps(mode, tmp_path, monkeypatch):
    """Signature growth past the first increments
    pt_step_recompiles_total{step}, runs that step quiet, and dumps a
    flight-recorder postmortem carrying recent timelines; past
    max_batch_signatures a RuntimeWarning is raised once."""
    monkeypatch.setenv("PT_FLIGHT_DIR", str(tmp_path))
    obs.set_mode("metrics")
    steptrace.reset()
    reg = obs.registry()

    def n_rec():
        c = reg.get("pt_step_recompiles_total")
        return 0 if c is None else c.labels(step="train").value

    base = n_rec()
    compiles = reg.get("pt_train_compiles_total").value
    _, _, step, x, y = _tiny_step()
    step(x, y)                    # first signature — not a recompile
    step(x, y)
    assert n_rec() == base
    assert reg.get("pt_train_compiles_total").value == compiles + 1
    n_ring = len(steptrace.recent_steps())
    step(torch.zeros(6, 8), torch.zeros(6, dtype=torch.int64))
    assert n_rec() == base + 1
    assert len(steptrace.recent_steps()) == n_ring     # ran quiet
    dumps = sorted(tmp_path.glob("postmortem.*.step_recompile.json"))
    assert dumps, list(tmp_path.iterdir())
    post = json.loads(dumps[-1].read_text())
    assert post["context"]["signatures"] == 2
    assert post["context"]["family"] == "train"
    assert "recent_steps" in post["states"]
    assert any(e["kind"] == "step_recompile" for e in post["events"])
    step.max_batch_signatures = 2
    with pytest.warns(RuntimeWarning, match="distinct batch shapes"):
        step(torch.zeros(5, 8), torch.zeros(5, dtype=torch.int64))
    assert step.num_batch_signatures == 3


def test_goodput_gauges_against_the_h100_peak(mode, monkeypatch):
    from paddle_tpu_torch.profile_train import H100_PEAK_BF16

    assert steptrace.DEFAULT_PEAK_FLOPS == H100_PEAK_BF16 == 989e12
    obs.set_mode("metrics")
    steptrace.reset()
    steptrace.arm_goodput(flops_per_step=1e12, tokens_per_step=4096)
    assert steptrace.goodput_armed()
    tr = steptrace.begin_step("train", 1, prev_end=1000.0, t_entry=1000.1)
    tr.stamp("h2d", 1000.2)
    tr.stamp("opt_publish", 1000.5)
    total, _ = steptrace.end_step(tr)
    reg = obs.registry()
    assert reg.get("pt_train_mfu").value == pytest.approx(
        1e12 / total / 989e12)
    assert reg.get("pt_train_tokens_per_second").value == \
        pytest.approx(4096 / total)
    mfu = reg.get("pt_train_mfu").value
    trq = steptrace.begin_step("train", 2, prev_end=2000.0, quiet=True,
                               t_entry=2000.1)
    trq.stamp("opt_publish", 2000.9)
    steptrace.end_step(trq)
    assert reg.get("pt_train_mfu").value == mfu    # quiet steps: no move
    prev = steptrace.arm_goodput()                 # no args = disarm
    assert prev["peak"] == 989e12 and not steptrace.goodput_armed()
    monkeypatch.setenv("PT_PEAK_FLOPS", "2e14")
    steptrace.arm_goodput(flops_per_step=1.0)
    assert steptrace.arm_goodput()["peak"] == 2e14


def test_straggler_and_collective_attribution_match_reference():
    base = {"start": 0.0, "data_wait": 0.01, "h2d": 0.02,
            "dispatch": 0.05, "opt_publish": 0.06}
    slow = dict(base, dispatch=0.15, opt_publish=0.16)
    views = [{"rank": 0, "phases": base}, {"rank": 1, "phases": slow},
             {"rank": 2, "phases": base}]
    out = steptrace.straggler_of(views)
    assert out == jst.straggler_of(views)
    assert out["rank"] == 1 and out["phase"] == "dispatch"
    assert out["lag_s"] == pytest.approx(0.10)
    tl = lambda dt: [{"phase": "start", "t": 0.0, "dt_s": 0.0},  # noqa: E731
                     {"phase": "h2d", "t": dt, "dt_s": dt}]
    views2 = [None, {"rank": 3, "timeline": tl(0.02), "total_s": 0.02},
              {"rank": 4, "timeline": tl(0.30), "total_s": 0.30}]
    assert steptrace.straggler_of(views2) == jst.straggler_of(views2)
    assert steptrace.straggler_of(views2)["rank"] == 4
    assert steptrace.straggler_of([]) is None
    for args in ((({"dp": 100, "mp": 500}, 0.10, {"dp": 600, "mp": 500},
                   0.20)), ({"dp": 0}, 0.30, {"dp": 100}, 0.20)):
        assert steptrace.collective_bytes_per_second(*args) == \
            jst.collective_bytes_per_second(*args)
    assert steptrace.model_flops({"hidden_size": 64, "num_layers": 4,
                                  "vocab_size": 256}, 8, 32) == \
        jst.model_flops({"hidden_size": 64, "num_layers": 4,
                         "vocab_size": 256}, 8, 32)


def test_full_mode_loss_grad_norm_and_chrome_events(mode):
    """Full mode: pt_train_loss is the step's loss, pt_train_grad_norm
    the f32 global L2 norm of the raw gradients, and every non-quiet
    segment becomes a step.<phase> chrome event keyed by step."""
    obs.set_mode("full")
    obs_tracing.reset()
    steptrace.reset()
    m, _, step, x, y = _tiny_step()
    reg = obs.registry()
    n0 = reg.get("pt_train_grad_norm").count
    for _ in range(3):
        loss = step(x, y)
    assert reg.get("pt_train_loss").value == float(loss)
    h = reg.get("pt_train_grad_norm")
    assert h.count == n0 + 3
    s0 = h.sum
    step(x, y)     # one more: the observed value is this step's norm
    norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                          for p in m.parameters()))
    assert h.sum - s0 == pytest.approx(float(norm), rel=1e-6)
    evs = [e for e in obs.chrome_events() if e["name"].startswith("step.")]
    assert {"step." + p for p in EMITTING} <= {e["name"] for e in evs}
    assert all("step" in e["args"] and "family" in e["args"] for e in evs)
    assert {e["args"]["step"] for e in evs} == {1, 2, 3}
    assert any(e["name"] == "jit.TrainStep" for e in obs.chrome_events())


def test_losses_bit_identical_across_telemetry_modes(mode):
    """bench_steptrace_overhead_ab's check at gpt_tiny: the same steps in
    off, metrics and full mode give the same loss bits."""
    from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                  GPTForCausalLM,
                                                  GPTPretrainingCriterion)

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                             (4, 32)))
    runs = {}
    for name in ("full", "metrics", "off"):
        obs.set_mode(name)
        steptrace.reset()
        seed(0)
        m = GPTForCausalLM(cfg, device="cpu", seed=0)
        step = TrainStep(m, lambda mm, i: GPTPretrainingCriterion()(
            mm(i), i), AdamW(1e-3, parameters=m.parameters()))
        runs[name] = [step(ids).item() for _ in range(5)]
        if name != "off":
            recs = steptrace.recent_steps()
            assert len(recs) == 4
            for rec in recs:
                _assert_identity(rec)
    assert runs["full"] == runs["metrics"] == runs["off"]
    assert runs["off"][-1] < runs["off"][0]
