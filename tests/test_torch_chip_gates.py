"""chip_smoke.py's launch-count gates, on synthetic profiles (CPU).

The paged-attention gates of the fused window (5d) and the propose
window (5e) take their exact K1 counts from the paged wrapper's
counters across a graph replay and ask the profiler only which kernels
ran: the profiler drops a record now and then, so a replay whose
records fall one short still passes, with the shortfall printed. Any
other difference fails.
"""
import importlib.util
import os
import types

import pytest
from torch.autograd import DeviceType

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_gates", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(key, count, cuda=True):
    return types.SimpleNamespace(
        key=key, count=count,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def _replay(tc=60, plan=60, merge=60, graphs=1, extra=()):
    rows = [_row("void rpa_tc_plan_kernel(int const*, int*)", plan),
            _row("void rpa_tc_kernel<64, 1>(RpaTcArgs)", tc),
            _row("void rpa_tc_merge_kernel<64>(float const*, __nv_bfloat16*)",
                 merge),
            _row("cudaGraphLaunch", graphs, cuda=False),
            _row("ampere_bf16_s16816gemm_bf16_128x64", 240)]
    return rows + [_row(k, n) for k, n in extra]


EXACT = {"launches": {"rpa": 60}, "tc_launches": {"rpa": 60}}


def test_one_record_short_passes_and_prints_the_shortfall(smoke):
    ok, text = smoke._paged_records(_replay(tc=59), EXACT, "rpa", 60,
                                    "K1 in the replay")
    assert ok
    assert "shortfall 1" in text and "rpa_tc_kernel 59" in text
    assert "{'rpa': 60}" in text


def test_every_record_passes_with_none_short(smoke):
    ok, text = smoke._paged_records(_replay(), EXACT, "rpa", 60, "K1")
    assert ok and "none short" in text


@pytest.mark.parametrize("case", [
    "count_off", "cuda_core", "other_pool", "foreign_kernel",
    "no_graph", "no_record", "too_many"])
def test_gate_fails_on_a_real_difference(smoke, case):
    counted = {k: dict(v) for k, v in EXACT.items()}
    rows = _replay()
    if case == "count_off":          # the wrapper counted one launch less
        counted = {"launches": {"rpa": 59}, "tc_launches": {"rpa": 59}}
    elif case == "cuda_core":        # a launch left the tensor-core route
        counted["tc_launches"] = {"rpa": 59}
    elif case == "other_pool":       # counted under another pool's key
        counted = {"launches": {"rpa_int8": 60},
                   "tc_launches": {"rpa_int8": 60}}
    elif case == "foreign_kernel":   # K2 or the CUDA-core K1 ran
        rows = _replay(extra=[("void rpa_kernel<float, 0>(RpaArgs)", 1)])
    elif case == "no_graph":
        rows = _replay(graphs=0)
    elif case == "no_record":
        rows = _replay(tc=0)
    elif case == "too_many":
        rows = _replay(tc=61)
    ok, _ = smoke._paged_records(rows, counted, "rpa", 60, "K1")
    assert not ok


def test_the_cells_launcher_starts_without_torch(smoke, tmp_path):
    """The multi-process cells' launcher (`launcher_cmd`) is the user's
    command, `python -m paddle_tpu_torch.distributed.launch`: it spawns
    its ranks before it imports torch (≈ 10 s on the card's host), then
    hosts their store (PADDLE_MASTER_HOSTED)."""
    import json
    import subprocess
    import sys

    probe = tmp_path / "probe.py"
    probe.write_text(
        "import json, os, sys\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "mods = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'paddle_tpu_torch'))\n"
        "with open(os.path.join(sys.argv[1], f'mods_{rank}.json'), 'w') "
        "as f:\n"
        "    json.dump([mods, os.environ['PADDLE_MASTER_HOSTED']], f)\n")
    cmd = smoke.launcher_cmd(2, str(tmp_path / "log"))
    assert cmd[1:3] == ["-m", "paddle_tpu_torch.distributed.launch"]
    out = subprocess.run(
        [cmd[0], "-X", "importtime", *cmd[1:], str(probe), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    # the launcher's imports in order: its own modules, then (the spawn
    # between them) torch for the store
    mods = [line.rsplit("|", 1)[-1].strip() for line in
            out.stderr.splitlines() if line.startswith("import time:")]
    first_torch = min(i for i, m in enumerate(mods)
                      if m.split(".")[0] == "torch")
    assert "paddle_tpu_torch.distributed.launch.master" in \
        mods[:first_torch]
    for r in range(2):
        with open(tmp_path / f"mods_{r}.json") as f:
            assert json.load(f) == [[], "1"]


def test_profile_dist_records_its_start_in_order(tmp_path):
    """profile_dist.py's ranks stamp their start (imports, rendezvous,
    model, every rank ready) into the record chip_smoke prints."""
    import json
    import subprocess
    import sys

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_launch", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cmd = mod.launcher_cmd(2, str(tmp_path / "log")) + [
        os.path.join("paddle_tpu_torch", "profile_dist.py"), "--model",
        "gpt_tiny", "--device", "cpu", "--sharding", "2", "--steps", "1",
        "--batch", "4", "--seq", "16", "--out", str(tmp_path)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    outs = []
    for r in range(2):
        with open(tmp_path / f"dist_out_{r}.json") as f:
            outs.append(json.load(f))
    for o in outs:
        st = o["startup"]
        seq = [st[k] for k in ("imports", "rendezvous", "model", "ready")]
        assert seq == sorted(seq) and seq[0] > 0, st
    mod.print_startup("cpu", outs, outs[0]["startup"]["proc_start"] - 1.0)
