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
