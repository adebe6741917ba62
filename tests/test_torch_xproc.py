"""The port's cross-process transport and collectives
(paddle_tpu_torch/distributed/xproc.py, collective.py) against the JAX
package's xproc.

In process, over a local TCPStore: the store get retried through
injected `kv.get` faults, the connect retried until a peer listens (the
reference's tests/test_chaos.py cases), the frame header byte-equal to
the reference's, the `stats` view, frames over a transport's own
listener (tags out of order, a resent duplicate dropped), the one-process
collectives and the int8 wire's frames (byte-equal to the reference's).

One 2-process launch (`python -m paddle_tpu_torch.distributed.launch`,
gloo on the CPU) covers send / recv of bytes and arrays over several
tags out of order, every `all_reduce_np` op on int32 / float32 / float64
against the reference's `_NP_REDUCERS` on the stacked inputs (values and
dtypes), `all_gather_bytes`, `all_gather_obj`, `broadcast_np`,
`barrier`, the tensor API (`all_reduce`, `broadcast`, `send` / `recv`,
`reduce`, `scatter`, `all_gather`, the object collectives,
`batch_isend_irecv`) and a chaos `sock.send` fault absorbed by a resend
with the frame byte-equal.
"""
import datetime
import os
import pickle
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from paddle_tpu.distributed import xproc as jxp
from paddle_tpu_torch.distributed import chaos as tchaos
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.distributed import xproc as txp

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 180
OPS = ("sum", "avg", "max", "min", "prod")
DTYPES = ("int32", "float32", "float64")


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv(tchaos.ENV_PLAN, raising=False)
    tchaos.clear()
    tres.reset()
    yield
    tchaos.clear()
    tres.reset()


@pytest.fixture
def store(monkeypatch):
    """A TCPStore hosted in this process, standing in for the job's."""
    s = tdist.TCPStore("127.0.0.1", 0, None, True,
                       timeout=datetime.timedelta(seconds=10),
                       wait_for_workers=False)
    monkeypatch.setattr(txp, "_kv_client", lambda: s)
    return s


def test_kv_get_retries_through_injected_failures(store):
    store.set("k", "v")
    tchaos.install({"injectors": [
        {"scope": "kv.get", "kind": "error", "at": [0, 1]},
        {"scope": "kv.set", "kind": "error", "at": [0]}]})
    before = txp.stats["kv_retries"]
    assert txp._kv_get("k", 5000) == "v"
    assert txp.stats["kv_retries"] - before >= 2
    txp._kv_set("k2", "w")
    assert store.get("k2") == b"w"
    assert txp.stats["kv_retries"] - before >= 3
    assert [e["op"] for e in tres.events("retry")] == [
        "kv.get:k", "kv.get:k", "kv.set:k2"]


def test_kv_get_times_out_under_the_callers_deadline(store):
    with pytest.raises(tres.RetryError, match="kv.get:absent"):
        txp._kv_get("absent", 300)
    assert tres.events("retry_exhausted")[-1]["op"] == "kv.get:absent"


def test_conn_to_retries_until_peer_listens(store):
    """A peer mid-restart refuses connections; _conn_to must retry under
    the caller's deadline instead of failing the collective."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))      # bound but NOT listening → refused
    port = srv.getsockname()[1]
    store.set("pt_p2p_ep/1", f"127.0.0.1:{port}")
    threading.Timer(0.5, srv.listen, args=(1,)).start()
    tr = txp._SocketTransport()
    try:
        assert store.get("pt_p2p_ep/0").decode().startswith("127.0.0.1:")
        before = txp.stats["connect_retries"]
        slot = tr._conn_to(1, 10_000)
        assert slot["sock"] is not None
        assert txp.stats["connect_retries"] - before >= 1
    finally:
        if tr._conns.get(1, {}).get("sock"):
            tr._conns[1]["sock"].close()
        tr._lsock.close()
        srv.close()


def test_frames_over_own_listener_out_of_order(store):
    """Frames to this process's own endpoint: recv by (src, tag, seq)
    in any order; a resent duplicate of a consumed frame is dropped;
    the sock.send fault is absorbed by a resend."""
    tr = txp._SocketTransport()
    tchaos.install({"injectors": [
        {"scope": "sock.send", "kind": "error", "at": [1]}]})
    try:
        retries = txp.stats["send_retries"]
        frames = [(5, 0, b"a" * 10), (7, 0, b"b" * 70_000),
                  (5, 1, os.urandom(3 << 20)), (7, 1, b"")]
        for tag, seq, data in frames:
            tr.send(data, 0, tag, seq, 10_000)
        assert txp.stats["send_retries"] - retries == 1
        for tag, seq, data in reversed(frames):
            assert tr.recv(0, tag, seq, 10_000) == data
        tr.send(frames[0][2], 0, 5, 0, 10_000)     # a resent duplicate
        tr.send(b"next", 0, 5, 2, 10_000)
        assert tr.recv(0, 5, 2, 10_000) == b"next"
        assert (0, 5, 0) not in tr._inbox
        with pytest.raises(TimeoutError, match="src=0 tag=9 seq=0"):
            tr.recv(0, 9, 0, 50)
    finally:
        tr._lsock.close()
        for slot in tr._conns.values():
            if slot["sock"] is not None:
                slot["sock"].close()


def test_kv_debug_transport_through_the_store(monkeypatch, store):
    """PADDLE_TPU_P2P_TRANSPORT=kv: frames ride the store (base64) and
    a consumed key is deleted."""
    monkeypatch.setenv("PADDLE_TPU_P2P_TRANSPORT", "kv")
    bulk = txp.stats["kv_bulk_bytes"]
    payload = os.urandom(1000)
    txp.send_bytes(payload, 0, tag=0x7A)
    txp.send_np(np.arange(6, dtype=np.int16).reshape(2, 3), 0, tag=0x7B)
    assert txp.stats["kv_bulk_bytes"] - bulk >= 4 * 1000 // 3
    assert txp.recv_bytes(0, tag=0x7A) == payload
    got = txp.recv_np(0, tag=0x7B)
    assert got.dtype == np.int16 and got.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert not store.check([f"pt_p2p/0/0/{0x7A}/0"])


def test_frame_header_is_the_reference_header():
    assert txp._HDR.format == jxp._HDR.format
    for args in ((0, 0, 0, 0), (1, 0x4B56, 7, 33 << 20),
                 (-1, -2, 2**40, 2**62)):
        assert txp._HDR.pack(*args) == jxp._HDR.pack(*args)


def test_stats_view_keys_and_offsets():
    assert list(txp.stats) == list(jxp.stats) and len(txp.stats) == 7
    txp._BYTES_TOTAL.labels(channel="p2p").inc(5)
    with pytest.warns(DeprecationWarning):
        txp.stats["p2p_bytes"] = 0
    assert txp.stats["p2p_bytes"] == 0
    txp._BYTES_TOTAL.labels(channel="p2p").inc(3)
    assert txp.stats["p2p_bytes"] == 3
    with pytest.raises(KeyError), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        txp.stats["nope"] = 1
    with pytest.raises(TypeError):
        del txp.stats["p2p_bytes"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES + ("bool", "float16"))
def test_one_process_collectives_are_the_reference_identity(op, dtype):
    x = (np.arange(6) % 3).astype(dtype).reshape(2, 3)
    got = txp.all_reduce_np(x, op=op)
    want = jxp._NP_REDUCERS[op](x[None])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(txp.all_gather_np(x), x[None])
    assert np.array_equal(txp.broadcast_np(x, src=0), x)
    txp.barrier()


def test_no_runtime_raises_the_reference_shape(monkeypatch):
    monkeypatch.setattr(txp, "_transport", None)
    for call in (lambda: txp.send_bytes(b"x", 1),
                 lambda: txp.recv_bytes(0, timeout_ms=10),
                 lambda: txp.send_np(np.zeros(3), 1)):
        with pytest.raises(RuntimeError, match="multi-process runtime"):
            call()
    assert txp._transport is None


def test_int8_wire_raises_naming_a11(monkeypatch, store):
    """The int8 wire (PT_QUANT_ALLREDUCE=1): an eligible float payload
    sent with `send_np` travels as the reference's PTQ8 frame, byte for
    byte, and `recv_np` decodes it to the reference's values; a poisoned
    block decodes to NaN; quantize=False, integer and small payloads stay
    exact; a one-process all-reduce is the identity, as the reference's
    compiled path."""
    from paddle_tpu.quantization import runtime as jrt
    from paddle_tpu_torch.quantization import runtime as trt

    monkeypatch.setenv("PT_QUANT_ALLREDUCE", "1")
    monkeypatch.setenv("PADDLE_TPU_P2P_TRANSPORT", "kv")
    rng = np.random.default_rng(0)
    big = (rng.standard_normal((3, 1500)) * 5).astype(np.float32)
    poisoned = big.copy()
    poisoned[1, 7] = np.nan
    for arr in (big, poisoned, big.astype(np.float64)):
        assert trt.encode_int8_wire(arr) == jrt.encode_int8_wire(arr)
        txp.send_np(arr, 0, tag=0x51)
        raw = txp.recv_bytes(0, tag=0x51)
        assert raw == jrt.encode_int8_wire(arr) and trt.is_quant_wire(raw)
        txp.send_np(arr, 0, tag=0x52)
        got = txp.recv_np(0, tag=0x52)
        want = jrt.decode_int8_wire(jrt.encode_int8_wire(arr))
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, want)
    nan_rows = np.isnan(trt.decode_int8_wire(
        trt.encode_int8_wire(poisoned))).reshape(-1)
    assert nan_rows[:2048].all() and not nan_rows[2048:].any()
    assert trt.WIRE_MAGIC == jrt.WIRE_MAGIC == txp._QUANT_WIRE_MAGIC
    for arr in (np.ones(3, np.float32), np.ones(1024, np.int32)):
        assert trt.wire_eligible(arr) == jrt.wire_eligible(arr) is False
    txp.send_np(big, 0, tag=0x53, quantize=False)
    np.testing.assert_array_equal(txp.recv_np(0, tag=0x53), big)
    # exact payloads stay exact: ints, small arrays, max / min
    assert txp.all_reduce_np(np.ones(1024, np.int32)).dtype == np.int64
    np.testing.assert_array_equal(txp.all_reduce_np(big), big)
    assert txp.all_reduce_np(big, op="max") is not None
    assert txp.all_reduce_np(np.ones(8, np.float32)).shape == (8,)


# ---- the 2-process launch ----

WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np, torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import xproc

    OPS = {ops!r}
    DTYPES = {dtypes!r}

    def inputs(rank, op, dtype):
        rng = np.random.default_rng([rank, OPS.index(op), DTYPES.index(dtype)])
        if dtype == "int32":
            return rng.integers(-9, 10, (3, 5)).astype(np.int32)
        return (rng.standard_normal((3, 5)) * 3).astype(dtype)

    def main():
        dist.init_parallel_env(device="cpu")
        r, w = dist.get_rank(), dist.get_world_size()
        out = {{"rank": r, "world": w}}
        # p2p: several tags, out of order
        big = np.random.default_rng(9).integers(0, 255, 5 << 20, np.uint8)
        if r == 0:
            xproc.send_bytes(b"tag5-0", 1, tag=5)
            xproc.send_bytes(big.tobytes(), 1, tag=7)
            xproc.send_bytes(b"tag5-1", 1, tag=5)
            xproc.send_np(np.arange(12, dtype=np.float64).reshape(3, 4), 1,
                          tag=9)
            xproc.send_np(np.array([[1, -2]], np.int16), 1, tag=9)
        else:
            out["p2p"] = [xproc.recv_np(0, tag=9), xproc.recv_bytes(0, tag=5),
                          xproc.recv_bytes(0, tag=7) == big.tobytes(),
                          xproc.recv_np(0, tag=9), xproc.recv_bytes(0, tag=5)]
        out["reduce"] = {{(op, dt): xproc.all_reduce_np(inputs(r, op, dt), op)
                         for op in OPS for dt in DTYPES}}
        out["gather_bytes"] = xproc.all_gather_bytes(b"r" * (3 + 40 * r))
        out["gather_obj"] = xproc.all_gather_obj({{"rank": r, "x": [r] * r}})
        out["gather_np"] = xproc.all_gather_np(np.full((2,), r, np.int64))
        out["bcast"] = xproc.broadcast_np(
            np.arange(4, dtype=np.float32) * (r + 1), src=1)
        xproc.barrier()
        # the tensor API
        t = torch.tensor([1.5, -2.0]) * (r + 1)
        dist.all_reduce(t)
        b = torch.tensor([r + 0.25, r - 3.0], dtype=torch.bfloat16)
        dist.broadcast(b, src=1)
        i = torch.tensor([10 * r + 1, 7], dtype=torch.int64)
        dist.all_reduce(i, op=dist.ReduceOp.MAX)
        red = torch.tensor([2.0 + r])
        dist.reduce(red, dst=0, op=dist.ReduceOp.PROD)
        sc = torch.zeros(3)
        dist.scatter(sc, [torch.full((3,), 5.0), torch.full((3,), 6.0)]
                     if r == 0 else None, src=0)
        parts = []
        dist.all_gather(parts, torch.tensor([r, r * 2], dtype=torch.int32))
        objs = []
        dist.all_gather_object(objs, ("obj", r))
        scat = []
        dist.scatter_object_list(scat, [{{"to": 0}}, {{"to": 1}}]
                                 if r == 1 else None, src=1)
        if r == 0:
            dist.send(torch.tensor([3.25, 4.5], dtype=torch.bfloat16), dst=1)
            got = torch.zeros(2, dtype=torch.int64)
            dist.recv(got, src=1)
        else:
            got = torch.zeros(2, dtype=torch.bfloat16)
            dist.recv(got, src=0)
            dist.send(torch.tensor([8, 9]), dst=0)
        x = torch.full((2,), float(r))
        y = torch.zeros(2)
        peer = 1 - r
        dist.batch_isend_irecv([dist.P2POp(dist.irecv, y, peer),
                                dist.P2POp(dist.isend, x, peer)])
        out["tensors"] = dict(all_reduce=t, broadcast=b, max=i, reduce=red,
                              scatter=sc, all_gather=parts, objects=objs,
                              scatter_objects=scat, recv=got, exchange=y)
        out["send_retries"] = xproc.stats["send_retries"]
        with open(os.path.join(sys.argv[1], f"xproc_{{r}}.pkl"), "wb") as f:
            pickle.dump(out, f)
        xproc.barrier()

    main()
''').format(ops=OPS, dtypes=DTYPES)


def _worker_inputs(rank, op, dtype):
    rng = np.random.default_rng([rank, OPS.index(op), DTYPES.index(dtype)])
    if dtype == "int32":
        return rng.integers(-9, 10, (3, 5)).astype(np.int32)
    return (rng.standard_normal((3, 5)) * 3).astype(dtype)


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


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop(tchaos.ENV_PLAN, None)
    env.update(extra or {})
    return env


# rank 0's sock.send call 1 is the 5 MiB frame (tag 7)
PLAN = ('{"seed": 3, "injectors": [{"scope": "sock.send", "kind": '
        '"error", "at": [1], "ranks": [0]}]}')


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xproc")
    (tmp / "worker.py").write_text(WORKER)
    rc, out, err = _run_launch(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--log_dir={tmp}/log",
         str(tmp / "worker.py"), str(tmp)],
        _env({tchaos.ENV_PLAN: PLAN}))
    assert rc == 0, f"stdout:{out}\nstderr:{err}"
    res = []
    for r in range(2):
        with open(tmp / f"xproc_{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, tmp


def test_launch_two_ranks(launched):
    res, _ = launched
    assert [(o["rank"], o["world"]) for o in res] == [(0, 2), (1, 2)]


def test_p2p_tags_out_of_order(launched):
    (_, one), _ = launched
    a, b5, big_ok, c, b5b = one["p2p"]
    np.testing.assert_array_equal(a, np.arange(12.0).reshape(3, 4))
    assert a.dtype == np.float64
    assert b5 == b"tag5-0" and b5b == b"tag5-1" and big_ok is True
    assert c.dtype == np.int16 and c.tolist() == [[1, -2]]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_all_reduce_np_equals_reference_reducers(launched, op, dtype):
    res, _ = launched
    want = jxp._NP_REDUCERS[op](np.stack(
        [_worker_inputs(r, op, dtype) for r in range(2)]))
    for o in res:
        got = o["reduce"][(op, dtype)]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_gathers_broadcast_and_barrier(launched):
    res, _ = launched
    for o in res:
        assert o["gather_bytes"] == [b"r" * 3, b"r" * 43]
        assert o["gather_obj"] == [{"rank": 0, "x": []},
                                   {"rank": 1, "x": [1]}]
        np.testing.assert_array_equal(o["gather_np"], [[0, 0], [1, 1]])
        np.testing.assert_array_equal(o["bcast"],
                                      np.arange(4, dtype=np.float32) * 2)


def test_tensor_api(launched):
    res, _ = launched
    for r, o in enumerate(res):
        t = o["tensors"]
        assert t["all_reduce"].tolist() == [4.5, -6.0]
        assert t["broadcast"].dtype == torch.bfloat16
        assert t["broadcast"].tolist() == [1.25, -2.0]
        assert t["max"].tolist() == [11, 7] and t["max"].dtype == torch.int64
        assert t["reduce"].tolist() == ([6.0] if r == 0 else [3.0])
        assert t["scatter"].tolist() == [5.0 + r] * 3
        assert [p.tolist() for p in t["all_gather"]] == [[0, 0], [1, 2]]
        assert all(p.dtype == torch.int32 for p in t["all_gather"])
        assert t["objects"] == [("obj", 0), ("obj", 1)]
        assert t["scatter_objects"] == [{"to": r}]
        assert t["exchange"].tolist() == [float(1 - r)] * 2
    assert res[1]["tensors"]["recv"].tolist() == [3.25, 4.5]
    assert res[0]["tensors"]["recv"].tolist() == [8, 9]


def test_chaos_send_fault_absorbed_frame_byte_equal(launched):
    res, tmp = launched
    assert res[0]["send_retries"] >= 1 and res[1]["send_retries"] == 0
    # the faulted send is the 5 MiB frame: resent whole, byte-equal
    assert res[1]["p2p"][2] is True
    journal = (tmp / "log" / "anomalies.rank0.jsonl").read_text()
    assert '"chaos_injected"' in journal and '"sock.send"' in journal
