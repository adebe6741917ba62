"""Eager cross-process collectives and the p2p byte transport
(counterpart of paddle_tpu/distributed/xproc.py; the same entry points,
frame header, metrics, spans, retry policies, chaos scopes and
messages).

Rank semantics match the reference: rank == trainer process index. The
runtime underneath is `torch.distributed` (distributed/env.py): a
TCPStore for the rendezvous and the key-value store, a gloo process
group for the collectives.

* **Collectives** (`all_reduce_np`, `all_gather_np`, `broadcast_np`,
  `barrier`, `all_gather_bytes`, `all_gather_obj`) run over the gloo
  group on CPU tensors. Results take the dtypes of the reference's CPU
  path (`_NP_REDUCERS` over the stacked inputs): `sum` of int32 is
  int64, `avg` of an integer array is float64. `sum` / `avg` / `max` /
  `min` reduce in gloo (in that result dtype); `prod` is
  gather-then-multiply, exact for negatives, zeros and integers, as the
  reference does; a dtype gloo cannot reduce (bool, unsigned wider than
  8 bits) takes the gather route too. A one-process job is the
  identity.
* **Point to point** (`send_bytes` / `recv_bytes`, `send_np` /
  `recv_np`): the store carries one host:port endpoint per rank, then
  payloads move over direct TCP sockets as raw bytes (`_SocketTransport`:
  a ``<iiqq`` header — src, tag, seq, length — an inbox keyed (src,
  tag, seq), duplicates of a resent frame dropped once consumed,
  per-destination connect slots; reconnect and resend under
  `_CONNECT_RETRY` / `_SEND_RETRY`, the ``sock.*`` chaos scopes).
  ``PADDLE_TPU_P2P_TRANSPORT=kv`` routes payloads through the store
  instead (base64, every byte transits the store; for debugging).
* The int8 wire (``PT_QUANT_ALLREDUCE=1``, ``PTQ8`` frames of
  `quantization.runtime.encode_int8_wire`): a sum / avg all-reduce of an
  eligible float payload (fp32 / fp64, at least 512 elements) across
  processes gathers every rank's frame and reduces the decoded matrix —
  each rank decodes its own frame too, so every rank reduces the same
  values — and `send_np` sends the frame (`recv_np` decodes it by its
  magic). Max / min / prod, integer payloads and `quantize=False` stay
  exact; `pt_quant_allreduce_bytes_saved` counts the bytes saved.
"""
import base64
import datetime
import io
import os
import pickle
import socket
import struct
import threading
import time
from collections.abc import MutableMapping

import numpy as np

from ..observability import metrics as _obs
from ..observability.tracing import trace_span as _trace_span
from . import chaos
from . import env as _env
from .resilience import RetryError, RetryPolicy

__all__ = ["is_multiprocess", "all_reduce_np", "all_gather_np",
           "broadcast_np", "barrier", "all_gather_bytes",
           "all_gather_obj", "send_bytes", "recv_bytes", "send_np",
           "recv_np", "stats"]


def _dist():
    import torch.distributed as dist

    return dist


def is_multiprocess():
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


# ---- telemetry ----
# bytes are one counter labeled by channel, retries one counter labeled
# by op (the reference's names)
_BYTES_TOTAL = _obs.counter(
    "pt_xproc_bytes_total",
    "cross-process traffic, by channel (p2p=payload submitted, "
    "socket=sent over TCP, kv_bulk=base64 through the store, "
    "gather=full gathered matrix received)",
    labelnames=("channel",), always_on=True)
_RETRIES_TOTAL = _obs.counter(
    "pt_xproc_retries_total",
    "transport retries, by op (kv covers get+set)",
    labelnames=("op",), always_on=True)


class _DeprecatedStats(MutableMapping):
    """Read-only view keeping the reference's ``xproc.stats`` keys over
    the registry counters. Reads return the counter value minus a
    per-key offset; assignment (deprecated — kept because harnesses
    reset keys to 0 between phases) only moves the offset, it never
    touches the underlying counters."""

    _KEYS = {
        "p2p_bytes": lambda: _BYTES_TOTAL.labels(channel="p2p").value,
        "gather_bytes": lambda: _BYTES_TOTAL.labels(
            channel="gather").value,
        "kv_bulk_bytes": lambda: _BYTES_TOTAL.labels(
            channel="kv_bulk").value,
        "socket_bytes": lambda: _BYTES_TOTAL.labels(
            channel="socket").value,
        "kv_retries": lambda: _RETRIES_TOTAL.labels(op="kv").value,
        "connect_retries": lambda: _RETRIES_TOTAL.labels(
            op="sock.connect").value,
        "send_retries": lambda: _RETRIES_TOTAL.labels(
            op="sock.send").value,
    }

    def __init__(self):
        self._offsets = {}

    def __getitem__(self, key):
        return int(self._KEYS[key]() - self._offsets.get(key, 0))

    def __setitem__(self, key, value):
        import warnings

        if key not in self._KEYS:
            raise KeyError(
                f"xproc.stats is a deprecated view over the telemetry "
                f"registry; unknown key {key!r}")
        warnings.warn(
            "writing xproc.stats is deprecated — it only offsets this "
            "view; use the observability registry "
            "(pt_xproc_bytes_total / pt_xproc_retries_total)",
            DeprecationWarning, stacklevel=2)
        self._offsets[key] = self._KEYS[key]() - value

    def __delitem__(self, key):
        raise TypeError("xproc.stats is a read-only view")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)


stats = _DeprecatedStats()


# ---- the int8 wire (quantization.runtime's codec) ----

_QUANT_SAVED = _obs.counter(
    "pt_quant_allreduce_bytes_saved",
    "wire bytes saved by the opt-in int8-with-scale codec "
    "(PT_QUANT_ALLREDUCE=1): raw float bytes minus encoded bytes, "
    "counted at the publishing rank, all-reduce fallback + p2p")


def _quant_runtime():
    """quantization.runtime, imported at first use (xproc loads with
    distributed, before quantization)."""
    from ..quantization import runtime

    return runtime


def _maybe_quant_encode(nparr, op):
    """(frame, decode) for a sum / avg all-reduce of an eligible payload
    under PT_QUANT_ALLREDUCE=1, else None (the exact path): max / min /
    prod on quantized values would change the selected element."""
    if op not in ("sum", "avg"):
        return None
    qrt = _quant_runtime()
    if not (qrt.quant_allreduce_enabled() and qrt.wire_eligible(nparr)):
        return None
    payload = qrt.encode_int8_wire(nparr)
    _QUANT_SAVED.inc(max(0, nparr.nbytes - len(payload)))
    return payload, qrt.decode_int8_wire


# checked by prefix, so recv never imports the codec for exact frames;
# np.save frames start with b"\x93NUMPY"
_QUANT_WIRE_MAGIC = b"PTQ8"


# ---- collectives ----

_NP_REDUCERS = {"sum": lambda m: m.sum(axis=0),
                "avg": lambda m: m.mean(axis=0),
                "max": lambda m: m.max(axis=0),
                "min": lambda m: m.min(axis=0),
                "prod": lambda m: m.prod(axis=0)}

# accumulation dtypes gloo reduces; the others take the gather route
_GLOO_DTYPES = (np.int8, np.uint8, np.int32, np.int64, np.float16,
                np.float32, np.float64)


def _u8(nparr):
    """A CPU uint8 tensor over a copy of the array's bytes."""
    import torch

    return torch.from_numpy(np.frombuffer(nparr.tobytes(), np.uint8).copy())


def _gather(nparr, group=None):
    """The stacked (world, ...) matrix of every rank's array (of every
    member's, in group-rank order, for a subgroup)."""
    dist = _dist()
    mine = _u8(nparr)
    parts = [mine.new_empty(mine.shape)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return np.stack([p.numpy().view(nparr.dtype).reshape(nparr.shape)
                     for p in parts])


def _accumulator(nparr, op):
    """(result dtype, accumulation dtype) of the reference's reducer."""
    out_dtype = _NP_REDUCERS[op](nparr[None]).dtype
    if op == "avg" and out_dtype == np.float16:
        return out_dtype, np.dtype(np.float32)  # numpy's mean of f16
    return out_dtype, out_dtype


def _gloo_reduce(nparr, op, out_dtype, acc, group=None):
    """sum / avg / max / min in gloo, in the reference's result dtype."""
    import torch

    dist = _dist()
    t = torch.from_numpy(np.array(nparr, dtype=acc, copy=True))
    red = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(t, op=red, group=group)
    out = t.numpy()
    if op == "avg":
        out = np.true_divide(out, dist.get_world_size(group), dtype=acc)
    return np.asarray(out.astype(out_dtype, copy=False))


def _collective_np(kind, nparr, op="sum", src=0, group=None):
    """Returns the gathered (world, ...) matrix for 'all_gather', the
    reduced / broadcast local value otherwise. `group`: a
    `torch.distributed` subgroup (None: the world); `src` is a global
    rank."""
    nparr = np.ascontiguousarray(nparr)
    with _trace_span(f"xproc.{kind}", op=op, bytes=int(nparr.nbytes)):
        if not is_multiprocess():
            if kind == "all_gather":
                return nparr[None].copy()
            if kind == "all_reduce":
                return _NP_REDUCERS[op](nparr[None])
            return nparr
        if kind == "all_gather":
            return _gather(nparr, group)
        if kind == "broadcast":
            t = _u8(nparr)
            _dist().broadcast(t, src=src, group=group)
            return t.numpy().view(nparr.dtype).reshape(nparr.shape)
        if kind == "all_reduce":
            enc = _maybe_quant_encode(nparr, op)
            if enc is not None:
                payload, decode = enc
                mat = np.stack([decode(b) for b in _gather_bytes(
                    payload, group)])
                return _NP_REDUCERS[op](mat).astype(nparr.dtype,
                                                    copy=False)
        out_dtype, acc = _accumulator(nparr, op)
        if op != "prod" and acc.type in _GLOO_DTYPES:
            return _gloo_reduce(nparr, op, out_dtype, acc, group)
        return _NP_REDUCERS[op](_gather(nparr, group))


def all_reduce_np(nparr, op="sum", group=None):
    """nparr (local value) -> reduced np.ndarray, same shape."""
    if op not in _NP_REDUCERS:
        raise ValueError(f"unknown reduce op {op}")
    return _collective_np("all_reduce", nparr, op=op, group=group)


def all_gather_np(nparr, group=None):
    """nparr (local value) -> stacked (world,)+shape np.ndarray."""
    return _collective_np("all_gather", nparr, group=group)


def broadcast_np(nparr, src=0, group=None):
    return _collective_np("broadcast", nparr, src=src, group=group)


def barrier():
    """Every rank arrives before any leaves (gloo's barrier)."""
    if is_multiprocess():
        with _trace_span("xproc.barrier"):
            _dist().barrier()


def all_gather_obj(obj, max_len=1 << 27):
    """Gather one picklable object per process (pickle + padded byte
    gather)."""
    blobs = all_gather_bytes(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
        max_len=max_len)
    return [pickle.loads(b) for b in blobs]


def all_gather_bytes(payload: bytes, max_len=1 << 20):
    """Gather variable-length byte strings: length-prefixed, padded
    uint8 buffers (the reference's all_gather_object)."""
    return _gather_bytes(payload, None, max_len)


def _gather_bytes(payload, group=None, max_len=None):
    """Every member's byte string (in group-rank order)."""
    n = len(payload)
    lens = all_gather_np(np.array([n], np.int32), group=group)[:, 0]
    width = int(lens.max())
    _BYTES_TOTAL.labels(channel="gather").inc(width * len(lens))
    if max_len is not None and width > max_len:
        # raise on ALL ranks (post-gather) so no peer is left blocking
        raise ValueError(f"object too large to gather ({width} > {max_len})")
    buf = np.zeros((width,), np.uint8)
    buf[:n] = np.frombuffer(payload, np.uint8)
    mat = all_gather_np(buf, group=group)
    return [mat[i, : int(lens[i])].tobytes() for i in range(len(lens))]


# ---- point-to-point byte transport ----

_p2p_send_seq = {}
_p2p_recv_seq = {}


def _kv_client():
    store = _env.store()
    if store is None:
        raise RuntimeError(
            "p2p send/recv needs the multi-process runtime: start workers "
            "via paddle_tpu_torch.distributed.launch and call "
            "init_parallel_env (torch.distributed over a TCPStore)")
    return store


# store faults are transient by nature (a restart window, a pod
# re-form); DistStoreError is a RuntimeError. The caller's timeout is
# the real budget: deadline-bounded, attempts are only a runaway cap.
_KV_RETRY = RetryPolicy(max_attempts=8, base_s=0.05, max_backoff_s=1.0,
                        retry_on=(OSError, RuntimeError), name="kv.get")
# A peer that is mid-restart refuses connections for seconds — retry
# until the caller's deadline, not a fixed attempt count.
_CONNECT_RETRY = RetryPolicy(max_attempts=None, base_s=0.1,
                             max_backoff_s=2.0, name="sock.connect")
_SEND_RETRY = RetryPolicy(max_attempts=5, base_s=0.05, max_backoff_s=1.0,
                          name="sock.send")


def _count_retry(op):
    cell = _RETRIES_TOTAL.labels(op=op)

    def note(attempt, exc):
        cell.inc()
    return note


def _kv_get(key, timeout_ms):
    """Blocking store get (wait for the key, then read it),
    chaos-injectable and retried under the caller's deadline."""
    client = _kv_client()
    deadline = time.monotonic() + timeout_ms / 1000.0

    def attempt():
        chaos.fire("kv.get")
        remaining = max(0.001, deadline - time.monotonic())
        client.wait([key], datetime.timedelta(seconds=remaining))
        return client.get(key).decode("utf-8")

    return _KV_RETRY.run(attempt, deadline_s=timeout_ms / 1000.0,
                         name=f"kv.get:{key}",
                         on_retry=_count_retry("kv"))


def _kv_set(key, value):
    """Store set, chaos-injectable and retried."""
    client = _kv_client()

    def attempt():
        chaos.fire("kv.set")
        client.set(key, value)

    _KV_RETRY.run(attempt, deadline_s=30.0, name=f"kv.set:{key}",
                  on_retry=_count_retry("kv"))


def _kv_delete(key):
    """Drop a consumed key (hygiene: bulk transfers must not grow the
    store without bound). A key already gone is fine."""
    try:
        _kv_client().delete_key(key)
    except RuntimeError:
        pass


_HDR = struct.Struct("<iiqq")   # src, tag, seq, payload length


class _SocketTransport:
    """Per-process TCP transport. One listener; lazy one-way connections;
    frames land in an inbox keyed (src, tag, seq) so out-of-order arrival
    from different peers never blocks an unrelated recv."""

    def __init__(self):
        _kv_client()        # no runtime: raise before binding anything
        me = _env.get_rank()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("0.0.0.0", 0))
        self._lsock.listen(64)
        port = self._lsock.getsockname()[1]
        host = os.environ.get("PADDLE_TPU_P2P_HOST") or _local_ip()
        self._inbox = {}
        self._consumed = {}   # (src, tag) -> highest seq popped by recv
        self._cv = threading.Condition()
        self._conns = {}
        self._conn_lock = threading.Lock()   # guards the dict only
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        _kv_set(f"pt_p2p_ep/{me}", f"{host}:{port}")

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn):
        try:
            while True:
                hdr = self._read_exact(conn, _HDR.size)
                if hdr is None:
                    return
                src, tag, seq, ln = _HDR.unpack(hdr)
                data = self._read_exact(conn, ln)
                if data is None:
                    return
                with self._cv:
                    # a send retry can resend a frame the kernel already
                    # delivered; once recv consumed that seq, re-inserting
                    # the duplicate would leak an inbox entry forever
                    # (seqs are monotonic per (src, tag))
                    if seq > self._consumed.get((src, tag), -1):
                        self._inbox[(src, tag, seq)] = data
                        self._cv.notify_all()
        finally:
            conn.close()

    @staticmethod
    def _read_exact(conn, n):
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = conn.recv_into(view[got:], min(1 << 20, n - got))
            if not k:
                return None
            got += k
        return bytes(buf)

    def _conn_to(self, dst, timeout_ms):
        # per-destination slot: the global lock covers only the dict
        # lookup; the blocking endpoint-wait + connect happen under the
        # DESTINATION's lock, so a slow peer never stalls sends to
        # ready peers (and concurrent first-sends to one peer connect
        # exactly once)
        with self._conn_lock:
            slot = self._conns.setdefault(
                dst, {"lock": threading.Lock(), "sock": None})
        with slot["lock"]:
            if slot["sock"] is None:
                # ONE deadline covers the endpoint wait AND the connect
                deadline = time.monotonic() + timeout_ms / 1000.0
                ep = _kv_get(f"pt_p2p_ep/{dst}", timeout_ms)
                host, port = ep.rsplit(":", 1)

                def _connect():
                    # a peer MID-RESTART refuses connections until its
                    # listener is back up — retry under the deadline
                    chaos.fire("sock.connect")
                    s = socket.create_connection(
                        (host, int(port)),
                        timeout=max(1.0, deadline - time.monotonic()))
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                    s.settimeout(None)
                    return s

                slot["sock"] = _CONNECT_RETRY.run(
                    _connect,
                    deadline_s=max(0.001, deadline - time.monotonic()),
                    name=f"sock.connect:{dst}",
                    on_retry=_count_retry("sock.connect"))
        return slot

    def _drop_conn(self, slot):
        """Close a (possibly half-written) connection so the next send
        reconnects. Safe: the peer's reader discards incomplete frames
        at EOF, so a full resend over a fresh connection never corrupts
        the framing (a duplicate complete frame carries identical bytes
        and lands idempotently in the (src, tag, seq) inbox)."""
        with slot["lock"]:
            if slot["sock"] is not None:
                try:
                    slot["sock"].close()
                except OSError:
                    pass
                slot["sock"] = None

    def send(self, data, dst, tag, seq, timeout_ms):
        me = _env.get_rank()
        _BYTES_TOTAL.labels(channel="socket").inc(len(data))
        deadline = time.monotonic() + timeout_ms / 1000.0
        last_slot = {"slot": None}

        def _attempt():
            remaining_ms = max(1, int((deadline - time.monotonic())
                                      * 1000))
            slot = last_slot["slot"] = self._conn_to(dst, remaining_ms)
            chaos.fire("sock.send")         # stall or pre-write drop
            with slot["lock"]:
                sock = slot["sock"]
                if sock is None:
                    # a concurrent sender's _drop_conn beat us here —
                    # retryable: the next attempt reconnects
                    raise OSError("connection dropped concurrently")
                # a wedged peer that stops draining its socket must not
                # block this thread forever — honor the caller's
                # deadline on sends too
                sock.settimeout(max(1.0, deadline - time.monotonic()))
                try:
                    sock.sendall(_HDR.pack(me, tag, seq, len(data)))
                    sock.sendall(data)
                finally:
                    sock.settimeout(None)

        def _on_retry(attempt, exc):        # timeouts are OSError too
            if last_slot["slot"] is not None:
                self._drop_conn(last_slot["slot"])
            _RETRIES_TOTAL.labels(op="sock.send").inc()

        try:
            _SEND_RETRY.run(_attempt, deadline_s=timeout_ms / 1000.0,
                            name=f"sock.send:{dst}", on_retry=_on_retry)
        except RetryError as e:
            raise TimeoutError(
                f"p2p send failed: dst={dst} tag={tag} seq={seq} "
                f"({len(data)} bytes): {e.last!r}") from e

    def recv(self, src, tag, seq, timeout_ms):
        chaos.fire("sock.recv")             # stall injection
        key = (src, tag, seq)
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._inbox,
                                     timeout=timeout_ms / 1000.0):
                raise TimeoutError(
                    f"p2p recv timed out: src={src} tag={tag} seq={seq}")
            ck = (src, tag)
            self._consumed[ck] = max(seq, self._consumed.get(ck, -1))
            return self._inbox.pop(key)


def _local_ip():
    """Reachable address for THIS host: route toward the job's master
    (PADDLE_MASTER — the address every rank provably reaches) and read
    the socket's own name; loopback when the master is local, which
    probes no route at all."""
    master = os.environ.get("PADDLE_MASTER", "").rsplit(":", 1)
    if master and master[0] and master[0] not in ("127.0.0.1",
                                                  "localhost"):
        target = (master[0], int(master[1]) if len(master) > 1
                  and master[1].isdigit() else 80)
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect(target)       # UDP: picks a route, sends nothing
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            pass
    return "127.0.0.1"


_transport = None
_transport_lock = threading.Lock()


def _socket_transport():
    global _transport
    if _transport is None:
        with _transport_lock:
            if _transport is None:
                _transport = _SocketTransport()
    return _transport


def _use_kv_transport():
    return os.environ.get("PADDLE_TPU_P2P_TRANSPORT", "socket") == "kv"


_stats_lock = threading.Lock()


def send_bytes(data: bytes, dst: int, tag: int = 0,
               timeout_ms: int = 600_000):
    me = _env.get_rank()
    with _stats_lock:
        seq = _p2p_send_seq.get((me, dst, tag), 0)
        _p2p_send_seq[(me, dst, tag)] = seq + 1
    _BYTES_TOTAL.labels(channel="p2p").inc(len(data))
    # seq in the span args: the merged timeline pairs this frame with
    # the peer's matching xproc.recv by (src, dst, tag, seq) — the
    # transfer leg of a disaggregated request's causal chain
    with _trace_span("xproc.send", dst=dst, tag=tag, seq=seq,
                     bytes=len(data)):
        if not _use_kv_transport():
            _socket_transport().send(data, dst, tag, seq, timeout_ms)
            return
        payload = base64.b64encode(data).decode("ascii")
        _BYTES_TOTAL.labels(channel="kv_bulk").inc(len(payload))
        _kv_set(f"pt_p2p/{me}/{dst}/{tag}/{seq}", payload)


def recv_bytes(src: int, tag: int = 0, timeout_ms: int = 600_000) -> bytes:
    me = _env.get_rank()
    with _stats_lock:
        seq = _p2p_recv_seq.get((src, me, tag), 0)
        _p2p_recv_seq[(src, me, tag)] = seq + 1
    if not _use_kv_transport():
        with _trace_span("xproc.recv", src=src, tag=tag, seq=seq):
            return _socket_transport().recv(src, tag, seq, timeout_ms)
    key = f"pt_p2p/{src}/{me}/{tag}/{seq}"
    with _trace_span("xproc.recv", src=src, tag=tag, seq=seq):
        val = _kv_get(key, timeout_ms)
    _kv_delete(key)
    return base64.b64decode(val)


def send_np(arr, dst: int, tag: int = 0, timeout_ms: int = 600_000,
            quantize=None):
    """Send one array. quantize=None picks the int8 wire frame for an
    eligible float payload under PT_QUANT_ALLREDUCE=1; quantize=True
    asks for it; quantize=False sends the exact ``np.save`` frame (for
    payloads that must stay bit-exact)."""
    arr = np.ascontiguousarray(arr)
    if quantize is None:
        qrt = _quant_runtime()
        quantize = qrt.quant_allreduce_enabled() and qrt.wire_eligible(arr)
    if quantize:
        payload = _quant_runtime().encode_int8_wire(arr)
        _QUANT_SAVED.inc(max(0, arr.nbytes - len(payload)))
        send_bytes(payload, dst, tag, timeout_ms)
        return
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    send_bytes(buf.getvalue(), dst, tag, timeout_ms)


def recv_np(src: int, tag: int = 0, timeout_ms: int = 600_000):
    raw = recv_bytes(src, tag, timeout_ms)
    if raw[:4] == _QUANT_WIRE_MAGIC:    # a self-describing int8 frame
        return _quant_runtime().decode_int8_wire(raw)
    return np.load(io.BytesIO(raw), allow_pickle=False)
