"""KV-page transfer — the disaggregated-serving wire format (counterpart
of paddle_tpu/inference/fleet_serving/kv_transfer.py).

Prefill/decode disaggregation moves a request's finished KV pages from
the replica that computed them to the replica that will decode from
them. A quantized pool's pages plus their fp32 scale planes ARE the wire
format: the pool is stored pre-quantized, so streaming it byte for byte
ships about 4x (int8) / 7x (int4) fewer bytes than an fp32 KV would,
with no re-encode and no added quantization error — the decode replica
attends over the identical bytes the prefill replica wrote.

The payload is self-describing (`KVPagePayload`): the request's tokens,
how many of them have KV written (`n_prefilled`, the frontier), the
geometry of the pool it was cut from, and one page array per layer pool
(+ one scale-plane array per pool when quantized). `pack_kv_payload` /
`unpack_kv_payload` give the byte form, the reference's frame (magic
``PTKV``, version 1, meta json, one ``np.save`` blob per array), so a
frame packed by either package unpacks in the other with byte-equal
arrays. numpy has no bfloat16: a bf16 pool travels as its 2-byte words,
a ``uint16`` carrier with ``"bfloat16"`` in the frame's ``pool_dtypes``
(the reference holds an ``ml_dtypes.bfloat16`` array there; both write
the same bytes).

The cross-process stream (`send_kv_payload` / `recv_kv_payload`) rides
the xproc p2p socket transport (distributed/xproc.py): the frame goes
byte for byte, resent whole on a dropped connection, under the
``sock.*`` chaos scopes. In one process the router hands the payload
object from replica to replica.

Engine surface: `LLMEngine.export_kv_pages(req)` cuts a payload,
`LLMEngine.import_kv_pages(payload, ...)` admits it at its frontier
(inference/llm_engine.py).
"""
import io
import json
import struct

import numpy as np

from ...observability import metrics as _obs

__all__ = ["KVPagePayload", "pack_kv_payload", "unpack_kv_payload",
           "send_kv_payload", "recv_kv_payload", "KV_STREAM_TAG"]

# default p2p tag of the disaggregated KV stream (the reference's)
KV_STREAM_TAG = 0x4B56  # "KV"

_KV_PAGES_STREAMED = _obs.counter(
    "pt_disagg_kv_pages_streamed",
    "KV pages imported into a decode replica's pool from a prefill "
    "replica's export (disaggregated serving)")

_MAGIC = b"PTKV"
_VERSION = 1
_HDR = struct.Struct("<4sBI")


class KVPagePayload:
    """One request's exported KV pages (module docstring). Fields:

    tokens       np.int32 [n] — the request's tokens (prompt so far)
    n_prefilled  tokens whose KV rows the pages hold (the frontier —
                 the last page may be partially filled; rows past the
                 frontier are whatever bytes the pool held and are
                 masked by kv_len on the decode side)
    page_size    tokens per page of the source pool
    kv_dtype     source pool dtype label ("float32" / "bfloat16" /
                 "int8" / "int4"; import requires an exact match)
    kv           one np array [num_pages, page_size, H, D'] per layer
                 pool (2 x num_layers, in pool order), byte for byte as
                 stored; a bf16 pool as uint16 words
    scales       the fp32 scale planes [num_pages, page_size, H] per
                 pool for quantized kv_dtypes, else []
    trace        the request's TraceContext wire dict (observability.
                 reqtrace) or None — rides the frame header
    """

    def __init__(self, tokens, n_prefilled, page_size, kv_dtype, kv,
                 scales, trace=None):
        # np.array: the payload outlives the call — an aliased token
        # buffer the scheduler then extends would ship the wrong prefix
        self.tokens = np.array(tokens, np.int32).reshape(-1)
        self.n_prefilled = int(n_prefilled)
        self.page_size = int(page_size)
        self.kv_dtype = str(kv_dtype)
        self.kv = list(kv)
        self.scales = list(scales)
        self.trace = trace          # wire dict (json-able)
        self.trace_ctx = None       # restored TraceContext

    @property
    def num_pages(self):
        return int(self.kv[0].shape[0]) if self.kv else 0

    def nbytes(self):
        return int(sum(a.nbytes for a in self.kv)
                   + sum(a.nbytes for a in self.scales))


def _np_dtype(name):
    """The numpy dtype a frame's pool dtype name unpacks to: bfloat16
    to its uint16 carrier (never ml_dtypes, which the port does not
    use), every other name as numpy spells it."""
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _pool_dtype_name(payload, a):
    """The frame's name of one pool array's dtype: a bf16 pool's uint16
    carrier is written as "bfloat16", the reference's name."""
    if payload.kv_dtype == "bfloat16" and a.dtype == np.uint16:
        return "bfloat16"
    return str(a.dtype)


def pack_kv_payload(payload):
    """KVPagePayload -> bytes (the reference's frame)."""
    meta = json.dumps({
        "n_prefilled": payload.n_prefilled,
        "page_size": payload.page_size,
        "kv_dtype": payload.kv_dtype,
        "n_kv": len(payload.kv),
        "n_scales": len(payload.scales),
        "pool_dtypes": [_pool_dtype_name(payload, a) for a in payload.kv],
        "trace": payload.trace,
    }).encode("utf-8")
    buf = io.BytesIO()
    buf.write(_HDR.pack(_MAGIC, _VERSION, len(meta)))
    buf.write(meta)
    np.save(buf, payload.tokens, allow_pickle=False)
    for a in payload.kv:
        np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    for a in payload.scales:
        np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return buf.getvalue()


def unpack_kv_payload(raw):
    """bytes -> KVPagePayload with byte-equal arrays. A bf16 array of a
    frame the reference packed (numpy reads its dtype back as 2-byte
    void) comes back as its uint16 carrier."""
    magic, ver, meta_len = _HDR.unpack_from(raw, 0)
    if magic != _MAGIC:
        raise ValueError(
            f"not a KV-page frame (magic {magic!r}): the KV stream and "
            "other p2p traffic must not share a tag")
    if ver != _VERSION:
        raise ValueError(f"KV-page frame version {ver} != {_VERSION}")
    meta = json.loads(raw[_HDR.size:_HDR.size + meta_len].decode("utf-8"))
    buf = io.BytesIO(raw)
    buf.seek(_HDR.size + meta_len)
    tokens = np.load(buf, allow_pickle=False)
    kv = []
    for name in meta["pool_dtypes"]:
        a = np.load(buf, allow_pickle=False)
        want = _np_dtype(name)
        kv.append(a if a.dtype == want else a.view(want))
    scales = [np.load(buf, allow_pickle=False)
              for _ in range(meta["n_scales"])]
    return KVPagePayload(tokens, meta["n_prefilled"], meta["page_size"],
                         meta["kv_dtype"], kv, scales,
                         trace=meta.get("trace"))


def send_kv_payload(payload, dst, tag=KV_STREAM_TAG, timeout_ms=600_000):
    """Stream one payload to rank `dst` over the xproc p2p transport.
    Byte-for-byte: the frame is already pool-quantized, so it must NOT
    ride the int8 float re-encoder (`send_bytes`, not `send_np`) —
    re-quantizing quantized codes would corrupt them. The payload's
    trace rides the frame header AND the `xproc.send` span (ambient),
    so the transfer leg shows under the request's trace_id on both
    sides of the merged timeline."""
    from ...distributed import xproc
    from ...observability import reqtrace, tracing

    ctx = (reqtrace.TraceContext.from_dict(payload.trace)
           if payload.trace else None)
    with tracing.ambient_trace(ctx):
        xproc.send_bytes(pack_kv_payload(payload), dst, tag=tag,
                         timeout_ms=timeout_ms)


def recv_kv_payload(src, tag=KV_STREAM_TAG, timeout_ms=600_000):
    """Receive one payload from rank `src`; a payload with a trace gets
    the transfer's end stamped on it (``kv_transfer``) on this rank —
    wall clocks align the cross-process chain."""
    from ...distributed import xproc
    from ...observability import reqtrace

    payload = unpack_kv_payload(xproc.recv_bytes(src, tag=tag,
                                                 timeout_ms=timeout_ms))
    if payload.trace:
        ctx = reqtrace.TraceContext.from_dict(payload.trace)
        ctx.stamp("kv_transfer")
        payload.trace = ctx.to_dict()
        payload.trace_ctx = ctx
    return payload
