"""Sequence (context) parallelism over the ``sp`` mesh axis: ring
attention and Ulysses attention (counterpart of
paddle_tpu/distributed/sequence_parallel.py).

The reference writes both as jax functions that run inside an SPMD
program (shard_map over 'sp'), its ring step a `lax.ppermute`. The port
runs one process per sp rank. Each holds its [batch, seq_local, heads,
head_dim] shard of q, k and v, and the ring step is a point-to-point
shift over the port's socket transport: `xproc.send_bytes` to the next
rank of the sp group, `recv_bytes` from the previous one. A send lands
in the peer's inbox and never blocks; each (src, dst, tag) channel is
FIFO. The K/V pair of one step travels as one frame, bit-exact (bf16 as
its 16-bit words).

- `ring_flash_attention` runs the flash kernels on each resident K/V
  block through the lse route, the two calls `_FlashAttentionLseBHD`
  makes: K3 (`flash_forward`, out and lse) forward; K4 + K5
  (`flash_attention._attn_bwd`) backward, the block's lse cotangent
  entering as delta − g_lse. Causal: the diagonal block (src == idx)
  runs causal, a block below it (src < idx) full, and a block above it
  is skipped (no kernel). The blocks merge by lse in f32, the running
  max starting at the finite floor −1e30 (the reference's note: an −inf
  floor turns a skipped block into NaN).
- `ring_attention` is the dense f32 version (f32 scores, the
  reference's online-softmax merge): the CPU path, and the plain
  reference of the flash ring on the card. A block wholly above the
  causal diagonal is skipped; the reference masks it to −1e30, which
  merges as an exact no-op.
- `ulysses_attention` turns the sequence shard into a head shard with
  an all-to-all over sp (gloo through the host; its gradient is the
  inverse all-to-all), runs dense attention over the whole sequence,
  and brings the result back with the inverse all-to-all.

Each ring is one autograd node with a hand-written backward. It takes
the block gradients of each step from the blocks the forward kept, and
the dK / dV accumulators travel the ring in reverse, the transpose of
the forward's shifts. So every rank sends and receives the same
messages, whatever blocks it skipped. A recompute (of a pipeline stage
or a layer) runs the forward again, sends included, as `jax.checkpoint`
replays `ppermute`. Each message carries a tag unique per (layer,
micro-batch, ring step, forward / recompute / backward), taken from
`ring_scope`; the pipelined GPT and the pipeline schedules set it.

`stats` counts the ring's messages ("ring_p2p": calls, bytes and
seconds; a receive's seconds include its wait for the peer) and its
forward blocks by kind ("causal", "full", "skipped"). The Ulysses
all-to-all counts in `mp_ops.stats` under "ulysses_a2a".
"""
import contextlib
import json
import math
import struct
import time

import torch

__all__ = ["ring_attention", "ring_flash_attention", "ulysses_attention",
           "RingAttention", "ring_scope", "stats"]

NEG_FLOOR = -1e30
# ring frames take tags above the pipeline's handoff tags (7101 / 7102)
_TAG0 = 1 << 24
_PHASES = {"forward": 0, "recompute": 1, "backward": 2}
_scope = {"layer": 0, "micro": 0, "phase": 0}

stats = {}


@contextlib.contextmanager
def ring_scope(layer=None, micro=None, phase=None):
    """Name the ring calls made inside: the decoder layer, the
    micro-batch, and "forward" or "recompute" (a backward is named by its
    forward's scope)."""
    old = dict(_scope)
    if layer is not None:
        _scope["layer"] = int(layer)
    if micro is not None:
        _scope["micro"] = int(micro)
    if phase is not None:
        _scope["phase"] = _PHASES[phase]
    try:
        yield
    finally:
        _scope.update(old)


def _tag(scope, phase, step):
    return _TAG0 + ((((scope["micro"] % 4096) * 256 + scope["layer"] % 256)
                     * 3 + phase) * 64 + step % 64)


def _note(kind, n=1, nbytes=0, seconds=0.0):
    d = stats.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    d["calls"] += n
    d["bytes"] += int(nbytes)
    d["seconds"] += seconds


def _ring(axis_name):
    """(sp size, this rank's index, next rank, previous rank) of the ring
    over `axis_name`; (1, 0, None, None) in one process."""
    from . import env, xproc
    from . import mesh as mesh_mod

    sp = mesh_mod.axis_size(axis_name)
    if sp == 1 or not xproc.is_multiprocess():
        return 1, 0, None, None
    rank = env.get_rank()
    members = mesh_mod.global_mesh().group_ranks((axis_name,), rank)
    idx = members.index(rank)
    return sp, idx, members[(idx + 1) % sp], members[(idx - 1) % sp]


def _shift(ts, dst, src, tag):
    """Send the tensors `ts` to rank `dst` as one frame and receive the
    frame rank `src` sent under the same tag."""
    from . import xproc

    t0 = time.perf_counter()
    heads, bodies = [], []
    for t in ts:
        h = t.detach().contiguous().cpu()
        heads.append({"dtype": str(h.dtype).split(".")[-1],
                      "shape": list(h.shape)})
        w = h.view(torch.int16) if h.dtype == torch.bfloat16 else h
        bodies.append(w.numpy().tobytes())
    head = json.dumps(heads).encode()
    xproc.send_bytes(struct.pack("<I", len(head)) + head + b"".join(bodies),
                     dst, tag)
    raw = xproc.recv_bytes(src, tag)
    n = struct.unpack("<I", raw[:4])[0]
    off = 4 + n
    out = []
    for h in json.loads(raw[4:off]):
        dtype = getattr(torch, h["dtype"])
        store = torch.int16 if dtype == torch.bfloat16 else dtype
        size = math.prod(h["shape"]) * torch.empty(
            (), dtype=store).element_size()
        t = torch.frombuffer(bytearray(raw[off:off + size]), dtype=store)
        off += size
        t = t.reshape(h["shape"])
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        out.append(t.to(ts[0].device))
    _note("ring_p2p", 1, sum(len(b) for b in bodies),
          time.perf_counter() - t0)
    return out


def _mode(causal, src, idx):
    if not causal:
        return "full"
    return "causal" if src == idx else ("full" if src < idx else "skipped")


def _to_bhd(t):
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhd(t, b, h):
    bh, s, d = t.shape
    return t.reshape(b, h, s, d).transpose(1, 2)


def _f32(shape, device, fill=0.0):
    return torch.full(shape, fill, dtype=torch.float32, device=device)


class _FlashBlocks:
    """The flash ring's blocks: K3 per block, merged by lse in f32;
    backward K4 + K5 per block with the block's lse cotangent."""

    @staticmethod
    def start(q):
        # the running lse max, the weighted outputs, their weights
        return (_f32(q.shape[:2], q.device, NEG_FLOOR), _f32(q.shape,
                q.device), _f32(q.shape[:2], q.device))

    @staticmethod
    def merge(q, kb, vb, mode, state):
        from ..ops.cuda_kernels import flash_attention as fa

        m, num, den = state
        o, lse = fa.flash_forward(q, kb, vb, mode == "causal")
        l = lse[:, 0, :]
        m_new = torch.maximum(m, l)
        s_old, s_blk = torch.exp(m - m_new), torch.exp(l - m_new)
        return ((m_new, num * s_old[..., None] + o.float() * s_blk[..., None],
                 den * s_old + s_blk), (o, lse))

    @staticmethod
    def finish(state):
        m, num, den = state
        den = torch.clamp(den, min=1e-30)
        return num / den[..., None], (m, den)

    @staticmethod
    def grads(q, kb, vb, mode, saved, g, out, final):
        from ..ops.cuda_kernels.flash_attention import _attn_bwd

        (o, lse), (m, den) = saved, final
        # out = Σ_b w_b·o_b with w_b = exp(lse_b − m) / den: the block's
        # cotangents are g·w_b on o_b and w_b·Σ_d g·(o_b − out) on lse_b
        w = torch.exp(lse[:, 0, :] - m) / den
        g_o = (g * w[..., None]).to(q.dtype)
        g_lse = (w * (g * (o.float() - out)).sum(-1))[:, None, :]
        return _attn_bwd(q, kb, vb, o, lse, g_o, mode == "causal",
                         g_lse=g_lse)


class _DenseBlocks:
    """The dense ring's blocks: f32 scores, the online-softmax merge;
    backward from the global lse and the output."""

    @staticmethod
    def _scores(q, kb, mode):
        sc = torch.matmul(q, kb.transpose(1, 2)).float() * (
            1.0 / math.sqrt(q.shape[-1]))
        if mode == "causal":
            sc = torch.where(_tril(q.shape[1], q.device), sc, NEG_FLOOR)
        return sc

    @staticmethod
    def start(q):
        # the weighted values, the running max, the running sum of exp
        return (_f32(q.shape, q.device), _f32(q.shape[:2], q.device,
                NEG_FLOOR), _f32(q.shape[:2], q.device))

    @staticmethod
    def merge(q, kb, vb, mode, state):
        acc, m, l = state
        sc = _DenseBlocks._scores(q, kb, mode)
        new_m = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(sc - new_m[..., None])
        return ((acc * corr[..., None] + torch.matmul(p, vb.float()), new_m,
                 l * corr + p.sum(dim=-1)), None)

    @staticmethod
    def finish(state):
        acc, m, l = state
        l = torch.clamp(l, min=1e-30)
        return acc / l[..., None], m + torch.log(l)

    @staticmethod
    def grads(q, kb, vb, mode, saved, g, out, lse):
        # masked scores sit at the -1e30 floor: their p is exactly 0
        p = torch.exp(_DenseBlocks._scores(q, kb, mode) - lse[..., None])
        vf, kf = vb.float(), kb.float()
        ds = p * (torch.matmul(g, vf.transpose(1, 2))
                  - (g * out).sum(-1, keepdim=True))
        scale = 1.0 / math.sqrt(q.shape[-1])
        return (torch.matmul(ds, kf) * scale,
                torch.matmul(ds.transpose(1, 2), q.float()) * scale,
                torch.matmul(p.transpose(1, 2), g))


class _Ring(torch.autograd.Function):
    """One ring over [bh, s_loc, d] shards (module docstring); `blocks`
    is `_FlashBlocks` or `_DenseBlocks`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, ring, scope, blocks):
        sp, idx, nxt, prv = ring
        state = blocks.start(q)
        kept = []
        kb, vb = k, v
        for r in range(sp):
            mode = _mode(causal, (idx - r) % sp, idx)
            _note(mode)
            saved = None
            if mode != "skipped":
                state, saved = blocks.merge(q, kb, vb, mode, state)
            kept.append((mode, kb, vb, saved))
            if r != sp - 1:
                kb, vb = _shift([kb, vb], nxt, prv,
                                _tag(scope, scope["phase"], r))
        out, final = blocks.finish(state)
        ctx.state = (q, kept, out, final, ring, scope, blocks, k.dtype,
                     v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, kept, out, final, ring, scope, blocks, kdt, vdt = ctx.state
        ctx.state = None
        sp, idx, nxt, prv = ring
        g = g.float()
        dq = _f32(q.shape, q.device)
        acc = None
        for r in reversed(range(sp)):
            mode, kb, vb, saved = kept[r]
            if mode == "skipped":
                dk, dv = _f32(kb.shape, kb.device), _f32(vb.shape, vb.device)
            else:
                dq_b, dk, dv = blocks.grads(q, kb, vb, mode, saved, g, out,
                                            final)
                dq = dq + dq_b.float()
                dk, dv = dk.float(), dv.float()
            acc = [dk, dv] if acc is None else [acc[0] + dk, acc[1] + dv]
            if r > 0:
                # the block held at step r moves to the previous rank at
                # step r − 1: its accumulators follow it back
                acc = _shift(acc, prv, nxt, _tag(scope, 2, r))
        return (dq.to(q.dtype), acc[0].to(kdt), acc[1].to(vdt), None, None,
                None, None)


def _tril(s, device):
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def _run_ring(blocks, q, k, v, causal, axis_name):
    b, _, h, _ = q.shape
    out = _Ring.apply(_to_bhd(q), _to_bhd(k), _to_bhd(v), bool(causal),
                      _ring(axis_name), dict(_scope), blocks)
    return _from_bhd(out, b, h)


def ring_attention(q, k, v, causal=False, axis_name="sp"):
    """Attention over a sequence sharded along `axis_name`: dense f32
    scores per K/V block, merged by the online softmax.

    q, k, v: [batch, seq_local, heads, head_dim] (this rank's shard).
    Returns [batch, seq_local, heads, head_dim] in q's dtype."""
    return _run_ring(_DenseBlocks, q, k, v, causal, axis_name)


def ring_flash_attention(q, k, v, causal=False, axis_name="sp",
                         block_q=None, block_k=None, interpret=False):
    """Ring attention with the flash kernels K3-K5 on each K/V block and
    the blocks merged by lse; causal blocks above the diagonal skipped.
    The same contract as `ring_attention`. `block_q` / `block_k` /
    `interpret` are the reference's Pallas knobs, taken for its
    signature: the Hopper kernels choose their tile from head_dim, and a
    CPU tensor runs the kernels' plain versions."""
    return _run_ring(_FlashBlocks, q, k, v, causal, axis_name)


class _AllToAll(torch.autograd.Function):
    """x [n, ...] over the group of n along `axis`: chunk j to the member
    at position j (mp_ops.all_to_all_mp_raw); its own adjoint."""

    @staticmethod
    def forward(ctx, x, axis):
        from .fleet.meta_parallel import mp_ops

        ctx.axis = axis
        return mp_ops.all_to_all_mp_raw(x.contiguous(), axis,
                                        kind="ulysses_a2a")

    @staticmethod
    def backward(ctx, g):
        from .fleet.meta_parallel import mp_ops

        return mp_ops.all_to_all_mp_raw(g.contiguous(), ctx.axis,
                                        kind="ulysses_a2a"), None


def _seq2head(x, sp, axis):
    """[b, s_loc, h, d] → [b, s_loc·sp, h/sp, d]: heads split across the
    group, sequence blocks gathered in rank order."""
    b, s, h, d = x.shape
    parts = x.reshape(b, s, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(parts, axis)          # [sp (source), b, s, h/sp, d]
    return got.permute(1, 0, 2, 3, 4).reshape(b, sp * s, h // sp, d)


def _head2seq(x, sp, axis):
    """[b, s_loc·sp, h/sp, d] → [b, s_loc, h, d]: the inverse."""
    b, S, hl, d = x.shape
    parts = x.reshape(b, sp, S // sp, hl, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(parts, axis)          # [sp (source), b, s, h/sp, d]
    return got.permute(1, 2, 0, 3, 4).reshape(b, S // sp, sp * hl, d)


def ulysses_attention(q, k, v, causal=False, axis_name="sp"):
    """DeepSpeed-Ulysses: an all-to-all so each rank holds the whole
    sequence for heads/sp heads, dense attention, then the inverse
    all-to-all. Requires heads % sp == 0."""
    sp = _ring(axis_name)[0]
    b, s_loc, h, d = q.shape
    if h % sp != 0:
        raise ValueError(f"heads {h} not divisible by sp degree {sp}")
    if sp > 1:
        qg, kg, vg = (_seq2head(t, sp, axis_name) for t in (q, k, v))
    else:
        qg, kg, vg = q, k, v
    s_full = qg.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qg, kg).float() * scale
    if causal:
        scores = torch.where(_tril(s_full, q.device), scores, NEG_FLOOR)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(vg.dtype), vg)
    return _head2seq(out, sp, axis_name) if sp > 1 else out


class RingAttention:
    """Selects ring, ring-flash or Ulysses attention (the API surface for
    model code; call it on this rank's sequence shard)."""

    def __init__(self, mode="ring", causal=True, axis_name="sp"):
        self.mode = mode
        self.causal = causal
        self.axis_name = axis_name

    def __call__(self, q, k, v):
        fn = {"ring": ring_attention,
              "ring_flash": ring_flash_attention,
              "ulysses": ulysses_attention}[self.mode]
        return fn(q, k, v, causal=self.causal, axis_name=self.axis_name)
