"""Mixture-of-Experts with expert parallelism (counterpart of
paddle_tpu/distributed/moe.py).

The reference has two formulations, and the port keeps both:

* `MoELayer`: the experts are one stacked weight per array, recorded as
  split over the ``ep`` mesh axis, and every rank routes the whole token
  set (the reference leaves the expert split to GSPMD, so its math is
  the whole layer on every rank). The port's layer holds the whole stack
  on every rank and computes the same thing.
* `moe_a2a_dispatch_combine`: expert parallelism with a token exchange.
  Each ``ep`` rank takes a 1/ep slice of the tokens, capacity-buckets
  them locally (GShard's grouped capacity, C = ceil(t_loc·cf/E) per
  group), exchanges the buckets with an all-to-all (`ep_all_to_all`),
  runs only its E/ep resident experts, exchanges the outputs back and
  all-gathers the combined tokens. The gate statistics of the
  load-balancing aux term are all-reduced over every token-sharding axis
  (`stat_axes`), so the aux is the whole batch's value on every rank.

The routing has one home, `_route`: argmax gating (the first maximal
index), positions from an f32 cumsum of the one-hot, a token kept when
its position is below the capacity. `switch_dispatch` and
`topk_pack_dispatch` build the reference's one-hot dispatch and combine
tensors from it; the layers move the tokens by index instead (a gather
into the expert buckets, a gather back), which keeps the same tokens in
the same slots without the [E, t, C] products. The expert products are
batched matmuls over the stacked experts, as the reference's einsums.

The three exchanges are `torch.autograd.Function`s with the reference's
custom VJPs: `ep_scatter_tokens` (this rank's t/ep chunk; backward a
tiled all-gather), `ep_gather_tokens` (a tiled all-gather; backward this
rank's chunk) and `ep_all_to_all` (self-adjoint). They run over this
rank's ``ep`` gloo group through host memory, as the port's other
collectives do, and count their calls, bytes and seconds in
`fleet.meta_parallel.mp_ops.stats` ("alltoall", "ep_allgather").

`route_stats`: set it to a dict to count the routing of the passes that
follow (each `_route` call: "tokens" kept per expert, "routed", "dropped";
this rank's tokens only), None (the default) to count nothing. Run a
no-grad pass for the counts: a recomputing backward routes again.
"""
import math

import torch
from torch import nn

from .. import amp
from ..core.dtype import resolve_dtype
from ..core.place import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.layers import Layer
from .fleet.meta_parallel import mp_ops

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate",
           "moe_dispatch_combine", "moe_a2a_dispatch_combine",
           "ep_scatter_tokens", "ep_gather_tokens", "ep_all_to_all",
           "moe_a2a_capacity", "switch_dispatch", "topk_rounds",
           "topk_pack_dispatch"]


# ---- the token exchange over "ep" ----

def _ep_group(ep, axis):
    members, pos, _ = mp_ops.mp_world(axis)
    if len(members) != ep:
        raise ValueError(
            f"ep={ep} but this rank's {axis!r} group has {len(members)} "
            "members: the token exchange runs one process per ep rank")
    return pos


class _EpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ep, axis):
        ctx.axis = axis
        pos = _ep_group(ep, axis)
        t_loc = x.shape[0] // ep
        return x[pos * t_loc:(pos + 1) * t_loc].clone()

    @staticmethod
    def backward(ctx, g):
        return mp_ops.all_gather_mp_raw(g.contiguous(), ctx.axis, dim=0,
                                        kind="ep_allgather"), None, None


class _EpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_loc, axis):
        ctx.axis, ctx.t_loc = axis, x_loc.shape[0]
        return mp_ops.all_gather_mp_raw(x_loc.contiguous(), axis, dim=0,
                                        kind="ep_allgather")

    @staticmethod
    def backward(ctx, g):
        pos = mp_ops.mp_world(ctx.axis)[1]
        return g[pos * ctx.t_loc:(pos + 1) * ctx.t_loc].clone(), None


class _EpAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return mp_ops.all_to_all_mp_raw(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return mp_ops.all_to_all_mp_raw(g.contiguous(), ctx.axis), None


def ep_scatter_tokens(x, ep, axis="ep"):
    """This rank's t/ep chunk of a replicated [t, ...] batch; backward
    all-gathers the chunks' cotangents (the input's cotangent is
    replicated again)."""
    if ep == 1:
        return x
    return _EpScatter.apply(x, ep, axis)


def ep_gather_tokens(x_loc, axis="ep"):
    """The ranks' [t/ep, ...] chunks all-gathered into the replicated
    [t, ...] batch; backward keeps this rank's chunk of the cotangent."""
    if len(mp_ops.mp_world(axis)[0]) == 1:
        return x_loc
    return _EpGather.apply(x_loc, axis)


def ep_all_to_all(x, axis="ep"):
    """All-to-all over the leading [ep, ...] dim: rank r's chunk j lands
    in rank j's slot r. Self-adjoint: the backward is the same exchange."""
    if len(mp_ops.mp_world(axis)[0]) == 1:
        return x
    return _EpAllToAll.apply(x, axis)


# ---- routing ----

route_stats = None


def _count(top_idx, keep, num_experts):
    kept = torch.bincount(top_idx[keep], minlength=num_experts).tolist()
    tokens = route_stats.setdefault("tokens", [0] * num_experts)
    route_stats["tokens"] = [a + b for a, b in zip(tokens, kept)]
    route_stats["routed"] = route_stats.get("routed", 0) + int(
        top_idx.numel())
    route_stats["dropped"] = route_stats.get("dropped", 0) + int(
        top_idx.numel() - sum(kept))


def _route(probs, num_experts, capacity):
    """Top-1 routing of `probs` [t, E]: (expert [t], its probability
    [t], one-hot [t, E] f32, position in the expert's bucket [t], kept
    [t]). The one home of the capacity and keep logic."""
    top_idx = probs.argmax(-1)
    top_p = probs.gather(-1, top_idx[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(top_idx, num_experts).float()
    pos = (onehot.cumsum(0) - 1.0) * onehot
    pos_idx = pos.sum(-1).to(torch.int64)
    keep = pos_idx < capacity
    if route_stats is not None:
        _count(top_idx, keep, num_experts)
    return top_idx, top_p, onehot, pos_idx, keep


def switch_dispatch(probs, num_experts, capacity, dtype):
    """The top-1 (switch) dispatch: (disp [E, t, C] one-hot in `dtype`,
    top_p [t], onehot [t, E]). For top-k, call it per round on probs with
    the earlier winners zeroed (`topk_rounds`)."""
    top_idx, top_p, onehot, pos_idx, keep = _route(probs, num_experts,
                                                   capacity)
    t = probs.shape[0]
    disp = torch.zeros((num_experts, t, capacity), dtype=dtype,
                       device=probs.device)
    tok = keep.nonzero()[:, 0]
    disp[top_idx[tok], tok, pos_idx[tok]] = 1
    return disp, top_p, onehot


def topk_rounds(probs, topk):
    """The per-round routing probabilities of top-k gating: round k sees
    probs with rounds < k's winners zeroed (no renormalisation)."""
    work = probs
    for _ in range(topk):
        yield work
        top_idx = work.argmax(-1)
        work = work * (1.0 - torch.nn.functional.one_hot(
            top_idx, work.shape[-1]).to(work.dtype))


def moe_a2a_capacity(tokens, ep, num_experts, capacity_factor):
    """Per-group (per-ep-rank) expert capacity: ceil(t_loc·cf/E), at
    least 1."""
    t_loc = tokens // ep
    return max(1, int(math.ceil(t_loc * capacity_factor / num_experts)))


def _pack(probs, num_experts, capacity, topk, stat_reduce=None):
    """k switch rounds packed along the capacity dim: ([(slot of each
    token in the [E, k·C] buckets, -1 when dropped; its gate probability)
    per round], aux). The aux is E·Σ mean_prob·frac_tokens summed over
    the rounds, its statistics through `stat_reduce` when given."""
    me = probs.mean(0)
    if stat_reduce is not None:
        me = stat_reduce(me)
    rounds = []
    aux = torch.zeros((), dtype=torch.float32, device=probs.device)
    kc = topk * capacity
    for r, round_probs in enumerate(topk_rounds(probs, topk)):
        top_idx, top_p, onehot, pos_idx, keep = _route(
            round_probs, num_experts, capacity)
        ce = onehot.mean(0)
        if stat_reduce is not None:
            ce = stat_reduce(ce)
        aux = aux + num_experts * (me * ce).sum()
        slot = torch.where(keep, top_idx * kc + r * capacity + pos_idx,
                           torch.full_like(pos_idx, -1))
        rounds.append((slot, top_p))
    return rounds, aux


def topk_pack_dispatch(probs, num_experts, capacity, dtype, topk,
                       stat_reduce=None):
    """The reference's packed top-k routing as dense tensors: (disp [E,
    t, k·C], comb [E, t, k·C] — each round's gate probability folded in,
    cast to `dtype` — and aux)."""
    rounds, aux = _pack(probs, num_experts, capacity, topk, stat_reduce)
    t = probs.shape[0]
    kc = topk * capacity
    disp = torch.zeros((num_experts * kc, t), dtype=dtype,
                       device=probs.device)
    comb = torch.zeros_like(disp)
    for slot, top_p in rounds:
        tok = (slot >= 0).nonzero()[:, 0]
        disp[slot[tok], tok] = 1
        comb[slot[tok], tok] = top_p[tok].to(dtype)
    shape = (num_experts, kc, t)
    return (disp.view(shape).transpose(1, 2), comb.view(shape).transpose(
        1, 2), aux)


def _buckets(x, slots, n_slots):
    """The [n_slots, d] expert buckets: row s holds the token whose slot
    is s (rounds' slots do not collide), zeros where none."""
    t, d = x.shape
    src = torch.full((n_slots + 1,), t, dtype=torch.int64, device=x.device)
    tok = torch.arange(t, device=x.device)
    for slot in slots:
        src[torch.where(slot >= 0, slot, n_slots)] = tok
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    return x_pad.index_select(0, src[:n_slots])


def _unbucket(y, slot):
    """Each token's row of the [n_slots, d] bucket outputs at `slot`
    (zeros for a dropped token)."""
    n, d = y.shape
    y_pad = torch.cat([y, y.new_zeros((1, d))])
    return y_pad.index_select(0, torch.where(slot >= 0, slot, n))


def _probs(logits):
    return torch.softmax(logits.float(), -1)


def moe_dispatch_combine(x, gate_logits, expert_fn, num_experts,
                         capacity_factor=1.25, topk=1, axis_name=None):
    """Switch / top-k routing of x [tokens, d] by gate_logits [tokens, E]:
    expert_fn maps the stacked buckets [E, k·C, d] to the experts'
    outputs. Returns (out [tokens, d], aux). The capacity is
    ceil(tokens·cf/E) per round (cf not multiplied by k, as the
    reference's). `axis_name`: a mesh axis the gate statistics average
    over."""
    tokens, d = x.shape
    probs = _probs(gate_logits)
    capacity = moe_a2a_capacity(tokens, 1, num_experts, capacity_factor)
    stat_reduce = None
    if axis_name is not None:
        n = len(mp_ops.mp_world(axis_name)[0])
        stat_reduce = (lambda v: mp_ops.allreduce_mp(v, axis_name) / n)
    rounds, aux = _pack(probs, num_experts, capacity, topk, stat_reduce)
    n_slots = num_experts * topk * capacity
    expert_in = _buckets(x, [s for s, _ in rounds], n_slots)
    expert_out = expert_fn(expert_in.view(num_experts, topk * capacity, d))
    y = expert_out.reshape(n_slots, -1)
    out = None
    for slot, top_p in rounds:
        o = _unbucket(y, slot) * top_p[:, None].to(y.dtype)
        out = o if out is None else out + o
    return out, aux


def moe_a2a_dispatch_combine(x, gate_w, expert_fn, num_experts, ep,
                             capacity_factor=1.25, axis="ep",
                             stat_axes=None, n_stat_shards=None,
                             topk=1):
    """Token-sharded top-k routing with the all-to-all exchange. `x`
    [tokens, d] is replicated over `axis`, `gate_w` [d, E] too;
    `expert_fn` maps [E/ep, ep·C, d] (this rank's resident experts'
    buckets from every rank) to their outputs with this rank's expert
    shards. Each round runs dispatch → all-to-all → experts → all-to-all
    → combine; the rounds' outputs add, each weighted by its gate
    probability. Returns (out [tokens, d] replicated, aux). The capacity
    is per group (this rank's t/ep tokens), C = ceil(t_loc·cf·k/E).

    stat_axes / n_stat_shards: the mesh axes the gate statistics are
    all-reduced over and the number of token shards they span (default
    (axis,) and ep), so the aux is the global batch's value."""
    t, d = x.shape
    if t % ep:
        raise ValueError(
            f"token count {t} not divisible by ep={ep}; pick "
            "batch/micro/sequence sharding so each ep group is equal")
    if num_experts % ep:
        raise ValueError(
            f"num_experts={num_experts} not divisible by ep={ep}")
    e_loc = num_experts // ep
    C = moe_a2a_capacity(t, ep, num_experts, capacity_factor * topk)
    x_loc = ep_scatter_tokens(x, ep, axis)
    # each rank routes a different token slice, so the replicated gate
    # weight gathers partial gradients: copy_to_mp sums them backward
    xl, gw = amp.cast_inputs_for("matmul", (x_loc, mp_ops.copy_to_mp(
        gate_w, axis)))
    probs = _probs(xl @ gw)
    s_axes = tuple(stat_axes) if stat_axes else (axis,)
    n_sh = n_stat_shards if n_stat_shards is not None else ep
    # the slices partition the tokens, so the global mean is the sum of
    # the ranks' means / n; allreduce_mp's identity backward gives each
    # rank the cotangent of its own probabilities
    me = mp_ops.allreduce_mp(probs.mean(0), s_axes) / n_sh
    out_loc = torch.zeros_like(x_loc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for round_probs in topk_rounds(probs, topk):
        top_idx, top_p, onehot, pos_idx, keep = _route(
            round_probs, num_experts, C)
        ce = mp_ops.allreduce_mp(onehot.mean(0), s_axes) / n_sh
        aux = aux + num_experts * (me * ce).sum()
        slot = torch.where(keep, top_idx * C + pos_idx,
                           torch.full_like(pos_idx, -1))
        send = _buckets(x_loc, [slot], num_experts * C)
        # experts grouped by owner (contiguous E/ep blocks, the ep split
        # of the stacked expert weights), then exchanged
        recv = ep_all_to_all(send.view(ep, e_loc, C, d), axis)
        expert_in = recv.transpose(0, 1).reshape(e_loc, ep * C, d)
        expert_out = expert_fn(expert_in)
        back = expert_out.reshape(e_loc, ep, C, -1).transpose(0, 1)
        ret = ep_all_to_all(back.contiguous(), axis).reshape(
            num_experts * C, -1)
        o = _unbucket(ret, slot) * top_p[:, None].to(ret.dtype)
        out_loc = _add(out_loc, o)
    return ep_gather_tokens(out_loc, axis), aux


def _add(a, b):
    a, b = amp.cast_inputs_for("add", (a, b))
    return a + b


def expert_ffn(expert_in, w1, b1, w2, b2, act):
    """The stacked experts' FFN: act(x @ w1 + b1) @ w2 + b2 per expert,
    as batched matmuls ([E, n, d] buckets, [E, d, dh] / [E, dh, d]
    weights, [E, 1, ·] biases)."""
    x, w = amp.cast_inputs_for("einsum", (expert_in, w1))
    h = act(_add(torch.bmm(x, w), b1))
    h, w = amp.cast_inputs_for("einsum", (h, w2))
    return _add(torch.bmm(h, w), b2)


_ACTS = {"gelu": lambda h: F.gelu(h, approximate=True), "relu": F.relu}


class NaiveGate(Layer):
    """The top-k linear gate: a Linear [d_model, num_experts] with bias."""

    def __init__(self, d_model, num_experts, topk=2, device=None,
                 dtype="float32", seed=0):
        super().__init__()
        device = resolve_device(device)
        self.gate = Linear(d_model, num_experts, device=device,
                           dtype=resolve_dtype(dtype))
        self.topk = topk
        self.num_experts = num_experts
        with torch.no_grad():
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
            _xavier_(self.gate.weight, d_model, num_experts, gen)
            self.gate.bias.zero_()

    def forward(self, x):
        return self.gate(x)


class SwitchGate(NaiveGate):
    def __init__(self, d_model, num_experts, **kw):
        super().__init__(d_model, num_experts, topk=1, **kw)


class GShardGate(NaiveGate):
    def __init__(self, d_model, num_experts, **kw):
        super().__init__(d_model, num_experts, topk=2, **kw)


def _xavier_(w, fan_in, fan_out, gen):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=gen)


class MoELayer(Layer):
    """The MoE layer: stacked experts w1 [E, d, dh], b1 [E, 1, dh], w2
    [E, dh, d], b2 [E, 1, d] (their specs recorded over "ep"), the gate
    (a `NaiveGate` of `topk` by default), top-k routing at
    `capacity_factor` (`moe_dispatch_combine`). Every rank routes every
    token through the whole stack, as the reference does under GSPMD.
    `aux_loss` holds the last forward's load-balancing term."""

    def __init__(self, d_model, d_hidden, num_experts, gate=None, topk=1,
                 capacity_factor=1.25, activation="gelu", mp_group=None,
                 recompute_interval=0, device=None, dtype="float32",
                 seed=0):
        super().__init__()
        from .fleet.meta_parallel.mp_layers import mark_sharding

        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.num_experts = num_experts
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.gate = gate or NaiveGate(d_model, num_experts, topk=topk,
                                      device=device, dtype=dtype,
                                      seed=seed)
        E = num_experts

        def param(shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        self.w1 = param([E, d_model, d_hidden])
        self.b1 = param([E, 1, d_hidden])
        self.w2 = param([E, d_hidden, d_model])
        self.b2 = param([E, 1, d_model])
        for p in (self.w1, self.b1, self.w2, self.b2):
            mark_sharding(p, "ep", *([None] * (p.dim() - 1)))
        self._act = _ACTS[activation]
        self.aux_loss = None
        with torch.no_grad():
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed) + 1)
            _xavier_(self.w1, d_model, d_hidden, gen)
            _xavier_(self.w2, d_hidden, d_model, gen)
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        logits = self.gate(flat)

        def experts(expert_in):
            return expert_ffn(expert_in, self.w1, self.b1, self.w2,
                              self.b2, self._act)

        out, aux = moe_dispatch_combine(
            flat, logits, experts, self.num_experts,
            capacity_factor=self.capacity_factor, topk=self.topk)
        self.aux_loss = aux
        return out.reshape(shape)
