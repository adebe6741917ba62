"""1F1B pipeline parallelism, one process per stage (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pipeline_1f1b.py).

The reference runs the whole schedule as one `lax.scan` inside a
`shard_map` over the ``pp`` mesh axis: every tick, every stage does one
forward and one backward micro-step, activations hop stages on a
`ppermute` ring and cotangents on the reverse ring. The port keeps its
schedule and its pure pieces (`PipelineSpecs`, `schedule_ticks`,
`interleaved_stacking_order`) exactly, and runs it with one process per
stage: each rank walks ITS row of the one tick table (`schedule_table`,
derived from the reference's formulas)

    stage s forwards work unit u = q·V·pp + v·pp + r   at tick u + s
    stage s backwards unit β = q·V·pp + (V−1−v)·pp + r at tick
                                           (V·pp−1) + β + (pp−1) − s

and does only the valid work of each tick. An activation goes to the
next stage, a cotangent to the previous one (the ring for chunk hops of
interleaved stages), over the port's p2p socket transport
(`xproc.send_bytes` / `recv_bytes`: a send lands in the peer's inbox and
never blocks on the receiver, and each (src, dst, tag) channel is FIFO).
Every rank derives its sends and receives from the same table, so the
two ends of a channel agree on their order and no rank waits on one
that waits on it.

Backward is hand-scheduled as in the reference. With `remat` the
forward tick keeps only the stage input and the backward tick runs the
block again under autograd (the 1F1B ring buffer of inputs); without it
the forward tick keeps its autograd graph until the unit's backward
tick. The last stage seeds each micro's cotangent from `loss_fn`. The
whole schedule sits in the forward of one `torch.autograd.Function`, as
the reference's sits in a `custom_vjp`: its backward hands back the
accumulated gradients (×1/M, scaled by the incoming cotangent), so an
embedding before the pipeline (stage 0) and a head after it (the last
stage) compose through the caller's autograd. Gradients land on the
rank that holds the tensor: stacked parameters on their stage, post
parameters on the last stage, the input cotangents on stage 0 — a model
that keeps a copy of a tied weight on two stages sums the two itself
(`PipelinedGPTForCausalLM`). The loss, the mean over micro-batches, is
all-reduced over ``pp``, so every stage returns it.

The degenerate ``pp == 1`` branch runs straight-line, still
micro-batched, with remat honoured: the one-card path.

The aux channel (`aux_weight`, the MoE load-balancing term): the block
then returns (y, aux). Each stage sums the aux of its valid forward
units, the sum is all-reduced over ``pp`` and divided by M, and each
valid backward unit seeds the aux's cotangent with `aux_weight` (times
the dp size when `specs.dp_axis` averages the gradients here, and times
`aux_dp` when the caller's step averages them over that many ranks
afterwards: the aux is the global batch's value and each rank's
gradient a partial of it, the reference's `aux_seed`). The result is
the pair (loss + aux_weight·aux, aux), the second a detached metric.

Sequence parallelism (`specs.sum_axes`, e.g. ("sp",)): each rank of those
axes holds a partial of the global loss (its shard's masked token sum
over the global token count), so the loss, the aux and the parameter
gradients are SUMMED over them after the pp reduction, and the aux's
cotangent seed is scaled by their sizes (the block pre-scales the aux
by their inverse). The input cotangents need no touch-up: the ring's
own backward routed the cross-shard terms. A pp == 1 run with sum axes
takes the one-stage table, so the same reductions apply. Each forward
and backward tick names its micro-batch (× V + chunk) and its phase in
`sequence_parallel.ring_scope`, so the ring frames of a tick are tagged
apart from every other's.
"""
import json
import struct
import time
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ... import mesh as mesh_mod
from ...sequence_parallel import ring_scope

__all__ = ["pipeline_1f1b", "pipeline_forward_loss",
           "interleaved_pipeline_loss", "interleaved_stacking_order",
           "schedule_ticks", "schedule_table", "PipelineSpecs", "stats",
           "last_schedule"]

# calls, payload bytes and seconds of the stage handoffs ("p2p_send",
# "p2p_recv": a receive's seconds include its wait for the peer), summed
# over runs until cleared
stats = {}
# the (tick, "F" | "B", micro, chunk) work this rank ran in its last
# schedule
last_schedule = []

_TAG_FWD, _TAG_BWD = 7101, 7102


class PipelineSpecs(NamedTuple):
    """The reference's per-leaf specs of a hybrid pipeline run. Each rank
    of the port already holds its shards, so `stacked` / `post` / `x` /
    `y` are recorded, not applied. `dp_axis` names the axis the loss and
    the gradients are averaged over (each dp rank ran its rows);
    `quant_dp` averages the gradients over `dp_axis` with the
    block-scaled int8 exchange (`distributed.quant_collective`; the loss
    and the aux stay exact). `sum_axes` (sequence parallelism) names the
    axes the loss, the aux and the gradients are summed over (each rank
    holds a partial of them)."""
    stacked: Optional[Tuple] = None
    post: Optional[Tuple] = None
    x: Optional[tuple] = None
    y: Optional[tuple] = None
    dp_axis: Optional[str] = None
    sum_axes: Optional[Tuple[str, ...]] = None
    quant_dp: bool = False


def schedule_ticks(M, pp, num_virtual=1):
    """Length of the (interleaved) 1F1B lockstep schedule: M·V +
    (V+1)·pp − 2 for pp | M (the reference's derivation: the last unit's
    forward cannot start before tick M·V−1 and its cotangent then crosses
    all V·pp logical stages), M + 2(pp−1) at V=1."""
    V = num_virtual
    qh, rh = divmod(M - 1, pp)
    return qh * V * pp + (V - 1) * pp + rh + (V + 1) * pp - 1


def schedule_table(M, pp, num_virtual=1):
    """The one tick table: for each stage, [(tick, forward unit or None,
    backward unit or None)] over `schedule_ticks(M, pp, V)` ticks, a unit
    being (micro, chunk). Work units past the last micro (M not a
    multiple of pp) are idle, as the reference masks them."""
    V = num_virtual
    Vpp = V * pp
    qh, rh = divmod(M - 1, pp)
    u_max = qh * Vpp + (V - 1) * pp + rh
    T = schedule_ticks(M, pp, V)
    table = []
    for s in range(pp):
        rows = []
        for t in range(T):
            fwd = bwd = None
            u = t - s
            if 0 <= u <= u_max:
                q, rem = divmod(u, Vpp)
                v, r = divmod(rem, pp)
                if q * pp + r < M:
                    fwd = (q * pp + r, v)
            b = t + s - Vpp - pp + 2
            if 0 <= b <= u_max:
                q, rem = divmod(b, Vpp)
                vr, r = divmod(rem, pp)
                if q * pp + r < M:
                    bwd = (q * pp + r, V - 1 - vr)
            rows.append((t, fwd, bwd))
        table.append(rows)
    return table


def interleaved_stacking_order(pp, num_virtual):
    """Row order for stacking global blocks into the [pp·V, ...] stack:
    stack row r holds global block order[r]; stage s's rows are
    [s·V, (s+1)·V), so order[s·V + v] = v·pp + s (round-robin)."""
    order = [0] * (pp * num_virtual)
    for g in range(pp * num_virtual):
        v, s = divmod(g, pp)
        order[s * num_virtual + v] = g
    return order


# ---------------------------------------------------------------- p2p

def _note(kind, nbytes, seconds):
    d = stats.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    d["calls"] += 1
    d["bytes"] += int(nbytes)
    d["seconds"] += seconds


def _send(t, dst, tag):
    """`t` to global rank `dst`, bit-exact (bf16 travels as its 16-bit
    words)."""
    from ... import xproc

    t0 = time.perf_counter()
    h = t.detach().contiguous().cpu()
    words = h.view(torch.int16) if h.dtype == torch.bfloat16 else h
    head = json.dumps({"dtype": str(h.dtype).split(".")[-1],
                       "shape": list(h.shape)}).encode()
    body = words.numpy().tobytes()
    xproc.send_bytes(struct.pack("<I", len(head)) + head + body, dst, tag)
    _note("p2p_send", len(body), time.perf_counter() - t0)


def _recv(src, tag, device):
    from ... import xproc

    t0 = time.perf_counter()
    raw = xproc.recv_bytes(src, tag)
    n = struct.unpack("<I", raw[:4])[0]
    head = json.loads(raw[4:4 + n])
    dtype = getattr(torch, head["dtype"])
    store = torch.int16 if dtype == torch.bfloat16 else dtype
    t = torch.frombuffer(bytearray(raw[4 + n:]), dtype=store)
    t = t.reshape(head["shape"])
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    out = t.to(device)
    _note("p2p_recv", len(raw) - 4 - n, time.perf_counter() - t0)
    return out


def last_stage_shape(shape):
    """The shape the last stage names (None elsewhere), on every rank."""
    from ... import xproc

    return next(s for s in xproc.all_gather_obj(shape) if s is not None)


def pp_world():
    """(pp size, this rank's stage, the pp group's global ranks by
    stage); (1, 0, [rank]) in one process."""
    from ... import env, xproc

    mesh = mesh_mod.global_mesh()
    if mesh.shape["pp"] == 1 or not xproc.is_multiprocess():
        return 1, 0, [env.get_rank()]
    members = mesh.group_ranks(("pp",), env.get_rank())
    return len(members), members.index(env.get_rank()), members


# --------------------------------------------------------- the schedule

def _check_specs(specs, aux_weight, aux_dp=1):
    """(specs, the aux cotangent seed or None)."""
    sp = specs if specs is not None else PipelineSpecs()
    if aux_weight is None:
        return sp, None
    seed = float(aux_weight) * aux_dp
    if sp.dp_axis is not None:
        seed *= mesh_mod.axis_size(sp.dp_axis)
    for ax in sp.sum_axes or ():
        seed *= mesh_mod.axis_size(ax)
    return sp, seed


def _sum_axes(sp):
    """The sum axes of size > 1, as one group's axes (or ())."""
    return tuple(a for a in sp.sum_axes or () if mesh_mod.axis_size(a) > 1)


class _AuxTerm(torch.autograd.Function):
    """aux · `weight` forward; the cotangent times `seed` backward (the
    aux's gradient seeded as the reference's `aux_seed`)."""

    @staticmethod
    def forward(ctx, aux, weight, seed):
        ctx.seed = seed
        return aux * weight

    @staticmethod
    def backward(ctx, g):
        return g * ctx.seed, None, None


def _split_aux(out, has_aux):
    return out if has_aux else (out, None)


def _chunk(tree, v, V):
    if V == 1:
        return tree
    return pytree.tree_map(lambda a: a[v], tree)


def _wrap_remat(block_fn, remat):
    if not remat:
        return block_fn
    from ..recompute import checkpoint_policy, run_with_policy

    policy = checkpoint_policy(remat)
    return lambda p, x: run_with_policy(block_fn, (p, x), policy)


def _straight_line(block_fn, loss_fn, stacked, post, x_micro, y_micro,
                   remat, V, aux_weight=None, aux_seed=None):
    """pp == 1: every micro through every chunk, the mean of the micro
    losses, under the caller's autograd; with the aux channel (loss +
    aux_weight·aux, aux), the aux the mean over micros of each micro's
    sum over chunks."""
    blk = _wrap_remat(block_fn, remat)
    has_aux = aux_weight is not None
    losses, auxs = [], []
    for m in range(x_micro.shape[0]):
        x = x_micro[m]
        for v in range(V):
            x, a = _split_aux(blk(_chunk(stacked, v, V), x), has_aux)
            if has_aux:
                auxs.append(a.float())
        losses.append(loss_fn(x, y_micro[m], post).float())
    loss = torch.stack(losses).mean()
    if not has_aux:
        return loss
    aux = torch.stack(auxs).sum() / x_micro.shape[0]
    seed = aux_weight if aux_seed is None else aux_seed
    return loss + _AuxTerm.apply(aux, float(aux_weight), seed), aux.detach()


def _leaf(x):
    x = x.detach()
    return x.requires_grad_() if x.is_floating_point() else x


def _run_table(rows, block_fn, loss_fn, stacked, post, x_micro, y_micro,
               remat, V, stage, pp, members, aux_seed=None):
    """Walk this stage's rows of a tick table. Returns (loss sum over
    this stage's head units, aux sum over its forward units (None
    without the aux channel), stacked leaves, post leaves, input
    cotangents [M, ...] or None) — the leaves carry the accumulated
    gradients. With `aux_seed` the block returns (y, aux) and each
    backward unit seeds the aux's cotangent with it."""
    has_aux = aux_seed is not None
    s_leaves, s_def = pytree.tree_flatten(stacked)
    h_leaves, h_def = pytree.tree_flatten(post)
    s_leaves = [p.detach().requires_grad_(p.requires_grad)
                for p in s_leaves]
    h_leaves = [p.detach().requires_grad_(p.requires_grad)
                for p in h_leaves]
    s_tree = pytree.tree_unflatten(s_leaves, s_def)
    h_tree = pytree.tree_unflatten(h_leaves, h_def)
    nxt, prv = members[(stage + 1) % pp], members[(stage - 1) % pp]
    device = x_micro.device
    saved = {}
    # an integer input (token ids into a first-stage embedding) has no
    # cotangent
    grad_in = x_micro.is_floating_point()
    dxs = torch.zeros_like(x_micro) if stage == 0 and grad_in else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=device)
    log = []
    for t, fwd, bwd in rows:
        if fwd is not None:
            m, v = fwd
            with ring_scope(micro=m * V + v, phase="forward"):
                if stage == 0 and v == 0:
                    x_in = x_micro[m]
                else:
                    x_in = _recv(prv, _TAG_FWD, device)
                if remat:
                    with torch.no_grad():
                        out, a = _split_aux(block_fn(_chunk(s_tree, v, V),
                                                     x_in), has_aux)
                    saved[(m, v)] = x_in
                else:
                    x_leaf = _leaf(x_in)
                    with torch.enable_grad():
                        # the chunk's selection inside the graph: its
                        # gradient reaches the stacked leaf
                        out, a = _split_aux(block_fn(_chunk(s_tree, v, V),
                                                     x_leaf), has_aux)
                    saved[(m, v)] = (x_leaf, out, a)
                if has_aux:
                    aux_sum = aux_sum + a.detach().float()
                if not (stage == pp - 1 and v == V - 1):
                    _send(out, nxt, _TAG_FWD)
            log.append((t, "F", m, v))
        if bwd is not None:
            m, v = bwd
            with ring_scope(micro=m * V + v, phase="recompute"):
                if remat:
                    x_leaf = _leaf(saved.pop((m, v)))
                    with torch.enable_grad():
                        out, a = _split_aux(block_fn(_chunk(s_tree, v, V),
                                                     x_leaf), has_aux)
                else:
                    x_leaf, out, a = saved.pop((m, v))
                with torch.enable_grad():
                    if stage == pp - 1 and v == V - 1:
                        lv = loss_fn(out, y_micro[m], h_tree).float()
                        roots, cots = [lv], [torch.ones_like(lv)]
                        loss_sum = loss_sum + lv.detach()
                    else:
                        roots, cots = [out], [_recv(nxt, _TAG_BWD, device)]
                    if has_aux and a.requires_grad:
                        roots.append(a)
                        cots.append(torch.full_like(a, aux_seed))
                    torch.autograd.backward(roots, cots)
                if stage == 0 and v == 0:
                    if dxs is not None and x_leaf.grad is not None:
                        dxs[m] = x_leaf.grad
                else:
                    dx = x_leaf.grad
                    _send(dx if dx is not None else torch.zeros_like(x_leaf),
                          prv, _TAG_BWD)
            log.append((t, "B", m, v))
    last_schedule[:] = log
    return (loss_sum, aux_sum if has_aux else None, s_leaves, h_leaves,
            dxs)


class _PipelineFn(torch.autograd.Function):
    """The schedule as one autograd node: forward runs it and keeps the
    gradients; backward returns them scaled by the incoming cotangent
    (the reference's custom_vjp). With the aux channel the second
    output, the aux, is a detached metric."""

    @staticmethod
    def forward(ctx, run, n_stacked, x_micro, *flat):
        loss, aux, s_grads, h_grads, dx = run(
            x_micro, list(flat[:n_stacked]), list(flat[n_stacked:]))
        ctx.grads = (dx, s_grads, h_grads)
        if aux is None:
            return loss
        ctx.mark_non_differentiable(aux)
        return loss, aux

    @staticmethod
    def backward(ctx, g, *_aux):
        dx, s_grads, h_grads = ctx.grads
        ctx.grads = None

        def scale(t, need):
            if t is None or not need:
                return None
            return t * g.to(t.dtype)

        needs = ctx.needs_input_grad
        grads = list(s_grads) + list(h_grads)
        return (None, None, scale(dx, needs[2]),
                *[scale(t, n) for t, n in zip(grads, needs[3:])])


def _sum_partials(grads, scalars, axes):
    """Sum the gradients (in place in the list) and the loss / aux
    scalars over `axes`, one coalesced all-reduce; returns the scalars."""
    from ..utils.hybrid_parallel_util import coalesced_all_reduce

    have = [i for i, g in enumerate(grads) if g is not None]
    red = coalesced_all_reduce([grads[i] for i in have] + [scalars], axes,
                               op="sum")
    scalars = red.pop()
    for i, g in zip(have, red):
        grads[i] = g
    return scalars


def _finish(loss_sum, aux_sum, s_leaves, h_leaves, dxs, M, sp,
            aux_weight=None):
    """1/M on the loss, the aux and every gradient; the loss (it lives on
    the last stage) and the aux (each stage's layers') summed over pp;
    the loss, the aux and the gradients summed over `sp.sum_axes` (one
    coalesced all-reduce); the dp average when `sp.dp_axis` names one
    (each dp rank ran its rows), in int8 for the gradients under
    `sp.quant_dp`. Returns (loss + aux_weight·aux, aux or None, stacked
    grads, post grads, dx)."""
    from ..utils.hybrid_parallel_util import coalesced_all_reduce
    from .mp_ops import all_reduce_mp_raw

    inv_m = 1.0 / M
    scalars = loss_sum.reshape(1) if aux_sum is None else torch.stack(
        [loss_sum, aux_sum])
    scalars = all_reduce_mp_raw(scalars, axis="pp", kind="pp_loss") * inv_m
    grads = [None if p.grad is None else p.grad * inv_m
             for p in s_leaves + h_leaves]
    dx = None if dxs is None else dxs * inv_m
    axes = _sum_axes(sp)
    if axes:
        scalars = _sum_partials(grads, scalars, axes)
    if sp.dp_axis is not None and mesh_mod.axis_size(sp.dp_axis) > 1:
        n = mesh_mod.axis_size(sp.dp_axis)
        have = [i for i, g in enumerate(grads) if g is not None]
        if sp.quant_dp:
            from ...quant_collective import quantized_pmean_tree

            red = quantized_pmean_tree([grads[i] for i in have],
                                       (sp.dp_axis,))
            scalars = coalesced_all_reduce([scalars], (sp.dp_axis,),
                                           op="avg")[0]
        else:
            red = coalesced_all_reduce([grads[i] for i in have] + [
                scalars], (sp.dp_axis,), op="avg")
            scalars = red.pop()
        for i, g in zip(have, red):
            grads[i] = g
        if dx is not None:
            dx = dx / n
    loss = scalars[0]
    aux = None if aux_sum is None else scalars[1]
    if aux is not None:
        loss = loss + float(aux_weight) * aux
    ns = len(s_leaves)
    return loss, aux, grads[:ns], grads[ns:], dx


def _pipeline(rows_of, block_fn, loss_fn, stacked_params, post_params,
              batch, remat, V, specs, aux_weight=None, aux_seed=None):
    """Run the schedule whose per-stage rows `rows_of(M, pp)` gives, as
    one differentiable call (the pair (loss, aux) with the aux
    channel)."""
    x_micro, y_micro = batch
    pp, stage, members = pp_world()
    s_leaves, s_def = pytree.tree_flatten(stacked_params)
    h_leaves, h_def = pytree.tree_flatten(post_params)
    M = x_micro.shape[0]

    def run(x, s_flat, h_flat):
        s = pytree.tree_unflatten(s_flat, s_def)
        h = pytree.tree_unflatten(h_flat, h_def)
        rows = rows_of(M, pp)[stage]
        out = _run_table(rows, block_fn, loss_fn, s, h, x, y_micro, remat,
                         V, stage, pp, members, aux_seed)
        return _finish(*out, M, specs, aux_weight)

    return _PipelineFn.apply(run, len(s_leaves), x_micro, *s_leaves,
                             *h_leaves)


def pipeline_1f1b(block_fn, loss_fn, stacked_params, post_params, batch,
                  remat=True, num_virtual=1, specs=None, aux_weight=None,
                  aux_dp=1):
    """Differentiable 1F1B pipeline loss.

    block_fn(stage_params, x) -> y: one stage's forward; stage_params is
        this rank's `stacked_params` (with V > 1, one chunk: the leaves'
        leading [V] axis indexed).
    loss_fn(y, labels, post_params) -> scalar: the last stage's head and
        loss.
    stacked_params: pytree of this stage's tensors (leading [V] axis at
        num_virtual > 1). post_params: pytree of the head's tensors (used
        on the last stage).
    batch: (x_micro [M, ...], y_micro [M, ...]); on stages past the first
        x_micro only gives the activations' shape, dtype and device.
    remat: recompute the stage in its backward tick from its kept input
        (any true value; a policy name recomputes the whole stage too)
        instead of keeping its autograd graph (False). At pp 1 a policy
        name applies to each chunk (`fleet.recompute`).

    aux_weight: when not None, block_fn returns (y, aux) and the result
        is the pair (loss + aux_weight·aux, aux) (module docstring).
    aux_dp: the number of ranks the caller averages the gradients over
        after this call (HybridTrainStep's dp); it scales the aux's
        cotangent seed as `specs.dp_axis`'s size does.

    Returns the mean micro-batch loss on every stage. Gradients flow to
    stacked_params, to post_params on the last stage and to x_micro on
    stage 0."""
    sp, seed = _check_specs(specs, aux_weight, aux_dp)
    x_micro, y_micro = batch
    V = num_virtual
    if pp_world()[0] == 1 and not _sum_axes(sp):
        out = _straight_line(block_fn, loss_fn, stacked_params,
                             post_params, x_micro, y_micro, remat, V,
                             aux_weight, seed)
        return _dp_mean(out, sp.dp_axis)
    return _pipeline(lambda M, pp: schedule_table(M, pp, V), block_fn,
                     loss_fn, stacked_params, post_params, batch,
                     bool(remat), V, sp, aux_weight, seed)


def _dp_mean(out, axis):
    """The mean of each dp rank's loss (and aux); the gradient of each
    rank's share is 1/dp of its own (the reference's pmean)."""
    from .mp_ops import all_reduce_mp_raw, allreduce_mp

    n = mesh_mod.axis_size(axis) if axis is not None else 1
    if n == 1:
        return out
    if isinstance(out, tuple):
        loss, aux = out
        return (allreduce_mp(loss / n, axis),
                all_reduce_mp_raw(aux, axis=axis, op="avg",
                                  kind="dp_aux"))
    return allreduce_mp(out / n, axis)


def pipeline_forward_loss(block_fn, loss_fn, stacked_params, post_params,
                          batch, specs=None, aux_weight=None):
    """Forward-only fill-drain pipeline loss (the eval path: M + pp − 1
    ticks, no gradient machinery): stage s forwards micro m at tick
    m + s. Every stage returns the mean micro loss (with `aux_weight`,
    the pair (loss + aux_weight·mean aux, mean aux))."""
    sp, seed = _check_specs(specs, aux_weight)
    has_aux = aux_weight is not None
    x_micro, y_micro = batch
    M = x_micro.shape[0]
    pp, stage, members = pp_world()
    with torch.no_grad():
        if pp == 1 and not _sum_axes(sp):
            out = _straight_line(block_fn, loss_fn, stacked_params,
                                 post_params, x_micro, y_micro, False, 1,
                                 aux_weight, seed)
            return _dp_mean(out, sp.dp_axis)
        auxs = []

        def blk(p, x):
            y, a = _split_aux(block_fn(p, x), has_aux)
            auxs.append(a)
            return y

        outs = fill_drain(blk, stacked_params, x_micro, stage, pp, members)
        device = x_micro.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        if stage == pp - 1:
            for m in range(M):
                loss_sum = loss_sum + loss_fn(outs[m], y_micro[m],
                                              post_params).float()
        aux_sum = (torch.stack(auxs).float().sum() if has_aux else None)
        loss, aux, _, _, _ = _finish(loss_sum, aux_sum, [], [], None, M,
                                     sp, aux_weight)
        return (loss, aux) if has_aux else loss


def fill_drain(block_fn, params, xs, stage, pp, members):
    """The forward fill-drain over the pp group: stage s forwards micro m
    at tick m + s. Returns the last stage's outputs by micro (a list;
    None on other stages)."""
    M = xs.shape[0]
    nxt, prv = members[(stage + 1) % pp], members[(stage - 1) % pp]
    outs = [] if stage == pp - 1 else None
    log = []
    for t in range(M + pp - 1):
        m = t - stage
        if not 0 <= m < M:
            continue
        x_in = xs[m] if stage == 0 else _recv(prv, _TAG_FWD, xs.device)
        with ring_scope(micro=m, phase="forward"):
            out = block_fn(params, x_in)
        if stage == pp - 1:
            outs.append(out)
        else:
            _send(out, nxt, _TAG_FWD)
        log.append((t, "F", m, 0))
    last_schedule[:] = log
    return outs


def interleaved_pipeline_loss(block_fn, loss_fn, stacked_params,
                              post_params, batch, num_virtual=1,
                              remat=True, specs=None, aux_weight=None):
    """Tick-interleaved virtual stages: each stage owns `num_virtual`
    non-contiguous chunks of the layer stack (round-robin,
    `interleaved_stacking_order`), its `stacked_params` leaves carrying a
    leading [V] axis; all V·pp logical stages run on the one 1F1B table
    of `schedule_ticks(M, pp, V)` ticks."""
    pp = pp_world()[0]
    lead = pytree.tree_leaves(stacked_params)[0].shape[0]
    if lead != num_virtual:
        raise ValueError(
            f"stacked_params leading dim {lead} != V = {num_virtual} "
            f"(this stage's chunks of the pp*V = {pp}*{num_virtual} "
            "stack)")
    return pipeline_1f1b(block_fn, loss_fn, stacked_params, post_params,
                         batch, remat, num_virtual, specs, aux_weight)
