"""DistributedTrainStep — the data-parallel and ZeRO train step
(counterpart of paddle_tpu/distributed/parallel_step.py).

One process per mesh position. Each call takes the GLOBAL batch, as the
reference's does; a rank keeps its rows by its position along the batch
axes (``dp`` × ``sharding`` by default, the reference's batch sharding),
runs forward and backward on them, and the gradients are averaged over
those axes: one coalesced host all-reduce per dtype
(fleet.utils.hybrid_parallel_util). The loss returned is the global one,
the mean of the ranks' losses over equal row counts.

ZeRO follows the reference's levels over the ``sharding`` axis; each
parameter is split along its largest dimension divisible by the axis
size (`_zero_spec`), and this rank owns one block:

- ``os``: the optimizer's accumulators hold this rank's block only; the
  update runs on the block, and the updated blocks are all-gathered;
- ``os_g``: also the gradients: the update reads only this rank's block
  of the averaged gradient (the reduce-scatter's share);
- ``p_g_os``: also the parameters: between steps each module parameter
  holds only this rank's block; the step all-gathers the whole
  parameter for forward and backward and keeps the block after the
  update.

`grad_clip` sees the whole averaged gradients. Optimizers whose update
reads norms over a whole parameter (LarsMomentum, Lamb, DGCMomentum)
refuse a sharded level.

`quant_allreduce=True` (or PT_QUANT_ALLREDUCE_XLA=1) averages the
gradients over the replica axes (``dp``, then ``sharding``) with the
block-scaled int8 exchange (`quant_collective.quantized_pmean_tree`);
the loss stays an exact mean. As the reference's, it takes replicated
parameters and the default batch layout only: ZeRO ``p_g_os``, custom
`batch_specs` and a mesh-sharded parameter raise its ValueErrors
(`_validate_quant_path`). At world 1 the step computes exactly what
`jit.TrainStep` computes, and the steptrace telemetry is the same
("dist" family).
"""
import time
import warnings

import numpy as np
import torch

from ..core import rng
from ..observability import steptrace as _steptrace
from . import mesh as mesh_mod
from .mesh import PartitionSpec as P

__all__ = ["DistributedTrainStep", "shard_params_and_opt", "sharding_of"]

_LEVELS = ("os", "os_g", "p_g_os")


def sharding_of(param_value, pspec):
    """This rank's block of a tensor under `pspec`: a tuple of slices,
    one per dimension (the reference returns the NamedSharding)."""
    mesh = mesh_mod.global_mesh()
    me = mesh_mod.coord()
    out = []
    for d, dim in enumerate(param_value.shape):
        entry = pspec[d] if pspec is not None and d < len(pspec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        pos = 0
        for a in axes:
            pos = pos * mesh.shape[a] + me[a]
        size = dim // n
        out.append(slice(pos * size, (pos + 1) * size))
    return tuple(out)


def _contains_axis(entry, axis):
    if entry is None:
        return False
    if isinstance(entry, (tuple, list)):
        return axis in entry
    return entry == axis


def _zero_spec(pv, level, base_pspec, axis="sharding"):
    """The ZeRO placement of a parameter / state leaf: its largest
    dimension divisible by the axis size that the base spec leaves
    free, over `axis`. Idempotent; a leaf with no divisible free
    dimension stays replicated (with a warning)."""
    ndim = len(pv.shape)
    base = tuple(base_pspec) if base_pspec is not None else ()
    base = base + (None,) * (ndim - len(base))
    if any(_contains_axis(e, axis) for e in base):
        return P(*base)
    n = mesh_mod.axis_size(axis)
    if n == 1:
        return P(*base) if any(base) else P()
    for d in np.argsort([-s for s in pv.shape]):
        d = int(d)
        if base[d] is None and pv.shape[d] % n == 0:
            new = list(base)
            new[d] = axis
            return P(*new)
    if any(e is None for e in base):
        warnings.warn(
            f"ZeRO ({level}): no free dim of shape {tuple(pv.shape)} is "
            f"divisible by the sharding axis ({n}) — this leaf stays "
            "REPLICATED and saves no memory; pad the dim or change the "
            "axis size", RuntimeWarning, stacklevel=2)
    return P(*base) if any(base) else P()


def shard_params_and_opt(model, optimizer, level="os_g", axis="sharding"):
    """Record the ZeRO placements (the reference's group_sharded
    levels: os = stage 1, os_g = stage 2, p_g_os = stage 3): at p_g_os
    each parameter's `_pspec` names the dimension its storage splits
    over `axis`. The blocks are cut by the DistributedTrainStep that
    trains the model."""
    for _, p in model.named_parameters():
        if level == "p_g_os":
            p._pspec = _zero_spec(p, level, getattr(p, "_pspec", None),
                                  axis=axis)
    return model


def _split(spec):
    """(dim, axis) of a spec's one split dimension, or None."""
    for d, e in enumerate(spec):
        if e is not None:
            return d, e
    return None


class DistributedTrainStep:
    """loss_fn(model, *batch) -> scalar loss. Each call takes one
    optimizer step on the global `batch` and returns the global loss
    (detached). batch_specs: one PartitionSpec per batch tensor (default:
    dim 0 over ("dp", "sharding")); the rows split over the first
    dimension's axes, and a later dimension's axes (P("dp", "sp")) hold
    the rows whole, as the reference's GSPMD step computes them.
    zero_level: None, "os", "os_g" or "p_g_os" (None takes the
    optimizer's `_zero_level`, which `sharding.group_sharded_parallel`
    sets). remat as `jit.TrainStep`'s.
    quant_allreduce: the int8 gradient exchange (None follows
    PT_QUANT_ALLREDUCE_XLA; module docstring)."""

    _steptrace_family = "dist"
    # the mesh axis the ZeRO blocks split over
    _zero_axis = "sharding"

    def __init__(self, model, loss_fn, optimizer, zero_level=None,
                 batch_specs=None, remat=False, quant_allreduce=None):
        from .fleet.recompute import checkpoint_policy
        from .quant_collective import xla_quant_enabled

        if quant_allreduce is None:
            quant_allreduce = xla_quant_enabled()
        self.quant_allreduce = bool(quant_allreduce)
        zero_level = zero_level or getattr(optimizer, "_zero_level", None)
        if zero_level not in (None,) + _LEVELS:
            raise ValueError(f"zero_level {zero_level!r}: use one of "
                             f"{_LEVELS}")
        self._policy = checkpoint_policy(remat)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.zero = zero_level
        self.batch_specs = batch_specs
        self.remat = remat
        if zero_level:
            shard_params_and_opt(model, optimizer, zero_level,
                                 axis=self._zero_axis)
        self._named = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        self._params = [p for _, p in self._named]
        self._data_axes = self._batch_axes()
        self._quant_axes = ()
        if self.quant_allreduce:
            self._quant_axes = tuple(a for a in self._quant_axis_names()
                                     if mesh_mod.axis_size(a) > 1)
            if self._quant_axes:
                self._validate_quant_path()
        # ZeRO: id(p) -> (dim, n, position, global shape) of the rank's
        # block; parameters at p_g_os keep only their block between steps
        self._blocks = {}
        self._sharded_params = set()
        n = mesh_mod.axis_size(self._zero_axis)
        if zero_level and n > 1:
            if not getattr(optimizer, "_elementwise", True):
                raise NotImplementedError(
                    f"{type(optimizer).__name__} reads norms over whole "
                    "parameters: it cannot update a ZeRO block alone")
            pos = mesh_mod.axis_index(self._zero_axis)
            for p in self._params:
                spec = _zero_spec(p, zero_level, None, axis=self._zero_axis)
                split = _split(spec)
                if split is None:
                    continue
                self._blocks[id(p)] = (split[0], n, pos, tuple(p.shape))
            if zero_level == "p_g_os":
                with torch.no_grad():
                    for p in self._params:
                        if id(p) in self._blocks:
                            p.data = self._block_of(p, p.data).clone()
                            self._sharded_params.add(id(p))
        self._batch_signatures = set()
        self._steptrace_prev_end = None
        # the last step's collectives: the gradient all-reduce's bytes
        # and seconds ("bytes", "seconds"; with the copies around it
        # "step_comm_s"), the blocks' all-gathers' seconds ("gather_s")
        self.comm_stats = {}

    # ---- the int8 gradient exchange ----
    def _quant_axis_names(self):
        return ("dp", "sharding")

    def _validate_quant_path(self):
        """The int8 exchange averages replicated gradients over the
        replica axes: parameters must be replicated and the batch must
        take the default replica-axis layout (the reference's rules and
        messages)."""
        if self.zero == "p_g_os":
            raise ValueError(
                "quant_allreduce does not compose with zero_level="
                "'p_g_os' (sharded param storage): the int8 grad "
                "exchange assumes replicated params. Use 'os'/'os_g' "
                "(sharded optimizer state composes fine) or disable "
                "PT_QUANT_ALLREDUCE_XLA for this step")
        if self.batch_specs is not None:
            raise ValueError(
                "quant_allreduce supports the default replica-axis "
                "batch sharding only (custom batch_specs — e.g. "
                "sequence sharding — would need their own loss "
                "reduction semantics inside the shard_map)")
        for p in self._params:
            spec = getattr(p, "_pspec", None)
            if spec is not None and any(s is not None for s in spec):
                raise ValueError(
                    f"quant_allreduce: parameter with _pspec {spec} is "
                    "mesh-sharded — the int8 grad exchange supports "
                    "replicated params only (TP models: use "
                    "HybridTrainStep, whose pipeline schedule "
                    "quantizes the dp axis while mp stays exact)")

    # ---- layout ----
    def _batch_axes(self):
        """The axes the batch's rows split over: the gradients and the
        loss are averaged over them."""
        if self.batch_specs is None:
            return ("dp", "sharding")
        axes = []
        for spec in self.batch_specs:
            for e in tuple(spec or ())[:1]:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    if a not in axes:
                        axes.append(a)
        return tuple(axes)

    def _block_of(self, p, full):
        """This rank's block of `full` (a tensor of p's whole shape)."""
        dim, n, pos, shape = self._blocks[id(p)]
        size = shape[dim] // n
        return full.narrow(dim, pos * size, size)

    def _slice_batch(self, batch):
        from .collective import _block

        if self.batch_specs is None:
            specs = [P(("dp", "sharding")) if getattr(b, "ndim", 0) else P()
                     for b in batch]
        else:
            # the rows alone. A spec that also splits a later dimension
            # (P("dp", "sp")) is run by the reference through GSPMD,
            # which computes the serial model over the whole sequence:
            # here every rank of that axis keeps its rows' whole sequence
            # and computes the serial model and loss over it, so its
            # gradients equal its replicas' and the average runs over the
            # row axes alone (`_batch_axes`)
            specs = [P(*tuple(s or ())[:1]) for s in self.batch_specs]
        return [_block(b, s) for b, s in zip(batch, specs)]

    # ---- the step ----
    def _loss(self, batch):
        from .fleet.recompute import run_with_policy

        if not self.remat:
            return self.loss_fn(self.model, *batch)
        return run_with_policy(lambda *b: self.loss_fn(self.model, *b),
                               batch, self._policy)

    def _gather_blocks(self, parts_of):
        """All-gather every sharded parameter's block over the sharding
        axis as one flat buffer: {id(p): whole tensor}. Its seconds add
        to `comm_stats["gather_s"]`."""
        from .collective import _gather_np, axis_comm
        from .fleet.utils.hybrid_parallel_util import _host

        ps = [p for p in self._params if id(p) in self._blocks]
        if not ps:
            return {}
        t0 = time.perf_counter()
        members, _ = axis_comm((self._zero_axis,))
        blocks = [parts_of(p) for p in ps]
        flat = torch.cat([b.detach().reshape(-1) for b in blocks])
        mat = torch.from_numpy(np.ascontiguousarray(
            _gather_np(_host(flat), members))).to(device=flat.device,
                                                  dtype=flat.dtype)
        out, off = {}, 0
        for p, b in zip(ps, blocks):
            dim, n, _, shape = self._blocks[id(p)]
            k = b.numel()
            out[id(p)] = torch.cat([mat[j, off:off + k].view(b.shape)
                                    for j in range(n)], dim=dim)
            off += k
        self.comm_stats["gather_s"] = (self.comm_stats.get("gather_s", 0.0)
                                       + time.perf_counter() - t0)
        return out

    def _note_signature(self, batch):
        sig = tuple((tuple(b.shape), str(b.dtype)) for b in batch)
        if sig in self._batch_signatures:
            return False
        self._batch_signatures.add(sig)
        if len(self._batch_signatures) > 1:
            _steptrace.note_recompile(
                self._steptrace_family,
                step=int(self.optimizer._step_count),
                signatures=len(self._batch_signatures), batch_sig=repr(sig))
        return True

    def __call__(self, *batch):
        from .fleet.utils.hybrid_parallel_util import coalesced_all_reduce

        t_entry = _steptrace.now()
        device = self._params[0].device
        batch = [b if isinstance(b, torch.Tensor)
                 else torch.as_tensor(np.asarray(b)) for b in batch]
        local = [b.to(device) for b in self._slice_batch(batch)]
        t_h2d = _steptrace.now()
        quiet = self._note_signature(batch)
        tr = _steptrace.begin_step(
            self._steptrace_family, int(self.optimizer._step_count),
            prev_end=self._steptrace_prev_end, quiet=quiet,
            t_entry=t_entry)
        tr.stamp("h2d", t_h2d)
        _steptrace.chaos_fire("step.dispatch")
        self.comm_stats = {}
        if self._sharded_params:
            # ZeRO-3: the whole parameters for forward and backward
            whole = self._gather_blocks(lambda p: p.data)
            for p in self._params:
                if id(p) in whole:
                    p.data = whole[id(p)]
        self.optimizer.clear_grad()
        with rng.generator_scope(rng.next_generator(device)):
            loss = self._loss(local)
        loss.backward()
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        stats = self.comm_stats
        t0 = time.perf_counter()
        if self._quant_axes:
            from .quant_collective import quantized_pmean_tree

            grads = quantized_pmean_tree([p.grad for p in self._params],
                                         self._quant_axes, stats=stats)
            loss = coalesced_all_reduce([loss.detach().reshape(1)],
                                        self._data_axes, op="avg",
                                        stats=stats)[0]
        else:
            grads = coalesced_all_reduce(
                [p.grad for p in self._params] + [loss.detach().reshape(1)],
                self._data_axes, op="avg", stats=stats)
            loss = grads.pop()
        for p, g in zip(self._params, grads):
            p.grad = g
        loss = loss.reshape(())
        stats["step_comm_s"] = time.perf_counter() - t0
        if not self._blocks:
            self.optimizer._train_step_update(self._params)
        else:
            targets = {}
            for p in self._params:
                if id(p) in self._blocks:
                    dim, n, pos, shape = self._blocks[id(p)]
                    size = shape[dim] // n
                    targets[id(p)] = (self._block_of(p, p.data), dim,
                                      pos * size, size)
            self.optimizer._train_step_update(self._params, targets)
            with torch.no_grad():
                if self._sharded_params:
                    for p in self._params:
                        if id(p) in self._sharded_params:
                            p.data = self._block_of(p, p.data).clone()
                            p.grad = None
                else:
                    whole = self._gather_blocks(
                        lambda p: self._block_of(p, p.data))
                    for p in self._params:
                        if id(p) in whole:
                            p.data.copy_(whole[id(p)])
        tr.stamp("dispatch")
        if _steptrace.active():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tr.stamp("device_step")
        tr.stamp("opt_publish")
        _, self._steptrace_prev_end = _steptrace.end_step(tr)
        return loss.detach()

    # ---- the whole parameters (p_g_os keeps blocks between steps) ----
    def full_parameters(self):
        """{name: whole tensor} of the trainable parameters (gathered
        over the sharding axis at p_g_os)."""
        whole = (self._gather_blocks(lambda p: p.data)
                 if self._sharded_params else {})
        return {n: whole.get(id(p), p.detach()) for n, p in self._named}

    # ---- the Checkpointer's hooks ----
    def _index(self, p):
        dim, n, pos, shape = self._blocks[id(p)]
        size = shape[dim] // n
        return [[pos * size, (pos + 1) * size] if d == dim else [0, s]
                for d, s in enumerate(shape)]

    def _checkpoint_model_state(self):
        from .checkpoint import LocalShard, _model_state

        out = {}
        for name, t in _model_state(self.model).items():
            if id(t) in self._sharded_params:
                t = LocalShard(t.detach(), self._blocks[id(t)][3],
                               self._index(t))
            out[name] = t
        return out

    def _restore_model_state(self, model_sd):
        from .checkpoint import _model_state

        with torch.no_grad():
            for name, p in _model_state(self.model).items():
                full = model_sd[name].to(device=p.device, dtype=p.dtype)
                if id(p) in self._sharded_params:
                    p.data = self._block_of(p, full).clone()
                else:
                    p.copy_(full)

    def _checkpoint_opt_states(self):
        from .checkpoint import LocalShard

        states = self.optimizer._states
        out = {}
        for n, p in self._named:
            st = states.get(id(p))
            if not st:
                continue
            d = {}
            for k, v in st.items():
                if id(p) in self._blocks and v.dim() == p.dim() and \
                        v.shape != self._blocks[id(p)][3]:
                    v = LocalShard(v, self._blocks[id(p)][3],
                                   self._index(p))
                d[k] = v
            out[n] = d
        return out

    def _restore_opt_states(self, opt_sd):
        """Each accumulator from the checkpoint's whole array (any shard
        layout reassembled), cut to this rank's block. The optimizer's
        own `set_state_dict` may have made whole-shaped accumulators
        first: those are cut too."""
        opt = self.optimizer
        with torch.no_grad():
            for n, p in self._named:
                block = self._blocks.get(id(p))
                like = None
                if block is not None:
                    like = torch.empty(
                        [b - a for a, b in self._index(p)],
                        dtype=p.dtype, device=p.device)
                state = opt._state_for(p, like)
                for k, old in list(state.items()):
                    v = opt_sd[n].get(k, old)
                    v = v.to(device=old.device, dtype=old.dtype)
                    if block is not None and tuple(v.shape) == block[3]:
                        v = self._block_of(p, v)
                    state[k] = v.clone()
