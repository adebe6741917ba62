"""HybridTrainStep — the DP × TP × PP train step (counterpart of
paddle_tpu/jit/hybrid_step.py).

One process per mesh position. Each call takes the GLOBAL batch, as the
reference's does, and hands it whole to `loss_fn`: a pipelined model
keeps each dp rank's rows of every micro-batch itself, runs its stage of
the pipeline and its mp shards. The gradients are then averaged over
``dp`` only — the mp and pp gradients are shard-local already (each rank
holds its own slice of each parameter) — in one coalesced host
all-reduce per dtype, and the loss with them.

ZeRO composes on `config.zero_axis` (``dp`` by default: the dp ranks are
the replica group the optimizer state shards over): ``os`` / ``os_g`` /
``p_g_os`` as `DistributedTrainStep` runs them, each block a
slice of this rank's parameter shard. A model whose `shard_storage()`
asked for it keeps its parameter blocks over ``sharding`` (p_g_os).

A MoE model's `aux_loss` is the global batch's value on every dp rank
already (its gate statistics are reduced over dp), so it takes no part
in the dp average; the model tells its pipeline the dp size, which
scales the aux's gradient for this average (the reference's `aux_seed`).

The Checkpointer's hooks write each shard as a `LocalShard` of the
LOGICAL array (the model's `layout()` and `expert_layout()`), so a pp ×
mp × ep checkpoint loads at world 1, in the port and in the reference.
The sp ranks hold identical shards: sp rank 0 writes them and every sp
rank loads them.
`quant_allreduce` (or a config / PT_QUANT_ALLREDUCE_XLA asking for it)
averages the gradients over dp with the block-scaled int8 exchange
(`distributed.quant_collective`); mp, pp and the tied wte's pair stay
exact, and so do the loss and the aux. `compile_stats` and
`analyze_step` are A12's, as for `TrainStep`.

Sequence parallelism needs nothing more here: the pipelined model's
pipeline already sums every parameter's partial gradient over sp (the
reference's shard_map transpose; the embedding's as it leaves stage 0)
and reports the loss as the sum of the shards' partials, so the step's
average stays over dp alone.
"""
from ..distributed import mesh as mesh_mod
from ..distributed.checkpoint import LocalShard
from ..distributed.parallel_step import DistributedTrainStep
from . import TrainStep

__all__ = ["HybridTrainStep"]


class HybridTrainStep(DistributedTrainStep, TrainStep):
    """loss_fn(model, *batch) -> scalar loss, typically
    `lambda m, ids: m.loss(ids)` over a `PipelinedGPTForCausalLM`.
    config: an optional `hybrid3d.Hybrid3DConfig` (its ZeRO level and
    axis; it rides into `describe()`). `donate_params` is taken for
    TrainStep's signature: the update runs in place, as
    DistributedTrainStep's does."""

    _steptrace_family = "hybrid3d"

    def __init__(self, model, loss_fn, optimizer, config=None,
                 donate_params=True, remat=False, quant_allreduce=None):
        from ..distributed.quant_collective import xla_quant_enabled

        if quant_allreduce is None:
            quant_allreduce = getattr(config, "quant_allreduce", None)
        if quant_allreduce is None:
            quant_allreduce = xla_quant_enabled()
        self.config = config
        self.donate_params = donate_params
        zero = getattr(config, "zero", None)
        self._zero_axis = getattr(config, "zero_axis", "dp")
        storage = getattr(model, "_storage_axis", None)
        if storage and not zero:
            zero, self._zero_axis = "p_g_os", storage
        super().__init__(model, loss_fn, optimizer, zero_level=zero,
                         remat=remat, quant_allreduce=bool(quant_allreduce))

    # ---- layout: the batch enters whole, the gradients average over dp
    def _batch_axes(self):
        return ("dp",)

    def _quant_axis_names(self):
        return ("dp",)

    def _validate_quant_path(self):
        """Only dp is quantized: each rank's mp / pp / ep shards stay its
        own, so sharded parameters are the normal case here."""

    def _slice_batch(self, batch):
        return list(batch)

    def describe(self):
        """Mesh / config stamp for records and telemetry."""
        out = {"mesh": {a: int(s) for a, s in
                        mesh_mod.global_mesh().shape.items()
                        if s > 1 or a in ("dp", "pp", "mp")}}
        if self.config is not None:
            out.update(self.config.describe())
        return out

    # ---- the Checkpointer's hooks, in logical coordinates ----
    def _logical(self, name):
        """(logical shape, this rank's index ranges, slices) of parameter
        `name` of a layout-aware model; None for any other."""
        from ..convert import pipelined_slices

        m = self.model
        shapes = m.logical_shapes() if hasattr(m, "layout") else {}
        if name not in shapes:
            return None
        pp, mp, stage, r, V = m.layout()
        ep, ep_rank = m.expert_layout() if hasattr(
            m, "expert_layout") else (1, 0)
        if V > 1:
            raise NotImplementedError(
                "checkpointing an interleaved (n_virtual > 1) pipelined "
                "model: a stage's rows are not one block of the stack")
        shape = shapes[name]
        sl = pipelined_slices(name, shape, m.config.num_layers, pp, mp,
                              stage, r, V, ep, ep_rank)
        index = [[s.start or 0, n if s.stop is None else s.stop]
                 for s, n in zip(sl, shape)]
        return shape, index, sl

    def _lift(self, name, v):
        """A value of parameter `name`'s local shape (or a LocalShard of
        it) as a LocalShard of the logical array."""
        lg = self._logical(name)
        if lg is None:
            return v
        shape, index, _ = lg
        # the sp ranks hold identical shards: sp rank 0 writes them
        write = mesh_mod.axis_index("sp") == 0
        if isinstance(v, LocalShard):
            idx = [[a + s, b + s] for (a, b), (s, _) in zip(v.index, index)]
            return LocalShard(v.tensor, shape, idx, write and v.write)
        if v.dim() != len(shape):
            # a per-parameter scalar state: its holders write it whole
            # (rank 0 may hold no copy of this parameter)
            return LocalShard(v.detach(), tuple(v.shape),
                              [[0, n] for n in v.shape], write)
        return LocalShard(v.detach(), shape, index, write)

    def _lower(self, name, full):
        """This rank's slice of a logical array."""
        lg = self._logical(name)
        if lg is None or full.dim() != len(lg[0]):
            return full
        return full[tuple(lg[2])]

    def _checkpoint_model_state(self):
        out = super()._checkpoint_model_state()
        return {n: self._lift(n, v) for n, v in out.items()}

    def _restore_model_state(self, model_sd):
        super()._restore_model_state(
            {n: self._lower(n, v) for n, v in model_sd.items()})

    def _checkpoint_opt_states(self):
        out = super()._checkpoint_opt_states()
        return {n: {k: self._lift(n, v) for k, v in d.items()}
                for n, d in out.items()}

    def _restore_opt_states(self, opt_sd):
        super()._restore_opt_states(
            {n: {k: self._lower(n, v) for k, v in d.items()}
             for n, d in opt_sd.items()})
