"""Weight-stationary tensor-parallel placement of the int8 linears
(counterpart of paddle_tpu/distributed/hybrid3d/tp.py).

The reference annotates `Int8WeightOnlyLinear`'s buffers with
PartitionSpecs and GSPMD places them. The port cuts this rank's share of
the buffers by its ``mp`` coordinate:

* column: `weight_q` [in, out/tp], `w_step` [1, out/tp] and the bias's
  columns — each rank holds its output channels with their dequant
  scales, so dequant needs no collective; a whole layer's output is
  all-gathered (a ColumnParallelLinear's `gather_output` decides);
* row: `weight_q` [in/tp, out] with the whole `w_step` — the int32 →
  float product of a row shard is a partial sum, all-reduced through
  `allreduce_mp`, then the bias is added once; a whole layer's input is
  split first.

A layer keeps its semantics under either placement, so `auto` (column
where out divides, else row, else none) is always safe. The W8A8 GEMM
quantizes the activation per row of what it is given: on a row shard
that is the row's local slice, finer than the whole row's scale.
"""
import torch

from .. import mesh as mesh_mod
from ..mesh import PartitionSpec as P

__all__ = ["shard_int8_linear", "shard_model_int8_tp", "tp_axis",
           "column_parallel_spec", "row_parallel_spec",
           "int8_tp_placement"]

TP_AXIS = "mp"


def tp_axis():
    """The mesh axis tensor parallelism rides ('mp')."""
    return TP_AXIS


def column_parallel_spec(ndim, out_dim=-1, axis=TP_AXIS):
    """Spec sharding the OUTPUT-channel dim."""
    out_dim = out_dim % ndim
    return P(*[axis if d == out_dim else None for d in range(ndim)])


def row_parallel_spec(ndim, in_dim=0, axis=TP_AXIS):
    """Spec sharding the INPUT dim."""
    in_dim = in_dim % ndim
    return P(*[axis if d == in_dim else None for d in range(ndim)])


def _cut(t, dim, pos, n):
    c = t.shape[dim] // n
    return t.narrow(dim, pos * c, c).clone()


def shard_int8_linear(layer, kind="auto", axis=TP_AXIS):
    """Cut one whole `Int8WeightOnlyLinear`'s buffers to this rank's
    share over `axis`. kind: 'column' | 'row' | 'auto' (column when out
    divides the axis size, else row when in does, else the layer stays
    whole). Returns the placement applied: 'column' | 'row' | None. A
    layer that is already a shard keeps its placement."""
    n = mesh_mod.axis_size(axis)
    if n <= 1:
        return None
    if layer.tp_placement is not None:
        return layer.tp_placement
    if layer.int4:
        raise ValueError("int4 weights stay replicated (the reference "
                         "shards the int8 path only)")
    out_f, in_f = int(layer.out_features), int(layer.in_features)
    want = kind
    if kind == "auto":
        want = ("column" if out_f % n == 0
                else ("row" if in_f % n == 0 else None))
    pos = mesh_mod.axis_index(axis)
    if want == "column":
        if out_f % n:
            raise ValueError(
                f"out_features={out_f} not divisible by {axis}={n}")
        layer.weight_q = _cut(layer.weight_q, 1, pos, n)
        layer.w_step = _cut(layer.w_step, 1, pos, n)
        if layer.bias is not None:
            layer.bias = torch.nn.Parameter(
                _cut(layer.bias.detach(), 0, pos, n),
                requires_grad=False)
        layer.out_features = out_f // n
        layer.gather_output = True
    elif want == "row":
        if in_f % n:
            raise ValueError(
                f"in_features={in_f} not divisible by {axis}={n}")
        layer.weight_q = _cut(layer.weight_q, 0, pos, n)
        layer.in_features = in_f // n
        layer.input_is_parallel = False
    elif want is not None:
        raise ValueError(f"kind={kind!r}: expected column/row/auto")
    layer.tp_placement = want
    layer._gemm_weight = None
    return want


def shard_model_int8_tp(model, rules=None, axis=TP_AXIS):
    """TP-shard every `Int8WeightOnlyLinear` of `model` over `axis`.
    rules: optional {substring: 'column' | 'row'} matched against the
    sublayer path (first hit wins); unmatched layers use 'auto'. Returns
    {path: placement}."""
    from ...quantization.runtime import Int8WeightOnlyLinear

    placed = {}
    if mesh_mod.axis_size(axis) <= 1:
        return placed
    for path, sub in model.named_modules():
        if not isinstance(sub, Int8WeightOnlyLinear):
            continue
        kind = "auto"
        for pat, k in (rules or {}).items():
            if pat in path:
                kind = k
                break
        placed[path] = shard_int8_linear(sub, kind, axis)
    return placed


def int8_tp_placement(layer):
    """Where a quantized linear's buffers live: 'column', 'row' or
    'replicated'."""
    return getattr(layer, "tp_placement", None) or "replicated"
