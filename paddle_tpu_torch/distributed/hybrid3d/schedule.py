"""The GPipe micro-batch schedule (counterpart of
paddle_tpu/distributed/hybrid3d/schedule.py).

The sibling of the 1F1B schedule (`fleet.meta_parallel.pipeline_1f1b`),
run by the same per-stage runtime — one process per stage, activations
and cotangents over p2p, the backward hand-scheduled from each stage's
kept inputs — on GPipe's two serialized halves:

    forward  : stage s forwards micro m at tick  t = m + s
    backward : stage s backwards micro m at tick Tf + (M−1−m) + (pp−1−s)

with Tf = M + pp − 1, so the step is `gpipe_ticks` = 2(M + pp − 1) ticks
against 1F1B's M + 2(pp − 1), and every stage keeps all M micro inputs
(or graphs, without remat) across the halves: O(M) activations against
1F1B's O(pp). Both schedules share `PipelineSpecs` (the sequence
parallel `sum_axes` included), remat and the degenerate pp == 1 path.
"""
from ..fleet.meta_parallel.pipeline_1f1b import (
    _check_specs, _dp_mean, _pipeline, _straight_line, _sum_axes, pp_world)

__all__ = ["pipeline_gpipe", "gpipe_ticks", "gpipe_table"]


def gpipe_ticks(M, pp):
    """Total ticks of the two serialized GPipe halves."""
    return 2 * (M + pp - 1)


def gpipe_table(M, pp):
    """For each stage, [(tick, forward unit or None, backward unit or
    None)] over `gpipe_ticks(M, pp)` ticks; a unit is (micro, 0)."""
    Tf = M + pp - 1
    table = []
    for s in range(pp):
        rows = []
        for t in range(Tf):
            m = t - s
            rows.append((t, (m, 0) if 0 <= m < M else None, None))
        for t in range(Tf):
            u = t - (pp - 1 - s)
            rows.append((Tf + t, None,
                         (M - 1 - u, 0) if 0 <= u < M else None))
        table.append(rows)
    return table


def pipeline_gpipe(block_fn, loss_fn, stacked_params, post_params, batch,
                   remat=True, specs=None, aux_weight=None, aux_dp=1):
    """Differentiable GPipe pipeline loss: `pipeline_1f1b`'s contract
    (block_fn / loss_fn / stacked / post / batch / specs / aux_weight /
    aux_dp)
    on the all-forward-then-all-backward schedule. No virtual stages:
    interleaving is a 1F1B refinement."""
    sp, seed = _check_specs(specs, aux_weight, aux_dp)
    x_micro, y_micro = batch
    if pp_world()[0] == 1 and not _sum_axes(sp):
        out = _straight_line(block_fn, loss_fn, stacked_params,
                             post_params, x_micro, y_micro, remat, 1,
                             aux_weight, seed)
        return _dp_mean(out, sp.dp_axis)
    return _pipeline(gpipe_table, block_fn, loss_fn, stacked_params,
                     post_params, batch, bool(remat), 1, sp, aux_weight,
                     seed)
