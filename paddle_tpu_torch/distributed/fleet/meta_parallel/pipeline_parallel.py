"""Pipeline-parallel execution of a layer stack (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py).

`PipelineParallel` wraps a layer (typically a `PipelineLayer`) with the
reference's `train_batch` / `eval_batch`. On one stage it is gradient
accumulation over `accumulate_steps` micro-batches, as in the
reference. When the layer is a `PipelineLayer` built across a pp mesh
(one process per stage), `train_batch` runs the micro-batches through
the 1F1B schedule (`pipeline_1f1b`, the stage's layers applied
functionally over their parameters, the layer's `loss_fn` on the last
stage), sums the shared weights' gradients over the stages holding
them, and steps; `eval_batch` runs the forward-only fill-drain.

`spmd_pipeline(block_fn, stacked_params, x_micro)` is the reference's
fill-drain over the pp axis as one differentiable call: every stage
returns the last stage's outputs; the backward drains the cotangents in
reverse (GPipe order) with the stage recomputed from its kept input.
"""
import numpy as np
import torch
from torch.utils import _pytree as pytree

from .pipeline_1f1b import (_TAG_BWD, _TAG_FWD, _recv, _send, fill_drain,
                            last_stage_shape, pipeline_1f1b,
                            pipeline_forward_loss, pp_world)

__all__ = ["PipelineParallel", "spmd_pipeline"]


class PipelineParallel:
    """Micro-batched `train_batch` / `eval_batch` around a layer."""

    def __init__(self, layers, hcg=None, strategy=None):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", None)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _staged(self):
        return bool(getattr(self._layers, "_distributed", False))

    def _stage_fns(self):
        layers = self._layers
        loss_fn = getattr(layers, "loss_fn", None)

        def block_fn(params, x):
            return torch.func.functional_call(layers, params, (x,))

        def head(out, y, post):
            loss = loss_fn(out, y) if loss_fn is not None else out.mean()
            return loss.mean() if loss.dim() > 0 else loss

        return block_fn, head, dict(layers.named_parameters())

    def _micro(self, t, n):
        return torch.stack(torch.chunk(t, n, dim=0)) if n > 1 else t[None]

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Forward and backward over the micro-batches, then one
        optimizer step; returns the mean micro-batch loss."""
        x, y = data
        n = self.accumulate_steps
        if self._staged():
            block_fn, head, params = self._stage_fns()
            loss = pipeline_1f1b(block_fn, head, params, {},
                                 (self._micro(x, n), self._micro(y, n)),
                                 remat=False)
            (scaler.scale(loss) if scaler is not None else loss).backward()
            self._layers.allreduce_shared_weight_gradients()
            total = float(loss.detach())
        else:
            xs = torch.chunk(x, n, dim=0) if n > 1 else [x]
            ys = torch.chunk(y, n, dim=0) if n > 1 else [y]
            loss_fn = getattr(self._layers, "loss_fn", None)
            total = 0.0
            for xm, ym in zip(xs, ys):
                out = self._layers(xm)
                loss = loss_fn(out, ym) if loss_fn is not None \
                    else out.mean()
                if loss.dim() > 0:
                    loss = loss.mean()
                scaled = loss * (1.0 / n)
                (scaler.scale(scaled) if scaler is not None
                 else scaled).backward()
                total += float(loss.detach())
            total /= n
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.tensor(np.float32(total))

    def eval_batch(self, data, compute_loss=True):
        """The forward (and the loss): across stages the fill-drain, the
        mean micro loss on every stage, or the last stage's outputs
        (None on the others) without `compute_loss`."""
        x, y = data
        if not self._staged():
            out = self._layers(x)
            loss_fn = getattr(self._layers, "loss_fn", None)
            if compute_loss and loss_fn is not None:
                return loss_fn(out, y)
            return out
        block_fn, head, params = self._stage_fns()
        n = self.accumulate_steps
        with torch.no_grad():
            if compute_loss:
                return pipeline_forward_loss(
                    block_fn, head, params, {},
                    (self._micro(x, n), self._micro(y, n)))
            pp, stage, members = pp_world()
            outs = fill_drain(block_fn, params, self._micro(x, n), stage,
                              pp, members)
            return None if outs is None else torch.cat(outs)


class _SpmdPipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_fn, n_params, x_micro, *flat):
        from .mp_ops import all_reduce_mp_raw

        pp, stage, members = pp_world()
        params = list(flat)
        ctx.block_fn, ctx.params = block_fn, params
        ctx.stage, ctx.pp, ctx.members = stage, pp, members
        M = x_micro.shape[0]
        nxt, prv = members[(stage + 1) % pp], members[(stage - 1) % pp]
        saved = []
        outs = None
        for t in range(M + pp - 1):
            m = t - stage
            if not 0 <= m < M:
                continue
            x_in = x_micro[m] if stage == 0 else _recv(prv, _TAG_FWD,
                                                       x_micro.device)
            saved.append(x_in)
            out = block_fn(params, x_in)
            if stage == pp - 1:
                outs = out[None] if outs is None else torch.cat(
                    [outs, out[None]])
            else:
                _send(out, nxt, _TAG_FWD)
        ctx.saved_inputs = saved
        ctx.x_like = x_micro
        shape = last_stage_shape((M,) + tuple(out.shape)
                                 if stage == pp - 1 else None)
        if outs is None:
            outs = torch.zeros(shape, dtype=x_micro.dtype,
                               device=x_micro.device)
        return all_reduce_mp_raw(outs, axis="pp", kind="pp_outputs")

    @staticmethod
    def backward(ctx, g):
        from .mp_ops import all_reduce_mp_raw

        stage, pp, members = ctx.stage, ctx.pp, ctx.members
        nxt, prv = members[(stage + 1) % pp], members[(stage - 1) % pp]
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in ctx.params]
        M = len(ctx.saved_inputs)
        dxs = torch.zeros_like(ctx.x_like)
        for m in reversed(range(M)):
            x_leaf = ctx.saved_inputs[m].detach().requires_grad_()
            with torch.enable_grad():
                out = ctx.block_fn(params, x_leaf)
                # the outputs are the last stage's, broadcast: its own
                # copy's cotangent drives the drain (every stage holds
                # the same one)
                cot = g[m] if stage == pp - 1 else _recv(
                    nxt, _TAG_BWD, g.device)
                torch.autograd.backward(out, cot)
            dx = x_leaf.grad if x_leaf.grad is not None else \
                torch.zeros_like(x_leaf)
            if stage == 0:
                dxs[m] = dx
            else:
                _send(dx, prv, _TAG_BWD)
        dxs = all_reduce_mp_raw(dxs, axis="pp", kind="pp_outputs")
        ctx.saved_inputs = None
        return (None, None, dxs, *[p.grad for p in params])


def spmd_pipeline(block_fn, stacked_params, x_micro, *, n_stages=None,
                  remat=True):
    """Fill-drain pipeline over the pp axis. block_fn(stage_params, x)
    -> y is one stage; stacked_params is this stage's pytree; x_micro
    [M, ...] (read on stage 0). Returns [M, ...] outputs of the last
    stage on every stage, differentiable w.r.t. the stage's parameters
    and x_micro. At pp 1 the stage over each micro-batch."""
    pp = pp_world()[0]
    if pp == 1:
        return torch.stack([block_fn(stacked_params, x) for x in x_micro])
    leaves, tdef = pytree.tree_flatten(stacked_params)

    def fn(flat, x):
        return block_fn(pytree.tree_unflatten(flat, tdef), x)

    return _SpmdPipeline.apply(fn, len(leaves), x_micro, *leaves)
