"""Pipeline layer description (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py).

`LayerDesc` / `SharedLayerDesc` describe layers without building them;
`SegmentLayers` cuts the list into stages; `PipelineLayer` builds ONLY
this rank's stage when the mesh's ``pp`` axis has `num_stages`
positions (one process per stage) — on one rank, every layer, run in
order. A `SharedLayerDesc` key that several stages build (the tied
embedding / head) is one weight in one process; across stages each holds
a copy, made equal at construction by a broadcast from the first stage
that holds it, and `allreduce_shared_weight_gradients` sums their
gradients after a backward (the reference's shared-weight all-reduce).
"""
import numpy as np
from torch import nn

from ... import mesh as mesh_mod
from ....nn.layer.layers import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A weight-tied layer that appears in several stages."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Split a layer list into per-stage segments: 'uniform' by count, any
    other method weighted by parameter count (a description counts 1, a
    built layer its parameters in millions, at least 1)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError("number of layers < number of stages")

    def do_segment(self):
        n = len(self.descs)
        if self.method == "uniform":
            return [int(round(i * n / self.num_parts))
                    for i in range(self.num_parts + 1)]
        weights = []
        for d in self.descs:
            if isinstance(d, LayerDesc):
                w = 1
            else:
                w = max(1, sum(int(np.prod(p.shape))
                               for p in getattr(d, "parameters",
                                                lambda: [])())
                        // 1_000_000)
            weights.append(w)
        total = sum(weights)
        bounds = [0]
        acc = 0
        target = total / self.num_parts
        for i, w in enumerate(weights):
            acc += w
            if acc >= target * len(bounds) and len(bounds) < self.num_parts:
                bounds.append(i + 1)
        bounds.append(n)
        while len(bounds) < self.num_parts + 1:
            bounds.insert(-1, bounds[-2])
        return bounds


class PipelineLayer(Layer):
    """Declarative stage list. With the mesh's pp axis of `num_stages`
    positions (in several processes) this rank builds and runs its
    segment only; otherwise every layer, in order."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 **kwargs):
        super().__init__()
        from ..meta_parallel.pipeline_1f1b import pp_world

        self.descs = list(layers)
        self.num_stages = num_stages or (
            topology.get_dim("pipe") if topology else
            mesh_mod.axis_size("pp"))
        self.loss_fn = loss_fn
        self.seg_method = seg_method
        self.recompute_interval = recompute_interval
        self.segments = SegmentLayers(
            self.descs, self.num_stages, seg_method).do_segment()
        pp, stage, _ = pp_world()
        self._distributed = pp > 1 and pp == self.num_stages
        self.stage_id = stage if self._distributed else None
        lo, hi = ((self.segments[stage], self.segments[stage + 1])
                  if self._distributed else (0, len(self.descs)))
        self._shared = {}
        built = []
        for i in range(lo, hi):
            layer = self._build(self.descs[i])
            built.append(layer)
            self.add_module(str(i), layer)
        self.run_function = built
        self._lo = lo
        if self._distributed:
            self._shared_groups = self._sync_shared()

    def _build(self, d):
        if isinstance(d, SharedLayerDesc):
            if d.layer_name in self._shared:
                return _SharedRef(self._shared[d.layer_name],
                                  d.forward_func)
            layer = d.build_layer()
            self._shared[d.layer_name] = layer
            if d.forward_func is not None:
                # a later occurrence built first in this process (the
                # head on the last stage): it owns the weight
                return _SharedRef(layer, d.forward_func, own=True)
            return layer
        if isinstance(d, LayerDesc):
            return d.build_layer()
        if isinstance(d, nn.Module):
            return d
        if callable(d):
            return _FnLayer(d)
        raise TypeError(f"bad pipeline entry {d!r}")

    def _holders(self):
        """{shared key: sorted stages whose segment holds it}."""
        out = {}
        for s in range(self.num_stages):
            for d in self.descs[self.segments[s]:self.segments[s + 1]]:
                if isinstance(d, SharedLayerDesc):
                    out.setdefault(d.layer_name, set()).add(s)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def _shared_weight(self, key):
        d = next(d for d in self.descs if isinstance(d, SharedLayerDesc)
                 and d.layer_name == key)
        return getattr(self._shared[key], d.shared_weight_attr)

    def _sync_shared(self):
        """One group per shared key over the stages that hold it (created
        on every rank, in key order), and the first holder's weight
        broadcast to the others."""
        import torch

        from ... import collective

        groups = {}
        for key, stages in self._holders().items():
            if len(stages) < 2:
                continue
            g = collective.new_group(ranks=stages, axes=("pp",))
            groups[key] = g
            if key in self._shared:
                w = self._shared_weight(key)
                with torch.no_grad():
                    collective.broadcast(w.data, src=stages[0], group=g)
        return groups

    def allreduce_shared_weight_gradients(self):
        """Sum each shared weight's gradient over the stages holding it
        (call after backward, before the optimizer step)."""
        from ... import collective

        for key, g in getattr(self, "_shared_groups", {}).items():
            if key in self._shared:
                w = self._shared_weight(key)
                if w.grad is not None:
                    w.grad = collective.all_reduce(w.grad.clone(), group=g)

    def get_stage_layers(self, stage_id):
        if self._distributed:
            if stage_id != self.stage_id:
                raise ValueError(f"stage {stage_id}'s layers live in "
                                 "another process")
            return self.run_function
        lo, hi = self.segments[stage_id], self.segments[stage_id + 1]
        return self.run_function[lo:hi]

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x


class _FnLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedRef(Layer):
    """An occurrence of a shared layer through its `forward_func`: the
    prototype's parameters (registered here when this occurrence owns
    them, else held in a list, not as a submodule)."""

    def __init__(self, proto, forward_func=None, own=False):
        super().__init__()
        if own:
            self.layer = proto
        self._proto = [proto]
        self._forward_func = forward_func

    def forward(self, *args):
        proto = self._proto[0]
        if self._forward_func is not None:
            return self._forward_func(proto, *args)
        return proto(*args)
