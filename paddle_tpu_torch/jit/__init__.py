"""Train steps (counterpart of paddle_tpu/jit, `TrainStep` at
jit/__init__.py:440).

The reference compiles loss + backward + optimizer update into one XLA
program over the parameter pytree. PyTorch runs eagerly, so the port's
`TrainStep` is one eager step per call: clear the gradients, run
`loss_fn(model, *batch)` under the step's dropout generator, backward,
and the optimizer update applied to the parameters in place (the port's
counterpart of donating them). The update is the compiled step's
(`Optimizer._train_step_update`): `grad_clip` spans every parameter at
once, not each param group on its own as the eager `step()` does.

Telemetry is the reference's (:614-737): each step's phases are stamped
into `observability.steptrace` (`h2d` once the batch is on the device,
`dispatch` once forward, backward and update are enqueued, `device_step`
after a `torch.cuda.synchronize` taken only when steptrace is active,
`opt_publish`); a step with a new batch signature runs quiet, and
signatures past the first fire the recompile sentinel; the metrics
`pt_train_step_seconds`, `pt_train_steps_total` and
`pt_train_compiles_total` (here: new batch signatures), and in full mode
`pt_train_loss` and `pt_train_grad_norm` (the f32 global L2 norm of the
raw gradients, before any clipping, as the reference's aux output). The
plane only observes the step: losses are bit-identical in every mode.
An armed `profiler.benchmark()` ips meter is fed once a step (the
batch's leading size, and the steptrace wall when the phase plane is on
and the step is not quiet), as the reference's (:725-733). Batch tensors
that lie off the parameters' device (a DataLoader's CPU tensors) are
moved there first.

Batch norm's running statistics are updated in place by the forward,
once a step: under `remat` the recompute in backward skips the update
(`core.recompute`), as the reference's step writes its frozen state back
once whatever `jax.checkpoint` recomputes.

`HybridTrainStep` (hybrid_step.py) is the DP × TP × PP step over the
process mesh.

Capture and deployment (reference :63-436, :786-862):

* `to_static` wraps a function or a Layer's forward in a
  `StaticFunction`. The reference jit-compiles one program per input
  signature; the port runs the AutoGraph-converted function
  (`autograph.py`) eagerly, and keeps the reference's cache key — the
  signature, the bound layer, grad mode, `training` and the closure's
  layer modes — for `concrete_program`. Python side effects therefore
  run on every call (once per trace in the reference), and a dropout
  draw comes from the port's generators, not from a per-call jax key.
* `save` exports the layer's eval forward as a pure function of
  (parameters, inputs) with `torch.export.export(..., strict=False)`
  and writes `<prefix>.pt2` (`torch.export.save`; the reference writes
  `.stablehlo`) and `<prefix>.pdiparams` (`names`, `params` as numpy,
  `n_inputs`, and the port's `dtypes` / `input_specs`: a bf16 parameter
  is stored as its uint16 bit pattern). A None / -1 dim is exported
  at 1, so a loaded artifact takes only the shapes it was saved at.
  Tensor-dependent control flow converted by AutoGraph becomes
  `torch.cond` / `while_loop` / `scan` in the program, and the flash
  attention kernels are custom ops (ops/cuda_kernels/flash_attention.py)
  that the program records as such.
* `load` gives a `TranslatedLayer` on the card (or the device asked
  for); the artifact formats of the two packages do not cross.
"""
import functools
import os
import time
import warnings

import numpy as np
import torch

from ..core import rng
from ..observability import metrics as _obs
from ..observability import steptrace as _steptrace
from ..observability.tracing import trace_span as _trace_span
from ..profiler import benchmark as _benchmark

__all__ = ["to_static", "not_to_static", "save", "load", "TranslatedLayer",
           "InputSpec", "TrainStep", "ignore_module", "enable_to_static",
           "ProgramTranslator", "TracedLayer", "set_verbosity",
           "set_code_level", "dy2static", "HybridTrainStep"]

# runtime telemetry, under the reference's metric names
_STEP_SECONDS = _obs.histogram(
    "pt_train_step_seconds", "compiled train-step wall time")
_STEPS_TOTAL = _obs.counter(
    "pt_train_steps_total", "compiled train steps dispatched")
_COMPILES_TOTAL = _obs.counter(
    "pt_train_compiles_total",
    "distinct TrainStep batch signatures seen — each is one XLA "
    "compile; growth after warmup is recompile churn")
_LOSS_GAUGE = _obs.gauge(
    "pt_train_loss", "last loss (full telemetry only: syncs the device)")
_GRAD_NORM = _obs.histogram(
    "pt_train_grad_norm",
    "global grad L2 norm per step (full telemetry only)",
    buckets=(0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
             100.0, 300.0, 1000.0))


class TrainStep:
    """loss_fn(model, *batch) -> scalar loss tensor. Each call takes one
    optimizer step and returns the loss (detached).

    remat: False → off; True → recompute the whole loss function in
    backward (keep nothing); a policy name (`dots_saveable`, ...) or a
    torch SAC policy → what `fleet.recompute.checkpoint_policy` maps it
    to. donate_params=False keeps the tensors that held the parameters
    before a step unchanged (each step writes the update into fresh
    storage)."""

    def __init__(self, model, loss_fn, optimizer, donate_params=True,
                 remat=False):
        # distributed/ imports this module: load the recompute on use
        from ..distributed.fleet.recompute import checkpoint_policy

        self._policy = checkpoint_policy(remat)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate_params = donate_params
        self.remat = remat
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._batch_signatures = set()
        self._sig_warned = False
        self.max_batch_signatures = 8
        # the previous step's last stamp: the next step's data_wait anchor
        self._steptrace_prev_end = None

    @property
    def num_batch_signatures(self):
        """Distinct batch (shape, dtype) signatures seen."""
        return len(self._batch_signatures)

    def _loss(self, batch):
        from ..distributed.fleet.recompute import run_with_policy

        if not self.remat:
            return self.loss_fn(self.model, *batch)
        return run_with_policy(lambda *b: self.loss_fn(self.model, *b),
                               batch, self._policy)

    def _note_signature(self, batch):
        """True when `batch` has a new signature (the step runs quiet)."""
        sig = tuple((tuple(b.shape), str(b.dtype)) for b in batch)
        if sig in self._batch_signatures:
            return False
        self._batch_signatures.add(sig)
        _COMPILES_TOTAL.inc()
        if len(self._batch_signatures) > 1:
            _steptrace.note_recompile(
                "train", step=int(self.optimizer._step_count),
                signatures=len(self._batch_signatures), batch_sig=repr(sig))
        if (len(self._batch_signatures) == self.max_batch_signatures + 1
                and not self._sig_warned):
            self._sig_warned = True
            warnings.warn(
                f"TrainStep has now seen {len(self._batch_signatures)} "
                "distinct batch shapes; variable-length data should be "
                "bucketed to a few padded lengths.",
                RuntimeWarning, stacklevel=3)
        return True

    def __call__(self, *batch):
        t_entry = _steptrace.now()
        device = self._params[0].device
        batch = [b.to(device, non_blocking=True)
                 if isinstance(b, torch.Tensor)
                 else torch.as_tensor(np.asarray(b), device=device)
                 for b in batch]
        t_h2d = _steptrace.now()
        quiet = self._note_signature(batch)
        full = _obs._STATE.mode >= _obs._STATE.FULL
        step_idx = int(self.optimizer._step_count)
        tr = _steptrace.begin_step("train", step_idx,
                                   prev_end=self._steptrace_prev_end,
                                   quiet=quiet, t_entry=t_entry)
        tr.stamp("h2d", t_h2d)
        _steptrace.chaos_fire("step.dispatch")
        t0 = time.perf_counter()
        grad_norm = None
        with _trace_span("jit.TrainStep", step=step_idx):
            self.optimizer.clear_grad()
            with rng.generator_scope(rng.next_generator(device)):
                loss = self._loss(batch)
            loss.backward()
            for p in self._params:
                # the compiled reference step updates every trainable leaf
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if not self.donate_params:
                    p.data = p.data.clone()
            if full:
                # the raw gradients' global norm, before any clipping
                grad_norm = torch.sqrt(sum(
                    (p.grad.float() ** 2).sum() for p in self._params))
            self.optimizer._train_step_update(self._params)
        tr.stamp("dispatch")
        if _steptrace.active():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tr.stamp("device_step")
        _STEP_SECONDS.observe(time.perf_counter() - t0)
        _STEPS_TOTAL.inc()
        loss = loss.detach()
        if grad_norm is not None:
            # full telemetry accepts the device sync these reads force
            _LOSS_GAUGE.set(float(loss))
            _GRAD_NORM.observe(float(grad_norm))
        tr.stamp("opt_publish")
        total_s, self._steptrace_prev_end = _steptrace.end_step(tr)
        bm = _benchmark()
        if bm.enabled:
            n = batch[0].shape[0] if batch and batch[0].dim() else None
            # the steptrace wall, so the meter and the phase plane report
            # one number; quiet steps keep the meter's own clock
            bm.auto_step(num_samples=n,
                         dt=(total_s if _steptrace.active()
                             and not tr.quiet else None))
        return loss


# ------------------------------------------------------------- to_static
_to_static_enabled = True


def enable_to_static(flag):
    global _to_static_enabled
    _to_static_enabled = bool(flag)


class InputSpec:
    """(reference: python/paddle/static/input_spec.py). `dtype` is a
    torch dtype; a None dim is kept as -1."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        from ..core.dtype import convert_dtype

        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)


def _sig_of(value):
    if isinstance(value, torch.Tensor):
        return ("T", tuple(value.shape), str(value.dtype),
                not value.requires_grad)
    if isinstance(value, (list, tuple)):
        return (type(value).__name__,) + tuple(_sig_of(v) for v in value)
    if isinstance(value, dict):
        return ("dict",) + tuple(
            (k, _sig_of(v)) for k, v in sorted(value.items()))
    return ("py", value if isinstance(value, (int, float, str, bool,
                                              type(None))) else id(value))


def _closure_modes(fn):
    """training flags of Layers a standalone @to_static function closes
    over (direct closure cells only), part of the cache key as in the
    reference."""
    out = []
    f = getattr(fn, "__func__", fn)
    for cell in getattr(f, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        tr = getattr(v, "training", None)
        if isinstance(tr, bool):
            out.append(tr)
    return tuple(out)


class StaticFunction:
    """The AutoGraph-converted function, run eagerly, with the
    reference's per-signature cache: each distinct key (signature,
    bound layer, grad mode, `training`, closure modes) records one
    entry, the port's stand-in for one compiled program."""

    def __init__(self, fn, input_spec=None):
        self._fn = fn
        self._input_spec = input_spec
        self._cache = {}
        self._last_concrete = None
        functools.update_wrapper(self, fn)

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return functools.partial(self.__call__, instance)

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            return self._fn(*args, **kwargs)
        from . import autograph

        bound_self = None
        if args and isinstance(args[0], torch.nn.Module):
            bound_self, args = args[0], args[1:]
        key = (_sig_of((args, kwargs)), id(bound_self),
               torch.is_grad_enabled(),
               getattr(bound_self, "training", None),
               _closure_modes(self._fn))
        fn = self._cache.get(key)
        if fn is None:
            fn = autograph.maybe_convert(self._fn)
            self._cache[key] = fn
        self._last_concrete = fn
        if bound_self is not None:
            return fn(bound_self, *args, **kwargs)
        return fn(*args, **kwargs)

    @property
    def concrete_program(self):
        return self._last_concrete

    def get_traced(self, *example_args, **example_kwargs):
        """(converted fn, flat example tensors). The reference's traced
        function takes a PRNG key first; the port's draws come from its
        generators, so there is none."""
        from . import autograph

        flat = [a for a in list(example_args) + list(example_kwargs.values())
                if isinstance(a, torch.Tensor)]
        return autograph.maybe_convert(self._fn), flat


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator (reference API: paddle.jit.to_static)."""

    def deco(fn):
        if isinstance(fn, StaticFunction):
            return fn
        if isinstance(fn, torch.nn.Module):
            layer = fn
            sf = StaticFunction(type(layer).forward, input_spec)
            layer.forward = functools.partial(sf.__call__, layer)
            layer._static_function = sf
            return layer
        return StaticFunction(fn, input_spec)

    if function is not None:
        return deco(function)
    return deco


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


# ---------------------------------------------------------------- save/load
class _PureForward(torch.nn.Module):
    """fn(params, *inputs) = layer(*inputs) with its state replaced by
    `params`. The layer is held outside the module tree, so the export
    lifts no state of its own: the program's parameters are inputs."""

    def __init__(self, layer, names):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        self._names = list(names)

    def forward(self, params, *inputs):
        return torch.func.functional_call(
            self._layer, dict(zip(self._names, params)), inputs)


def _np_param(t):
    """(numpy array, dtype name): bf16 as its uint16 bit pattern (numpy
    has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    return t.numpy().copy(), str(t.dtype).replace("torch.", "")


def _torch_param(arr, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _retarget(program, device):
    """Move a loaded program to `device`: its constants, and the device
    every op that creates a tensor was traced with (an artifact exported
    on one device runs on another)."""
    program.to(device)
    for mod in program.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            if isinstance(node.kwargs.get("device"), torch.device):
                node.update_kwarg("device", device)
            if any(isinstance(a, torch.device) for a in node.args):
                node.args = tuple(device if isinstance(a, torch.device)
                                  else a for a in node.args)
        mod.recompile()
    return program


def _export(module, example, path):
    with torch.no_grad():
        ep = torch.export.export(module, example, strict=False)
    # AutoGraph's shape probes of an arm or a loop body leave unused
    # nodes behind; they would run at every call
    for mod in ep.graph_module.modules():
        if isinstance(mod, torch.fx.GraphModule):
            mod.graph.eliminate_dead_code()
            mod.recompile()
    # the example inputs are the parameters: `torch.export.save` would
    # write them a second time beside `.pdiparams`
    ep.example_inputs = None
    torch.export.save(ep, path + ".pt2")
    return ep


def save(layer, path, input_spec=None, **configs):
    """Export `layer`'s eval forward at `input_spec` to `<path>.pt2` +
    `<path>.pdiparams` (reference: paddle.jit.save; module docstring)."""
    from ..framework.io_state import save as tensor_save

    if input_spec is None:
        raise ValueError("input_spec is required for jit.save")
    was_training = layer.training
    layer.eval()
    try:
        state = layer.state_dict(keep_vars=True)
        names = list(state)
        params = tuple(state[n].detach() for n in names)
        device = params[0].device if params else torch.device("cpu")
        shapes = [tuple(1 if s in (-1, None) else int(s) for s in sp.shape)
                  for sp in input_spec]
        dtypes = [InputSpec(sp.shape, sp.dtype).dtype for sp in input_spec]
        inputs = [torch.zeros(sh, dtype=dt, device=device)
                  for sh, dt in zip(shapes, dtypes)]
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _export(_PureForward(layer, names), (params, *inputs), path)
        packed = [_np_param(p) for p in params]
        tensor_save({"names": names, "params": [a for a, _ in packed],
                     "dtypes": [t for _, t in packed],
                     "n_inputs": len(input_spec),
                     "input_specs": [(list(sh), str(dt).replace("torch.", ""))
                                     for sh, dt in zip(shapes, dtypes)]},
                    path + ".pdiparams")
    finally:
        if was_training:
            layer.train()


class TranslatedLayer:
    """Inference-only loaded program (reference: paddle.jit.load →
    TranslatedLayer). `set_compiler_options` keeps the options it is
    given: there is no XLA compile for them to reach."""

    def __init__(self, exported, names, param_vals, n_inputs=None,
                 input_specs=None, device="cpu"):
        self._exported = exported
        self._names = list(names)
        self._param_vals = list(param_vals)
        self._n_inputs = n_inputs
        self._input_specs = input_specs or []
        self._compiler_options = None
        self.training = False
        self._device = None
        self._place(torch.device(device))

    def _place(self, device):
        """Parameters and program onto `device` (no copy where they are
        there already)."""
        if device == self._device:
            return self
        self._param_vals = [p.to(device) for p in self._param_vals]
        self._program = _retarget(self._exported.module(), device)
        self._device = device
        return self

    def set_compiler_options(self, options):
        self._compiler_options = dict(options) if options else None
        return self

    def _check_inputs(self, vals):
        for i, (v, (shape, dtype)) in enumerate(zip(vals,
                                                    self._input_specs)):
            if tuple(v.shape) != tuple(shape) or \
                    str(v.dtype).replace("torch.", "") != dtype:
                raise ValueError(
                    f"input {i} has shape {tuple(v.shape)}/{v.dtype} but "
                    f"the program was saved at {tuple(shape)}/{dtype}; "
                    "jit.save again for another shape")

    def __call__(self, *inputs):
        vals = [torch.as_tensor(x if isinstance(x, torch.Tensor)
                                else np.asarray(x)).to(self._device)
                for x in inputs]
        self._check_inputs(vals)
        with torch.no_grad():
            out = self._program(tuple(self._param_vals), *vals)
        if isinstance(out, (list, tuple)):
            return list(out) if len(out) > 1 else out[0]
        return out

    forward = __call__

    def eval(self):
        return self

    def state_dict(self):
        return dict(zip(self._names, self._param_vals))


def load(path, device=None, **configs):
    """A `TranslatedLayer` on `device` (default: the card) from
    `<path>.pt2` + `<path>.pdiparams`."""
    from ..core.place import resolve_device
    from ..framework.io_state import load as tensor_load

    if not os.path.exists(path + ".pt2"):
        if os.path.exists(path + ".stablehlo"):
            raise ValueError(
                f"{path}.stablehlo is an artifact of the JAX package "
                "(a StableHLO export), which the port cannot load; save "
                "the layer with paddle_tpu_torch.jit.save")
        raise FileNotFoundError(f"{path}.pt2 not found")
    dev = resolve_device(device)
    exported = torch.export.load(path + ".pt2")
    bundle = tensor_load(path + ".pdiparams", return_numpy=True)
    dtypes = bundle.get("dtypes") or [None] * len(bundle["params"])
    params = [_torch_param(a, t) for a, t in zip(bundle["params"], dtypes)]
    return TranslatedLayer(exported, bundle["names"], params,
                           n_inputs=bundle.get("n_inputs"),
                           input_specs=bundle.get("input_specs"),
                           device=dev)


class ProgramTranslator:
    """Global dy2static switch (reference:
    fluid/dygraph/dygraph_to_static/program_translator.py): gates
    whether to_static functions convert or run as written."""

    _instance = None

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.enable_to_static = True

    def enable(self, enable_to_static):
        self.enable_to_static = bool(enable_to_static)
        enable_to_static_fn = globals().get("enable_to_static")
        if enable_to_static_fn is not None:
            enable_to_static_fn(bool(enable_to_static))


class TracedLayer:
    """dygraph→traced wrapper (reference: fluid/dygraph/jit.py
    TracedLayer): trace() is to_static capture; save_inference_model
    delegates to jit.save."""

    def __init__(self, static_fn, layer):
        self._fn = static_fn
        self._layer = layer

    @staticmethod
    def trace(layer, inputs):
        fn = to_static(layer.forward)
        outs = fn(*inputs)
        return outs, TracedLayer(fn, layer)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def save_inference_model(self, path, feed=None, fetch=None, **configs):
        return save(self._layer, path, **configs)


_log_verbosity = 0
_code_level = 0


def set_verbosity(level=0, also_to_stdout=False):
    """dy2static debug verbosity (reference: jit/api set_verbosity): the
    level is recorded for tooling."""
    global _log_verbosity
    _log_verbosity = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """(reference: jit/api set_code_level) — records the requested
    level."""
    global _code_level
    _code_level = int(level)


class _Dy2StaticNamespace:
    """paddle.jit.dy2static compatibility surface."""

    ProgramTranslator = ProgramTranslator
    set_verbosity = staticmethod(set_verbosity)
    set_code_level = staticmethod(set_code_level)


dy2static = _Dy2StaticNamespace()


def __getattr__(name):
    # HybridTrainStep reaches into distributed/, which imports this
    # module: load it on first use
    if name == "HybridTrainStep":
        from .hybrid_step import HybridTrainStep

        return HybridTrainStep
    raise AttributeError(name)
