"""paddle_tpu_torch.static — the static-graph facade (counterpart of
paddle_tpu/static/__init__.py; reference python/paddle/static/, the
fluid Program / Executor).

The reference's static mode builds a protobuf program that a C++
interpreter runs; here, as in the JAX package, a `Program` keeps the
python stages recorded under `program_guard` and the placeholders
`static.data` declares:

- `Executor(place).run` runs the stages eagerly on the place's device
  (feeds moved there, and tensors the stages create made there: the
  layers `static.nn` builds land on that device) and fetches the named
  results as numpy arrays;
- `Program.freeze` traces the stages once into an inspectable IR at the
  placeholders' shapes. The reference's IR is a jaxpr; the port's is an
  FX graph made by `make_fx` (fake tensors), with the constants it
  closes over (layer parameters) lifted to leading inputs.
  `ProgramIR.ops` lists aten op names — not jax's primitive names, so
  no test compares names across the packages — `prune` is FX dead-code
  elimination that also drops unused constants and feeds, and `run`
  raises on a feed whose shape or dtype differs from the frozen one.

`save` writes the reference's placeholder file and `load` does nothing;
`save_inference_model` / `load_inference_model` raise and point to
`jit.save` / `jit.load`. The reference's `static.sparsity`
(incubate.asp) is not ported.
"""
import collections
import contextlib
import gc

import numpy as np
import torch

from . import nn  # noqa: F401  (paddle.static.nn.cond / while_loop / ...)
from ..jit import InputSpec  # noqa: F401  (paddle.static.InputSpec)

__all__ = [
    "Program", "ProgramIR", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "InputSpec", "name_scope",
    "save", "load", "save_inference_model", "load_inference_model",
    "gradients", "append_backward", "cpu_places", "device_guard", "scope_guard",
    "global_scope", "amp", "Variable",
]


def _device_of(place):
    """A Place, a device name or None (the current device) → a torch
    device."""
    from ..core.place import Place, current_device, resolve_device

    if place is None:
        return current_device()
    if isinstance(place, Place):
        return place.torch_device()
    name = str(place)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return resolve_device(name)


def _fetch_name(f):
    return f.name if isinstance(f, Variable) else str(f)


class Variable:
    """Static placeholder (≈ VarDesc in framework.proto:191)."""

    def __init__(self, name, shape, dtype, program):
        self.name = name
        self.shape = list(shape)
        self.dtype = dtype
        self._program = program
        self.stop_gradient = True

    def __repr__(self):
        return f"static.Variable(name={self.name}, shape={self.shape})"


class Program:
    """Deferred computation: a list of stages, each a callable over the
    name → tensor environment (≈ ProgramDesc, framework.proto:236)."""

    def __init__(self):
        self.placeholders = {}
        self.stages = []
        self.fetch_map = {}
        self.random_seed = None

    def clone(self, for_test=False):
        """Copy the stage list (reference Program.clone), as the JAX
        package pins it: stages / placeholders / fetch_map are copied so
        later edits to either program don't leak into the other;
        `for_test=True` does NOT strip dropout / BN-train ops — train /
        eval state rides the LAYER objects the stages close over, so
        switch with model.eval() before running a test clone."""
        p = Program()
        p.placeholders = dict(self.placeholders)
        p.stages = list(self.stages)
        p.fetch_map = dict(self.fetch_map)
        p.random_seed = self.random_seed
        return p

    def global_block(self):
        return self

    @property
    def ops(self):
        return self.stages

    def freeze(self, fetch_list, feed_specs=None, batch_size=1, place=None):
        """Trace the stages ONCE into a `ProgramIR` (module docstring).
        Placeholders with None / -1 dims are traced at `batch_size`
        (override per name via feed_specs={name: (shape, dtype)}), on
        `place`'s device (default: the current device). Python side
        effects run once, at freeze time."""
        from torch.fx.experimental.proxy_tensor import make_fx

        from ..core.dtype import convert_dtype

        device = _device_of(place)
        names = list(self.placeholders)
        specs = {}
        for n, v in self.placeholders.items():
            shape = tuple(batch_size if (s is None or s == -1) else int(s)
                          for s in v.shape)
            specs[n] = (shape, v.dtype)
        for n, sd in (feed_specs or {}).items():
            if n not in specs:
                raise KeyError(
                    f"feed_specs name {n!r} is not a declared "
                    f"placeholder (have: {sorted(specs)})")
            specs[n] = (tuple(sd[0]), sd[1])
        fetch_names = [_fetch_name(f) for f in fetch_list]
        stages = list(self.stages)

        def run_fn(*feed_vals):
            env = dict(zip(names, feed_vals))
            for stage in stages:
                stage(env)
            outs = []
            for f in fetch_names:
                if f not in env:
                    raise KeyError(f"fetch target {f!r} not produced")
                outs.append(torch.as_tensor(env[f]))
            return tuple(outs)

        example = [torch.zeros(specs[n][0], dtype=convert_dtype(specs[n][1]),
                               device=device) for n in names]
        with torch.device(device):
            gm = make_fx(run_fn, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*example)
        return ProgramIR._lift(gm, names, fetch_names, device)

    def to_string(self, throw_on_error=False, with_details=False):
        """Printable program summary (reference Program.to_string):
        placeholders + stage count; freeze() gives the op-level text."""
        lines = [f"Program(stages={len(self.stages)})"]
        for n, v in self.placeholders.items():
            lines.append(f"  data {n}: shape={v.shape} dtype={v.dtype}")
        return "\n".join(lines)


class ProgramIR:
    """A frozen program (the port's ProgramDesc — see Program.freeze):
    an FX graph whose inputs are its constants, then its feeds."""

    def __init__(self, gm, consts, feed_names, fetch_names, device):
        self._gm = gm
        self._consts = list(consts)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self._device = device

    @classmethod
    def _lift(cls, gm, feed_names, fetch_names, device):
        """Turn the constants `make_fx` stored as attributes into
        leading placeholders."""
        graph = gm.graph
        first = next(n for n in graph.nodes if n.op == "placeholder")
        consts = []
        for node in list(graph.nodes):
            if node.op != "get_attr":
                continue
            value = getattr(gm, node.target)
            if not isinstance(value, torch.Tensor):
                continue
            with graph.inserting_before(first):
                ph = graph.placeholder(f"const_{len(consts)}")
            ph.meta = dict(node.meta)
            node.replace_all_uses_with(ph)
            graph.erase_node(node)
            consts.append(value.detach())
        # the placeholders just made sit before `first` in creation
        # order: constants lead, feeds follow
        graph.lint()
        return cls(torch.fx.GraphModule(gm, graph), consts, feed_names,
                   fetch_names, device)

    def _placeholders(self):
        return [n for n in self._gm.graph.nodes if n.op == "placeholder"]

    # -- the OpDesc view ------------------------------------------------
    @property
    def ops(self):
        """aten op names in execution order (reference block.ops)."""
        return [str(n.target) for n in self._gm.graph.nodes
                if n.op == "call_function"]

    def op_histogram(self):
        return collections.Counter(self.ops)

    def as_text(self):
        """The printable IR (reference Program.to_string — full desc)."""
        return self._gm.code

    # -- passes ---------------------------------------------------------
    def prune(self, fetch_list):
        """Dead-code-eliminate to a fetch subset (reference
        Program._prune): ops, constants AND feeds that the kept fetches
        don't reach are dropped from the program."""
        targets = [_fetch_name(f) for f in fetch_list]
        missing = [t for t in targets if t not in self.fetch_names]
        if missing:
            raise KeyError(f"prune targets not in fetch set: {missing}")
        keep = set(targets)
        gm = torch.fx.GraphModule(self._gm, self._gm.graph.__deepcopy__())
        graph = gm.graph
        out = next(n for n in graph.nodes if n.op == "output")
        outs = [o for o, name in zip(out.args[0], self.fetch_names)
                if name in keep]
        out.args = (tuple(outs),)
        graph.eliminate_dead_code()
        phs = [n for n in graph.nodes if n.op == "placeholder"]
        nc = len(self._consts)
        consts, feeds = [], []
        for i, ph in enumerate(phs):
            if ph.users:
                if i < nc:
                    consts.append(self._consts[i])
                else:
                    feeds.append(self.feed_names[i - nc])
            else:
                graph.erase_node(ph)
        graph.lint()
        gm.recompile()
        return ProgramIR(gm, consts, feeds,
                         [n for n in self.fetch_names if n in keep],
                         self._device)

    # -- execution ------------------------------------------------------
    def run(self, feed, return_numpy=True):
        """Execute the frozen program on the device it was frozen on."""
        nc = len(self._consts)
        feed_vals = []
        for n, ph in zip(self.feed_names, self._placeholders()[nc:]):
            v = feed[n]
            v = torch.as_tensor(v if isinstance(v, torch.Tensor)
                                else np.asarray(v))
            want = ph.meta["val"]
            if tuple(v.shape) != tuple(want.shape) or v.dtype != want.dtype:
                # shape-derived python values were BAKED IN at freeze
                # time — re-running at another shape would be silently
                # wrong, not just slow (re-freeze for a new signature)
                raise ValueError(
                    f"feed {n!r} has shape {tuple(v.shape)}/{v.dtype} but "
                    f"the program was frozen at {tuple(want.shape)}/"
                    f"{want.dtype}; freeze() again for a new signature")
            feed_vals.append(v.to(self._device))
        with torch.no_grad():
            outs = self._gm(*self._consts, *feed_vals)
        if return_numpy:
            outs = [_numpy(o) for o in outs]
        return dict(zip(self.fetch_names, outs))


def _numpy(t):
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


_default_main = Program()
_default_startup = Program()
_current_main = _default_main
_current_startup = _default_startup


def default_main_program():
    return _current_main


def default_startup_program():
    return _current_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _current_main, _current_startup
    old_m, old_s = _current_main, _current_startup
    _current_main = main_program
    if startup_program is not None:
        _current_startup = startup_program
    try:
        yield
    finally:
        _current_main, _current_startup = old_m, old_s


def data(name, shape, dtype="float32", lod_level=0):
    v = Variable(name, shape, dtype, _current_main)
    _current_main.placeholders[name] = v
    return v


@contextlib.contextmanager
def name_scope(prefix):
    yield


@contextlib.contextmanager
def device_guard(device=None):
    yield


@contextlib.contextmanager
def scope_guard(scope):
    yield


def global_scope():
    return _global_scope


def cpu_places(device_count=None):
    from ..core.place import CPUPlace

    return [CPUPlace() for _ in range(device_count or 1)]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    from ..autograd.engine import grad as _grad

    return _grad(targets, inputs, grad_outputs=target_gradients)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    loss.backward()
    params = parameter_list or []
    return [(p, p.grad) for p in params]


class Executor:
    """(reference: python/paddle/fluid/executor.py:1257 Executor.run →
    StandaloneExecutor/InterpreterCore). run(fetch_list=...) executes
    the program's stages on the executor's device (the card unless a
    CPU place is given) with the feed dict's arrays as placeholders."""

    def __init__(self, place=None):
        self.place = place
        self._device = _device_of(place)
        self._cache = {}

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        feed = feed or {}
        fetch_list = fetch_list or []
        dev = self._device
        env = {name: torch.as_tensor(
            value if isinstance(value, torch.Tensor)
            else np.asarray(value)).to(dev)
            for name, value in feed.items()}
        prog = program or _current_main
        with torch.device(dev):
            for stage in prog.stages:
                stage(env)
        results = []
        for f in fetch_list:
            out = env.get(f.name if isinstance(f, Variable) else f) \
                if isinstance(f, (Variable, str)) else f
            if out is None:
                raise KeyError(f"fetch target {f} not produced")
            results.append(_numpy(out) if return_numpy
                           and isinstance(out, torch.Tensor) else out)
        return results

    def _run_dataset(self, program, dataset, fetch_list, fetch_info,
                     print_period, debug):
        """Shared engine of train/infer_from_dataset (reference:
        executor.py train_from_dataset → MultiTrainer): each batch the
        dataset yields is fed as one `run` of the program."""
        use_var = getattr(dataset, "_use_var", []) or []
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in use_var]
        fetch_list = fetch_list or []
        fetch_info = fetch_info or [
            getattr(f, "name", str(f)) for f in fetch_list]
        results = None
        for i, batch in enumerate(dataset):
            cols = list(zip(*batch))
            if names and len(cols) != len(names):
                raise ValueError(
                    f"dataset yields {len(cols)} slots but use_vars "
                    f"names {len(names)}: {names}")
            feed = {n: np.asarray(c) for n, c in zip(names, cols)}
            results = self.run(program, feed=feed, fetch_list=fetch_list)
            if print_period and (i + 1) % print_period == 0 and \
                    (fetch_list or debug):
                msg = ", ".join(
                    f"{info}: {np.asarray(r).reshape(-1)[:4]}"
                    for info, r in zip(fetch_info, results))
                print(f"[dataset] batch {i + 1}: {msg}", flush=True)
        return results

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """(reference executor.py:train_from_dataset): one pass of the
        dataset through the program."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        return self._run_dataset(program, dataset, fetch_list, fetch_info,
                                 print_period, debug)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """(reference executor.py:infer_from_dataset) — the same loop;
        the program itself decides train vs infer."""
        if dataset is None:
            raise ValueError("infer_from_dataset needs a dataset")
        return self._run_dataset(program, dataset, fetch_list, fetch_info,
                                 print_period, debug)

    def close(self):
        pass


def save(program, model_path, protocol=4):
    from ..framework.io_state import save as _save

    _save({"program": "static-facade"}, model_path + ".pdmodel")


def load(program, model_path, executor=None, var_list=None):
    pass


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         **kwargs):
    raise NotImplementedError(
        "use paddle_tpu_torch.jit.save(layer, path, input_spec=...) — the "
        "port's inference artifact is a torch.export program")


def load_inference_model(path_prefix, executor, **kwargs):
    raise NotImplementedError(
        "use paddle_tpu_torch.jit.load(path) to load a jit.save artifact")


class _AmpFacade:
    @staticmethod
    def decorate(models=None, optimizers=None, level="O1", **kw):
        from .. import amp as _amp

        return _amp.decorate(models, optimizers, level=level, **kw)


amp = _AmpFacade()


# ---- remaining reference surface (python/paddle/static/__init__.py) ----

class Scope:
    """Variable scope (reference: paddle/fluid/framework/scope.h:60): the
    name → value API for save / load tooling."""

    def __init__(self):
        self.vars = {}

    def var(self, name):
        self.vars.setdefault(name, None)
        return name

    def find_var(self, name):
        return self.vars.get(name)

    def local_scope(self):
        return Scope()


_global_scope = Scope()


class BuildStrategy:
    """Graph-build knobs (reference: framework/details/build_strategy.h),
    recorded for compatibility; nothing compiles the stages."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_broadcast_ops = True
        self.fuse_elewise_add_act_ops = False
        self.memory_optimize = True
        self.reduce_strategy = None
        self.gradient_scale_strategy = None


class ExecutionStrategy:
    """(reference: framework/details/execution_strategy.h)."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10
        self.num_iteration_per_run = 1


class CompiledProgram:
    """(reference: python/paddle/fluid/compiler.py CompiledProgram): a
    wrapper carrying the strategies; Executor.run runs its stages."""

    def __init__(self, program_or_graph, build_strategy=None):
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        if build_strategy is not None:
            self.build_strategy = build_strategy
        return self

    @property
    def stages(self):
        return self.program.stages

    @property
    def placeholders(self):
        return self.program.placeholders


ParallelExecutor = CompiledProgram  # legacy alias (parallel_executor.cc)


class IpuStrategy:
    """IPU config facade (reference: python/paddle/fluid/compiler.py
    IpuStrategy). No IPU backend exists here; options are recorded."""

    def __init__(self):
        self.options = {}

    def set_options(self, options):
        self.options.update(options)

    def set_graph_config(self, **kw):
        self.options.update(kw)

    def set_pipelining_config(self, **kw):
        self.options.update(kw)

    def set_precision_config(self, **kw):
        self.options.update(kw)


class IpuCompiledProgram:
    def __init__(self, program=None, scope=None, ipu_strategy=None):
        raise RuntimeError(
            "no IPU backend in this build — the GPU is the accelerator; "
            "use Executor/CompiledProgram directly")


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    yield


def set_ipu_shard(call_func, index=-1, stage=-1):
    return call_func


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Debug print pass-through (reference: fluid/layers/control_flow.py
    Print → print_op): prints eagerly and returns the input unchanged."""
    t = torch.as_tensor(input)
    head = f"{message or ''} "
    if print_tensor_name:
        head += f"name={t.name} "
    if print_tensor_shape:
        head += f"shape={tuple(t.shape)} "
    flat = _numpy(t).reshape(-1)
    if summarize is not None and summarize >= 0:
        flat = flat[:summarize]  # -1 = print everything (reference)
    print(head + str(flat))
    return input


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference: python/paddle/static/nn/metric.py)."""
    from ..metric import accuracy as _acc

    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """Batch AUC (reference: static/nn/metric.py auc): (auc_value,
    batch_auc, [state])."""
    from ..metric import Auc

    m = Auc(num_thresholds=num_thresholds)
    m.update(_numpy(torch.as_tensor(input)), _numpy(torch.as_tensor(label)))
    t = torch.tensor(float(m.accumulate()), dtype=torch.float32)
    return t, t, []


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """CTR metrics (reference: fluid/layers/metric_op.py
    ctr_metric_bundle): (sqrerr, abserr, prob, q, pos, total)."""
    p = _numpy(torch.as_tensor(input)).reshape(-1)
    y = _numpy(torch.as_tensor(label)).reshape(-1)

    def t(v):
        return torch.tensor(np.float32(v))

    return (t(np.sum((p - y) ** 2)), t(np.sum(np.abs(p - y))),
            t(np.sum(p)), t(np.sum(p)), t(np.sum(y)), t(len(p)))


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..ops.api_misc import create_parameter as _cp

    return _cp(shape, dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..core.dtype import convert_dtype

    t = torch.full(tuple(shape), value, dtype=convert_dtype(dtype))
    t.persistable = persistable
    return t


def cuda_places(device_ids=None):
    """The CUDA places (the card's role)."""
    from ..core.place import CUDAPlace

    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


def npu_places(device_ids=None):
    return cuda_places(device_ids)


def mlu_places(device_ids=None):
    return cuda_places(device_ids)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """(reference: fluid/layers/learning_rate_scheduler.py): the
    matching LRScheduler."""
    from ..optimizer.lr import ExponentialDecay

    return ExponentialDecay(learning_rate, gamma=decay_rate)


class WeightNormParamAttr:
    """ParamAttr requesting weight normalization (reference:
    python/paddle/fluid/param_attr.py WeightNormParamAttr)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _collect_all_parameters():
    """Every live Parameter."""
    return [o for o in gc.get_objects() if isinstance(o, torch.nn.Parameter)]


class ExponentialMovingAverage:
    """EMA of trainable parameters (reference:
    python/paddle/static/__init__.py ExponentialMovingAverage):
    update() accumulates, apply()/restore() swap the values in."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self.decay = float(decay)
        self._ema = {}
        self._params = {}
        self._backup = {}
        self._step = 0

    @torch.no_grad()
    def update(self, parameters=None):
        params = parameters or [
            p for p in _collect_all_parameters() if p.requires_grad]
        self._step += 1
        d = min(self.decay, (1 + self._step) / (10 + self._step))
        for p in params:
            prev = self._ema.get(id(p))
            cur = p.detach().clone()
            self._ema[id(p)] = cur if prev is None else d * prev + (1 - d) * cur
            self._params[id(p)] = p

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def guard():
            with torch.no_grad():
                for key, val in self._ema.items():
                    p = self._params[key]
                    self._backup[key] = p.detach().clone()
                    p.copy_(val)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return guard()

    @torch.no_grad()
    def restore(self, executor=None):
        for key, val in self._backup.items():
            self._params[key].copy_(val)
        self._backup = {}


def normalize_program(program, feed_vars, fetch_vars):
    """(reference: static/io.py normalize_program): the stages as-is with
    the feed / fetch contract attached."""
    p = program.clone()
    p.feed_names = [getattr(v, "name", v) for v in (
        feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars])]
    p.fetch_names = [getattr(v, "name", v) for v in (
        fetch_vars if isinstance(fetch_vars, (list, tuple))
        else [fetch_vars])]
    return p


def serialize_program(feed_vars, fetch_vars, **kwargs):
    import pickle

    prog = default_main_program()
    meta = {
        "placeholders": {k: (v.shape, str(v.dtype))
                         for k, v in prog.placeholders.items()},
        "feed": [getattr(v, "name", v) for v in (
            feed_vars if isinstance(feed_vars, (list, tuple))
            else [feed_vars])],
        "fetch": [getattr(v, "name", v) for v in (
            fetch_vars if isinstance(fetch_vars, (list, tuple))
            else [fetch_vars])],
    }
    return pickle.dumps(meta)


def deserialize_program(data):
    import pickle

    meta = pickle.loads(data)
    p = Program()
    for name, (shape, dtype) in meta["placeholders"].items():
        p.placeholders[name] = Variable(name, shape, dtype, p)
    return p


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs):
    import pickle

    return pickle.dumps({})


def deserialize_persistables(program, data, executor=None):
    import pickle

    return pickle.loads(data)


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from ..framework.io_state import save as _save

    _save({getattr(v, "name", None) or str(i): v
           for i, v in enumerate(vars or [])},
          dirname if filename is None else f"{dirname}/{filename}")


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from ..framework.io_state import load as _load

    return _load(dirname if filename is None else f"{dirname}/{filename}")


def load_program_state(model_path, var_list=None):
    from ..framework.io_state import load as _load

    return _load(model_path)


def set_program_state(program, state_dict):
    program.state = dict(state_dict)


from .nn_build import py_func  # noqa: E402,F401


def batch(reader, batch_size, drop_last=False):
    """Legacy reader batching decorator (reference: python/paddle/batch.py)."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


__all__ += [
    "Scope", "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
    "ParallelExecutor", "IpuStrategy", "IpuCompiledProgram",
    "ipu_shard_guard", "set_ipu_shard", "Print", "accuracy", "auc",
    "ctr_metric_bundle", "create_parameter", "create_global_var",
    "cuda_places", "xpu_places", "npu_places", "mlu_places",
    "exponential_decay", "WeightNormParamAttr",
    "ExponentialMovingAverage", "normalize_program", "serialize_program",
    "deserialize_program", "serialize_persistables",
    "deserialize_persistables", "save_to_file", "load_from_file",
    "save_vars", "load_vars", "load_program_state", "set_program_state",
    "py_func", "batch", "nn",
]
