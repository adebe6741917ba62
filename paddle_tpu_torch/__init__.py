"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The package mirrors `paddle_tpu`'s module paths and names, so each
ported module sits at the same relative path as its JAX counterpart.
It imports torch and numpy and never jax or `paddle_tpu`. The Pallas
kernels of the JAX package become kernels written by hand for Hopper
(`csrc/` + `ops/cuda_kernels/`); each keeps its plain PyTorch version
beside it, which runs for tensors that lie on the CPU.

Entry points (model constructors, the serving engine) default to the
CUDA device and raise when no GPU is present; `device="cpu"` asks for
the plain versions explicitly (`core.place`).

Ported so far: continuous-batching GPT serving — `text.models.gpt`,
`inference.llm_engine` (`LLMEngine`, `LLMServer`), the serving fleet
(`inference.fleet_serving`: prefix cache, KV wire and tier, replicas,
router) and the ragged paged attention kernel — dense generation
(`GPTForCausalLM.generate`), the batch server (`inference.serving`),
beam search (`nn.decode`), and the GPT training step: `jit.TrainStep`
with its phase trace (`observability.steptrace`), the optimizers and LR
schedules (`optimizer`, `regularizer`, `nn.clip`), bf16 `amp` at O1 and
O2 with `GradScaler`, the losses, recompute with the named policies and
the flash attention forward and backward kernels; the data-, tensor-,
pipeline- and sequence-parallel runtimes (`distributed`); the vision
models (`vision.models`); BERT / ERNIE pretraining
(`text.models.bert`); the tensor API; and deployment — `jit.to_static`
with its AutoGraph, `jit.save` / `load`, the inference `Config` /
`Predictor` / `PredictorPool`, the `static` Program / Executor facade
and `vision.ops`.

The tensor API is the reference's top-level namespace: `import
paddle_tpu_torch as paddle; paddle.reshape(x, [0, -1])` — the ops of
`ops` (creation, math, manipulation, linalg, extras, control flow),
`paddle.linalg`, the dtype names (`paddle.float32` is
`torch.float32`), `set_device` / `get_device` (the device the creation
functions place on) and `Tensor` / `Parameter`. The ops are plain
functions on `torch.Tensor`; `torch.Tensor` itself is not patched
(`ops.TENSOR_METHODS` maps the reference's Tensor methods to them).
The skeleton around them is the reference's too: the Place classes and
device queries, `grad` / `autograd`, `save` / `load`, the flags, and
every ported subpackage bound at the top (`paddle.nn`,
`paddle.distributed`, ...). ROADMAP.md lists what is still to port.
"""
import sys as _sys


def _started_as_launcher(argv):
    """Whether `argv` (`sys.orig_argv`) starts the launcher, `python -m
    paddle_tpu_torch.distributed.launch`."""
    i = 1
    while i < len(argv) and argv[i].startswith("-"):
        arg = argv[i]
        if arg.startswith("-m"):
            module = arg[2:] or (argv[i + 1] if i + 1 < len(argv) else "")
            return module == "paddle_tpu_torch.distributed.launch"
        if arg == "-c":
            return False
        i += 2 if arg in ("-W", "-X") else 1
    return False


# The launcher supervises its workers and hosts their store; its own
# modules (distributed/launch, observability) import no torch. In its
# process this package and `distributed` bind nothing, so it spawns the
# workers at once instead of after a torch import of its own (8-10 s on
# an H100 host), and imports torch only to host the store while they
# start.
_LAUNCHER = _started_as_launcher(getattr(_sys, "orig_argv", ()))

if not _LAUNCHER:
    import importlib as _importlib

    import torch as _torch

    from .core.place import (get_device, resolve_device,  # noqa: F401
                             set_device)
    from .core.rng import seed  # noqa: F401
    from .core.dtype import (  # noqa: F401
        bfloat16,
        bool_ as bool,  # noqa: A001  (paddle.bool)
        complex64,
        complex128,
        float16,
        float32,
        float64,
        get_default_dtype,
        int8,
        int16,
        int32,
        int64,
        set_default_dtype,
        uint8,
    )
    from .regularizer import L1Decay, L2Decay  # noqa: F401
    from .tensor_core import Parameter, Tensor  # noqa: F401
    from . import ops  # noqa: F401
    from .ops import *  # noqa: F401,F403
    # the top-level linalg namespace, not the ops.linalg the line above bound
    linalg = _importlib.import_module(".linalg", __name__)

    from .core.place import (  # noqa: F401,E402
        CPUPlace,
        CUDAPinnedPlace,
        CUDAPlace,
        CustomPlace,
        IPUPlace,
        MLUPlace,
        NPUPlace,
        TPUPlace,
        XPUPlace,
        device_count,
        get_cudnn_version,
        get_place,
        is_compiled_with_cinn,
        is_compiled_with_cuda,
        is_compiled_with_ipu,
        is_compiled_with_mlu,
        is_compiled_with_npu,
        is_compiled_with_rocm,
        is_compiled_with_tpu,
        is_compiled_with_xpu,
    )
    from .core.flags import get_flags, set_flags  # noqa: F401,E402
    from .core.rng import get_rng_state_tracker  # noqa: F401,E402
    from . import autograd  # noqa: F401,E402
    from .autograd import enable_grad, no_grad  # noqa: F401,E402
    from .autograd.engine import grad, is_grad_enabled  # noqa: F401,E402

    # the ported subpackages, bound as the reference binds its own
    # (paddle_tpu/__init__.py:71-104); none builds or loads a CUDA library
    # on import
    for _sub in ("observability", "nn", "optimizer", "metric", "io", "amp",
                 "framework", "jit", "distributed", "vision", "text",
                 "profiler", "incubate", "hapi", "inference", "native",
                 "quantization", "static"):
        globals()[_sub] = _importlib.import_module("." + _sub, __name__)

    from .framework.io_state import load, save  # noqa: F401,E402
    from .framework.random import (get_cuda_rng_state,  # noqa: F401,E402
                                   set_cuda_rng_state)

    from .hapi import callbacks  # noqa: F401,E402
    from .hapi.dynamic_flops import flops  # noqa: F401,E402
    from .hapi.model import Model  # noqa: F401,E402
    from .hapi.summary import summary  # noqa: F401,E402

    from .jit import InputSpec  # noqa: F401,E402

    ParamAttr = nn.ParamAttr  # noqa: F821
    DataParallel = distributed.DataParallel  # noqa: F821
    dtype = _torch.dtype

    # eager is the default; static capture goes through `jit.to_static`
    # and the `static` facade, so these only record the mode (reference:
    # paddle_tpu/__init__.py:158-175)
    _static_mode = False

    def disable_static(place=None):
        global _static_mode
        _static_mode = False

    def enable_static():
        global _static_mode
        _static_mode = True

    def in_dynamic_mode():
        return not _static_mode
