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
(`text.models.bert`); and the tensor API.

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
for _sub in ("observability", "nn", "optimizer", "amp", "framework", "jit",
             "distributed", "vision", "text", "incubate", "inference",
             "quantization"):
    globals()[_sub] = _importlib.import_module("." + _sub, __name__)

from .framework.io_state import load, save  # noqa: F401,E402
from .framework.random import (get_cuda_rng_state,  # noqa: F401,E402
                               set_cuda_rng_state)

ParamAttr = nn.ParamAttr  # noqa: F821
DataParallel = distributed.DataParallel  # noqa: F821
dtype = _torch.dtype
