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
the flash attention forward and backward kernels. ROADMAP.md lists what
is still to port.
"""
from .core.place import resolve_device  # noqa: F401
from .core.rng import seed  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["resolve_device", "seed", "L1Decay", "L2Decay"]
