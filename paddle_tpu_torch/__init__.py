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
`inference.llm_engine` (`LLMEngine`, `LLMServer`) and the ragged paged
attention kernel — and the GPT training step: `jit.TrainStep`,
`optimizer.AdamW`, bf16 `amp.auto_cast` at O1, the losses, recompute and
the flash attention forward and backward kernels. ROADMAP.md lists what
is still to port.
"""
from .core.place import resolve_device  # noqa: F401
from .core.rng import seed  # noqa: F401

__all__ = ["resolve_device", "seed"]
