"""Hand-written CUDA kernels for Hopper (counterpart of
paddle_tpu/ops/pallas_kernels, plus the int8 GEMM that the JAX package
leaves to XLA). Each module holds a kernel's wrapper, its plain PyTorch
version and its launch counter; the sources are in
`paddle_tpu_torch/csrc/`."""
from . import flash_attention, int8_gemm, paged_attention  # noqa: F401
