"""Device resolution for the port's entry points.

The port is written for one NVIDIA H100: an entry point given no device
runs on CUDA, and raises when no GPU is present instead of carrying on
quietly on the CPU. `device="cpu"` is the explicit request for the
plain PyTorch versions of every kernel (what the CPU tests use).
"""
import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """None → "cuda". Returns a `torch.device`; raises RuntimeError when
    CUDA is asked for (explicitly or by default) and no GPU is found."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA GPU by default and none was "
            "found; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
