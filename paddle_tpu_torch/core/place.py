"""Device resolution for the port's entry points.

The port is written for one NVIDIA H100: an entry point given no device
runs on CUDA, and raises when no GPU is present instead of carrying on
quietly on the CPU. `device="cpu"` is the explicit request for the
plain PyTorch versions of every kernel (what the CPU tests use).

The tensor API's creation functions (`ops.creation`) take no device
argument in the reference: they place on the current device, which
`set_device` sets ("cpu", "gpu", "gpu:1", "cuda:0") and
`current_device` resolves — CUDA until set, with the same refusal when
no GPU is present.
"""
import torch

__all__ = ["resolve_device", "set_device", "get_device", "current_device"]

_current = None


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


def set_device(device):
    """paddle.set_device: the device the tensor API creates on. Returns
    the torch.device."""
    global _current
    name = str(device)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    _current = resolve_device(name)
    return _current


def current_device():
    """The device `set_device` chose, else CUDA (raising without a
    GPU)."""
    return _current if _current is not None else resolve_device(None)


def get_device():
    """paddle.get_device: "cpu" or "gpu:<index>"."""
    d = current_device()
    return "cpu" if d.type == "cpu" else f"gpu:{d.index or 0}"
