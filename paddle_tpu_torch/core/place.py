"""Device resolution for the port's entry points.

The port is written for one NVIDIA H100: an entry point given no device
runs on CUDA, and raises when no GPU is present instead of carrying on
quietly on the CPU. `device="cpu"` is the explicit request for the
plain PyTorch versions of every kernel (what the CPU tests use).

The reference's `Place` classes name devices: `CPUPlace()` the CPU,
`CUDAPlace(i)` and the accelerator places (`TPUPlace(i)`, ...) the CUDA
device `i`. The `is_compiled_with_*` queries and `device_count` answer
for this machine: CUDA when a GPU is present, never a TPU.

The tensor API's creation functions (`ops.creation`) take no device
argument in the reference: they place on the current device, which
`set_device` sets ("cpu", "gpu", "gpu:1", "cuda:0") and
`current_device` resolves — CUDA until set, with the same refusal when
no GPU is present.
"""
import torch

__all__ = ["resolve_device", "set_device", "get_device", "current_device",
           "Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace",
           "XPUPlace", "NPUPlace", "MLUPlace", "IPUPlace", "CustomPlace",
           "get_place", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_rocm", "is_compiled_with_cinn",
           "is_compiled_with_xpu", "is_compiled_with_npu",
           "is_compiled_with_mlu", "is_compiled_with_ipu",
           "get_cudnn_version", "device_count"]

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
    """paddle.set_device: the device the tensor API creates on ("cpu",
    "gpu:1", a Place). Returns the torch.device."""
    global _current
    if isinstance(device, Place):
        device = device.torch_device()
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


# ---- the reference's Place classes and device queries (core/place.py) ----

class Place:
    """A device, compared by (kind, device_id). `torch_device()` is the
    torch device it names."""

    kind = "unknown"

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def get_device_id(self):
        return self.device_id

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"

    def torch_device(self):
        if self.kind == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    kind = "gpu"


class TPUPlace(Place):
    """Accepted for API compatibility; the port's accelerator is the
    CUDA device of the same index."""

    kind = "tpu"


class CUDAPinnedPlace(CPUPlace):
    pass


class XPUPlace(TPUPlace):
    """Accepted for API compatibility; maps to the CUDA device."""


class NPUPlace(TPUPlace):
    """Accepted for API compatibility; maps to the CUDA device."""


class MLUPlace(TPUPlace):
    """Accepted for API compatibility; maps to the CUDA device."""


class IPUPlace(TPUPlace):
    """Accepted for API compatibility; maps to the CUDA device."""


class CustomPlace(Place):
    """A device type by name ("cpu" names the CPU, anything else the CUDA
    device)."""

    def __init__(self, device_type, device_id=0):
        super().__init__(device_id)
        self.kind = str(device_type)


def get_place():
    """The current device (`set_device`) as a Place."""
    d = current_device()
    return CPUPlace() if d.type == "cpu" else CUDAPlace(d.index or 0)


def is_compiled_with_cuda():
    """True when this machine runs the port on a CUDA GPU."""
    return torch.cuda.is_available()


def is_compiled_with_tpu():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_cinn():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_mlu():
    return False


def is_compiled_with_ipu():
    return False


def get_cudnn_version():
    return (torch.backends.cudnn.version() if torch.cuda.is_available()
            else None)


def device_count():
    """The CUDA devices this machine has (0 without a GPU)."""
    return torch.cuda.device_count()
