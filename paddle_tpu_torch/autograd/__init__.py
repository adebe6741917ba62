"""Autograd (counterpart of paddle_tpu/autograd): `grad` with the
reference's rules (engine.py), `backward`, the grad-mode switches over
torch's, `saved_tensors_hooks`, and `PyLayer` over
`torch.autograd.Function` (py_layer.py)."""
import torch

from .engine import backward, grad, is_grad_enabled  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["grad", "backward", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "saved_tensors_hooks",
           "PyLayer", "PyLayerContext"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks
backward_mode = "reverse"
