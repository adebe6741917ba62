"""The Tensor and Parameter types (counterpart of
paddle_tpu/tensor_core.py).

The port's tensor is `torch.Tensor` itself and its parameter the
`torch.nn.Parameter` that `create_parameter` returns, with the
reference's `optimize_attr` / `regularizer` / `need_clip` attributes
set on it. The reference's Tensor methods that torch lacks, or names
otherwise, are functions here taking the tensor first: `astype` /
`cast` with paddle dtype names, `stop_gradient` (not `requires_grad`)
and `set_stop_gradient`, `clear_grad` / `clear_gradient`, `set_value`,
`fill_diagonal_`, `numel` (a Python int), `place`, and the in-place
random fills `uniform_` / `exponential_`, which draw from the port's
generators. `ops.TENSOR_METHODS` maps every method name of the
reference to its function.
"""
import numpy as np
import torch

from .core import dtype as dtype_mod
from .core import rng

__all__ = ["Tensor", "Parameter", "astype", "cast", "stop_gradient",
           "set_stop_gradient", "clear_grad", "clear_gradient", "set_value",
           "fill_diagonal_", "numel", "place", "uniform_", "exponential_"]

Tensor = torch.Tensor
Parameter = torch.nn.Parameter


def astype(x, dtype):
    return x.to(dtype_mod.convert_dtype(dtype))


def cast(x, dtype):
    return astype(x, dtype)


def stop_gradient(x):
    """paddle's `stop_gradient`: True when no gradient flows to x."""
    return not x.requires_grad


def set_stop_gradient(x, value=True):
    x.requires_grad_(not value)
    return x


def clear_grad(x):
    x.grad = None


def clear_gradient(x, set_to_zero=False):
    if set_to_zero and x.grad is not None:
        x.grad.zero_()
    else:
        x.grad = None


@torch.no_grad()
def set_value(x, value):
    """Copy `value` into x (its shape; its dtype is converted)."""
    v = (value if isinstance(value, torch.Tensor)
         else torch.as_tensor(np.asarray(value)))
    if tuple(v.shape) != tuple(x.shape):
        raise ValueError(
            f"set_value shape mismatch {tuple(v.shape)} vs {tuple(x.shape)}")
    x.copy_(v.to(device=x.device, dtype=x.dtype))
    return x


@torch.no_grad()
def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """Fill the `offset` diagonal in place. 2-D: `wrap` restarts it past
    each N×N block of a tall matrix; N-D (all dims equal): the main
    hyper-diagonal."""
    if x.ndim < 2:
        raise ValueError("fill_diagonal_ needs at least 2 dims")
    if x.ndim == 2:
        rows, cols = int(x.shape[0]), int(x.shape[1])
        if offset >= cols or -offset >= rows:
            return x
        start = offset if offset >= 0 else -offset * cols
        flat = torch.arange(start, rows * cols, cols + 1, device=x.device)
        r, c = flat // cols, flat % cols
        if not wrap and len(c) > 1:
            brk = torch.nonzero(torch.diff(c) < 0)
            if brk.numel():
                k = int(brk[0, 0]) + 1
                r, c = r[:k], c[:k]
        x[r, c] = value
        return x
    if len(set(x.shape)) != 1:
        raise ValueError("N-D fill_diagonal_ needs all dims equal")
    idx = torch.arange(x.shape[0], device=x.device)
    x[tuple([idx] * x.ndim)] = value
    return x


def numel(x):
    return x.numel()


def place(x):
    return x.device


@torch.no_grad()
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    """Fresh U(min, max) draws into x."""
    if seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = rng.next_generator(x.device)
    return x.uniform_(min, max, generator=gen)


@torch.no_grad()
def exponential_(x, lam=1.0, name=None):
    """Fresh Exp(lam) draws into x: −log(u) / lam, u ~ U(1e-12, 1)."""
    u = torch.rand(x.shape, generator=rng.next_generator(x.device),
                   dtype=x.dtype, device=x.device)
    return x.copy_(-(1.0 / lam) * torch.log(u * (1.0 - 1e-12) + 1e-12))
