"""nn.utils (counterpart of paddle_tpu/nn/utils): flattening parameters,
weight normalization and spectral normalization as forward pre-hooks,
and the gradient clippers.

`weight_norm` replaces `name` by `name_g` and `name_v` and recomputes
the weight g · v / ‖v‖ (the norm over every axis but `dim`) before each
forward. `spectral_norm` divides the weight by its largest singular
value, estimated by power iteration from a vector drawn from the port's
generators (so its first estimates differ from the reference's, which
draws from jax's keys; the iteration converges to the same value).
"""
import torch

from ...core import rng
from ..clip import clip_grad_norm_, clip_grad_value_  # noqa: F401

__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "clip_grad_norm_",
           "clip_grad_value_"]


def parameters_to_vector(parameters, name=None):
    """The parameters' values, flattened and concatenated (no gradient
    flows back, as in the reference)."""
    return torch.cat([p.detach().reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape).to(p.dtype))
        offset += n


def _other_axes(ndim, dim):
    return tuple(i for i in range(ndim) if i != dim)


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name).detach()
    axes = _other_axes(w.ndim, dim)
    g0 = torch.sqrt((w * w).sum(dim=axes, keepdim=True))
    del layer._parameters[name]
    layer.register_parameter(name + "_v", torch.nn.Parameter(w.clone()))
    layer.register_parameter(name + "_g", torch.nn.Parameter(g0))

    def compute(lyr, inputs):
        v = getattr(lyr, name + "_v")
        nrm = torch.sqrt((v * v).sum(dim=axes, keepdim=True))
        lyr.__dict__[name] = (getattr(lyr, name + "_g") * v
                              / torch.clamp(nrm, min=1e-12))

    layer.__dict__["_weight_norm_hook"] = layer.register_forward_pre_hook(
        compute)
    compute(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    hook = layer.__dict__.pop("_weight_norm_hook", None)
    if hook is not None:
        hook.remove()
    layer.__dict__.pop(name, None)
    v = layer._parameters.pop(name + "_v", None)
    g = layer._parameters.pop(name + "_g", None)
    if v is not None and g is not None:
        axes = tuple(i for i in range(v.ndim)
                     if v.shape[i] != g.shape[i] or g.shape[i] == 1)
        with torch.no_grad():
            nrm = torch.sqrt((v ** 2).sum(dim=axes, keepdim=True))
            layer.register_parameter(name, torch.nn.Parameter(g * v / nrm))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    dim = 0 if dim is None else dim
    w = getattr(layer, name)
    rows = w.shape[dim]
    gen = rng.current_generator() or rng.next_generator("cpu")
    u = torch.randn(rows, generator=gen, dtype=torch.float32)
    state = {"u": (u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
                   ).to(w.device)}

    def compute(lyr, inputs):
        wt = lyr._parameters[name]
        with torch.no_grad():
            m = wt.movedim(dim, 0).reshape(rows, -1)
            u = state["u"]
            for _ in range(n_power_iterations):
                v = m.T @ u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
                u = m @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
            state["u"] = u
        sigma = u @ wt.movedim(dim, 0).reshape(rows, -1) @ v
        lyr.__dict__[name] = wt / sigma

    layer.__dict__["_spectral_norm_state"] = state
    layer.register_forward_pre_hook(compute)
    return layer
