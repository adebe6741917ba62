"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

The classes take `(param, grad)` pairs and return new pairs; a
parameter with `need_clip` False (read as `getattr(p, "need_clip",
True)`) passes through. Sums of squares are taken in f32 and the
clipped gradient is cast back to its own dtype, as in the reference.
Quotients of a Python number by a tensor are taken as tensor divisions
(torch's `number / tensor` multiplies by a rounded reciprocal), so they
round as jnp's do.
"""
import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _needs_clip(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _sum_sq(g):
    return (g.float() ** 2).sum()


def _div(num, t):
    """num / t for a Python number, correctly rounded in t's dtype."""
    return torch.div(t.new_tensor(num), t)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max)
                 if _needs_clip(p, g) else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most `clip_norm`."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _needs_clip(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(_sum_sq(g))
            scale = torch.clamp(
                _div(self.clip_norm, torch.clamp(norm, min=1e-12)), max=1.0)
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by clip_norm / max(global L2 norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        sq = [_sum_sq(g) for p, g in params_grads if _needs_clip(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        scale = _div(self.clip_norm,
                     torch.clamp(global_norm, min=self.clip_norm))
        return [(p, (g.float() * scale).to(g.dtype)
                 if _needs_clip(p, g) else g) for p, g in params_grads]


def _as_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place to a total `norm_type` norm of at
    most `max_norm` (scale min(max_norm / (total + 1e-6), 1)); the norm
    is taken in the gradients' dtype, as in the reference. Returns the
    total norm."""
    parameters = _as_list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros([])
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(_div(max_norm, total + 1e-6), max=1.0)
    for g in grads:
        g.copy_((g * scale).to(g.dtype))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient in place to [-clip_value, clip_value]."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
