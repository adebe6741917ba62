"""Activations (counterpart of paddle_tpu/ops/activation.py)."""
import torch.nn.functional as tF

from ... import amp

__all__ = ["gelu"]


def gelu(x, approximate=False):
    """GELU; the default is the exact erf form, as in the JAX package
    (`jax.nn.gelu(approximate=False)`)."""
    (x,) = amp.cast_inputs_for("gelu", (x,))
    return tF.gelu(x, approximate="tanh" if approximate else "none")
