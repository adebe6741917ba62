"""Common functionals (counterpart of
paddle_tpu/nn/functional/common.py): `linear` in paddle's [in, out]
weight layout and `embedding`, each casting its inputs under AMP by the
reference's op name."""
import torch.nn.functional as tF

from ... import amp

__all__ = ["linear", "embedding"]


def linear(x, weight, bias=None):
    """y = x @ W (+ b); `weight` is [in_features, out_features]."""
    if bias is None:
        x, weight = amp.cast_inputs_for("linear", (x, weight))
        return x @ weight
    x, weight, bias = amp.cast_inputs_for("linear", (x, weight, bias))
    return x @ weight + bias


def embedding(x, weight):
    (weight,) = amp.cast_inputs_for("embedding", (weight,))
    return tF.embedding(x, weight)
