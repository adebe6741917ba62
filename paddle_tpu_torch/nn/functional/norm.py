"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py)."""
import torch.nn.functional as tF

from ... import amp

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` dims; black-listed
    under AMP, so it runs in f32."""
    x, weight, bias = amp.cast_inputs_for("layer_norm", (x, weight, bias))
    return tF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)
