"""Functional ops (counterpart of paddle_tpu/nn/functional)."""
from torch.nn.functional import embedding, layer_norm  # noqa: F401

from .activation import gelu  # noqa: F401
from .attention import (dense_attention_bshd, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)


def linear(x, weight, bias=None):
    """paddle's linear: `weight` is [in_features, out_features]."""
    out = x @ weight
    return out if bias is None else out + bias
