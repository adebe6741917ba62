"""Functional ops (counterpart of paddle_tpu/nn/functional)."""
from .activation import gelu  # noqa: F401
from .attention import (dense_attention_bshd, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import embedding, linear  # noqa: F401
from .loss import (cross_entropy, fused_linear_cross_entropy,  # noqa: F401
                   linear_ce_raw)
from .norm import layer_norm  # noqa: F401
