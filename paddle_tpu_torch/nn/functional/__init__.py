"""Functional ops (counterpart of paddle_tpu/nn/functional)."""
from .activation import *  # noqa: F401,F403
from .attention import (dense_attention_bshd, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from ...ops.math import tanh  # noqa: F401,E402
from ...ops.manipulation import squeeze, unsqueeze  # noqa: F401,E402
from ...ops.creation import diag_embed  # noqa: F401,E402
