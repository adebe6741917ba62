"""Layers and functional ops (counterpart of paddle_tpu/nn): `Layer`, the
layer zoo, `functional`, the initializers, `utils`, `quant`, the
gradient clippers and beam-search decoding."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.layers import Layer, ParamAttr, create_parameter  # noqa: F401
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
from . import layer  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from . import quant  # noqa: F401,E402
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401,E402
from .utils import spectral_norm  # noqa: F401,E402
from .layer import loss  # noqa: F401,E402  (paddle.nn.loss)
