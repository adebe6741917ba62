from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import (LayerDict, LayerList, ParameterList,  # noqa: F401
                        Sequential)
from .conv import *  # noqa: F401,F403
from .layers import ParamAttr, create_parameter  # noqa: F401
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .transformer import MultiHeadAttention  # noqa: F401
