"""Parameter attributes and the one parameter factory of the port's
layers (counterpart of `ParamAttr` and `Layer.create_parameter`,
paddle_tpu/nn/layer/layers.py:67-93, :444).

`create_parameter(shape, attr, ...)` follows the reference: `attr=False`
gives no parameter (None), the initializer is the attribute's, else the
layer's default, else `XavierUniform` for a weight and `Constant(0.0)`
for a bias; `trainable=False` is `requires_grad=False` (the train steps
then leave it alone). `learning_rate` lands in `p.optimize_attr`, and
`regularizer` and `need_clip` on the parameter, where the port's
optimizers and clippers read them. `name` is kept on the attribute
only: a torch tensor's `name` is read-only, and the optimizers key a
parameter by its module path.
"""
import torch
from torch import nn

from .. import initializer as init_mod
from ...core.dtype import resolve_dtype

__all__ = ["ParamAttr", "create_parameter"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, init_mod.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {type(attr)} to ParamAttr")


@torch.no_grad()
def create_parameter(shape, attr=None, dtype=None, is_bias=False,
                     default_initializer=None, device=None):
    """An initialized `nn.Parameter` of `shape` under `attr`, or None
    when `attr` is False."""
    if attr is False:
        return None
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer or default_initializer
    if init is None:
        init = init_mod.Constant(0.0) if is_bias else init_mod.XavierUniform()
    value = init._init(tuple(int(s) for s in shape),
                       resolve_dtype(dtype or "float32"), device)
    p = nn.Parameter(value, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p
