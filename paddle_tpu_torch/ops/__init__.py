"""The functional op namespace (counterpart of paddle_tpu/ops/__init__.py)
and the port's table of Tensor methods.

The namespace is the reference's: creation, linalg, math, extras,
control flow and the API gap-closers whole, and manipulation's public
ops by name. `cuda_kernels` holds the hand-written Hopper kernels.

The reference installs its ops as methods of its own Tensor class
(`_install_tensor_methods`). The port does not patch `torch.Tensor`:
that would change torch's own methods for every caller, and torch
already has most of those names with other semantics (`sum(dim=)`,
`max` returning a pair, `reshape` without paddle's 0 ...). Instead
`TENSOR_METHODS` maps each name the reference installs to the port
function that computes it, called with the tensor first
(`TENSOR_METHODS["scale"](x, 2.0)`), and `tensor_core` holds the
functional forms of the reference's own Tensor methods.
"""
from . import activation, creation, linalg, manipulation, math  # noqa: F401
from . import api_misc, control_flow, cuda_kernels, extras  # noqa: F401
from ._helpers import (binary_op, defop, get_op, inplace,  # noqa: F401
                       list_ops, reduce_op, register_op, unary_op)
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import (  # noqa: F401
    broadcast_tensors,
    broadcast_to,
    bucketize,
    cast,
    chunk,
    concat,
    expand,
    expand_as,
    flatten,
    flip,
    gather,
    gather_nd,
    index_sample,
    index_select,
    masked_fill,
    masked_select,
    mode,
    moveaxis,
    nonzero,
    pad,
    put_along_axis,
    repeat_interleave,
    reshape,
    reshape_,
    roll,
    rot90,
    scatter,
    scatter_nd,
    scatter_nd_add,
    searchsorted,
    slice,
    sort,
    split,
    squeeze,
    stack,
    strided_slice,
    swapaxes,
    take_along_axis,
    tensordot,
    tile,
    topk,
    transpose,
    unbind,
    unique,
    unique_consecutive,
    unsqueeze,
    where,
    argsort,
    kthvalue,
)
from .math import *  # noqa: F401,F403
from .math import _identity  # noqa: F401
from .extras import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .api_misc import *  # noqa: F401,F403


def _method_table():
    """{method name: port function}: the reference's rule — every
    public function of math, manipulation, linalg, activation, extras
    and api_misc (the first module to name it wins), less the
    non-methods it skips — then its explicit assignments, its in-place
    `*_` names (`_helpers.inplace` of the function, where no module
    defines the form itself) and the operators."""
    import types

    from .. import tensor_core

    skip = {"to_tensor", "meshgrid", "einsum", "iinfo",
            "set_printoptions", "create_parameter", "set_grad_enabled",
            "disable_signal_handler", "get_cuda_rng_state",
            "set_cuda_rng_state", "check_shape", "tril_indices",
            "triu_indices"}
    table = {}
    for m in (math, manipulation, linalg, activation, extras, api_misc):
        names = getattr(m, "__all__", None)
        for name in names or dir(m):
            fn = getattr(m, name)
            if (name.startswith("_") or name in skip
                    or isinstance(fn, (types.ModuleType, type))
                    or not callable(fn)
                    or not (names or getattr(fn, "__module__", "")
                            .startswith(__name__))):
                continue
            table.setdefault(name, fn)
    table.update(mean=math.mean, sum=math.sum, max=math.max, min=math.min,
                 prod=math.prod, abs=math.abs, matmul=linalg.matmul,
                 mm=linalg.mm, dot=linalg.dot, norm=linalg.norm,
                 zero_like=creation.zeros_like, cond=linalg.cond_number)

    for nm in ("add", "subtract", "multiply", "scale", "clip", "floor",
               "ceil", "exp", "sqrt", "rsqrt", "reciprocal", "round",
               "tanh", "squeeze", "unsqueeze", "flatten", "scatter",
               "remainder", "index_add", "erfinv", "lerp",
               "put_along_axis"):
        table.setdefault(nm + "_", inplace(table[nm]))
    table["uniform_"] = tensor_core.uniform_
    table["exponential_"] = tensor_core.exponential_
    ops = {"__add__": math.add, "__sub__": math.subtract,
           "__mul__": math.multiply, "__truediv__": math.divide,
           "__floordiv__": math.floor_divide, "__mod__": math.mod,
           "__pow__": math.pow, "__neg__": math.neg, "__abs__": math.abs,
           "__matmul__": linalg.matmul, "__eq__": math.equal,
           "__ne__": math.not_equal, "__lt__": math.less_than,
           "__le__": math.less_equal, "__gt__": math.greater_than,
           "__ge__": math.greater_equal, "__invert__": math.logical_not,
           "__and__": math.bitwise_and, "__or__": math.bitwise_or,
           "__xor__": math.bitwise_xor}
    table.update(ops)
    table.update({"__radd__": math.add, "__rmul__": math.multiply,
                  "__rsub__": lambda s, o: math.subtract(o, s),
                  "__rtruediv__": lambda s, o: math.divide(o, s),
                  "__rpow__": lambda s, o: math.pow(o, s),
                  "__rmatmul__": lambda s, o: linalg.matmul(o, s)})
    for name in tensor_core.__all__:
        if name not in ("Tensor", "Parameter"):
            table.setdefault(name, getattr(tensor_core, name))
    return table


TENSOR_METHODS = _method_table()
