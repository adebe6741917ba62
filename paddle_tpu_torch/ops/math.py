"""Math ops (counterpart of paddle_tpu/ops/math.py).

One torch expression per op, under the reference's names and
signatures; torch's autograd records them. Where torch's own function
differs from the reference's jnp one the jnp rule is kept: `median`
averages the two middle values, `cummax` / `cummin` keep the first
index of a tie, `lerp` is a + w·(b − a) for every w, `imag` of a real
tensor is zeros, `allclose` / `equal_all` return 0-d bool tensors.
Reductions take `axis` as an int, a list or None (every element) and
promote as jnp does: an integer or bool `sum` / `prod` gives int64, a
`cumsum` / `cumprod` keeps an integer dtype; a `mean` of integers gives
the default float dtype.
"""
import torch

from ..core import dtype as dtype_mod
from ._helpers import (axes_of, binary_op, cast, defop, operand, reduce_op,
                       tensor_of, unary_op)


def _int_to_i64(x):
    if x.dtype == torch.bool or not (x.is_floating_point()
                                     or x.is_complex()):
        return x.long()
    return x


# ---- elementwise binary ----
add = binary_op("add", torch.add)
subtract = binary_op("subtract", torch.subtract)
multiply = binary_op("multiply", torch.multiply)
divide = binary_op("divide", torch.true_divide)
floor_divide = binary_op("floor_divide", torch.floor_divide)
mod = binary_op("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = binary_op("pow", torch.pow)
maximum = binary_op("maximum", torch.maximum)
minimum = binary_op("minimum", torch.minimum)
fmax = binary_op("fmax", torch.fmax)
fmin = binary_op("fmin", torch.fmin)
atan2 = binary_op("atan2", torch.atan2)
hypot = binary_op("hypot", torch.hypot)
copysign = binary_op("copysign", torch.copysign)
nextafter = binary_op("nextafter", torch.nextafter)
ldexp = binary_op("ldexp", lambda a, b: a * torch.pow(2.0, b).to(a.dtype))
heaviside = binary_op("heaviside",
                      lambda a, b: torch.heaviside(a, b.to(a.dtype)))
gcd = binary_op("gcd", torch.gcd)
lcm = binary_op("lcm", torch.lcm)
logaddexp = binary_op("logaddexp", torch.logaddexp)


def _imag(a):
    return a.imag if a.is_complex() else torch.zeros_like(a)


def _real(a):
    return a.real if a.is_complex() else a


# ---- elementwise unary ----
abs = unary_op("abs", torch.abs)
neg = unary_op("neg", torch.neg)
exp = unary_op("exp", torch.exp)
expm1 = unary_op("expm1", torch.expm1)
log = unary_op("log", torch.log)
log2 = unary_op("log2", torch.log2)
log10 = unary_op("log10", torch.log10)
log1p = unary_op("log1p", torch.log1p)
sqrt = unary_op("sqrt", torch.sqrt)
rsqrt = unary_op("rsqrt", torch.rsqrt)
square = unary_op("square", torch.square)
reciprocal = unary_op("reciprocal", torch.reciprocal)
sin = unary_op("sin", torch.sin)
cos = unary_op("cos", torch.cos)
tan = unary_op("tan", torch.tan)
asin = unary_op("asin", torch.asin)
acos = unary_op("acos", torch.acos)
atan = unary_op("atan", torch.atan)
sinh = unary_op("sinh", torch.sinh)
cosh = unary_op("cosh", torch.cosh)
tanh = unary_op("tanh", torch.tanh)
asinh = unary_op("asinh", torch.asinh)
acosh = unary_op("acosh", torch.acosh)
atanh = unary_op("atanh", torch.atanh)
floor = unary_op("floor", torch.floor)
ceil = unary_op("ceil", torch.ceil)
round = unary_op("round", torch.round)
trunc = unary_op("trunc", torch.trunc)
frac = unary_op("frac", lambda a: a - torch.trunc(a))
class _Sign(torch.autograd.Function):
    """jnp.sign: x / |x| (0 at 0) for a complex x, -1 / 0 / 1 for a real
    one; its gradient is zero, as jax defines it."""

    @staticmethod
    def forward(ctx, a):
        return torch.sgn(a) if a.is_complex() else torch.sign(a)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


sign = unary_op("sign", _Sign.apply)
sgn = sign
erf = unary_op("erf", torch.erf)
erfinv = unary_op("erfinv", torch.erfinv)
lgamma = unary_op("lgamma", torch.lgamma)
digamma = unary_op("digamma", torch.digamma)
i0 = unary_op("i0", torch.special.i0)
i0e = unary_op("i0e", torch.special.i0e)
i1 = unary_op("i1", torch.special.i1)
i1e = unary_op("i1e", torch.special.i1e)
angle = unary_op("angle", torch.angle)
conj = unary_op("conj", lambda a: torch.conj_physical(a))
real = unary_op("real", _real)
imag = unary_op("imag", _imag)
deg2rad = unary_op("deg2rad", torch.deg2rad)
rad2deg = unary_op("rad2deg", torch.rad2deg)


@defop("_identity")
def _identity(x, name=None):
    return tensor_of(x).clone()


@defop("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    (x,) = cast("scale", tensor_of(x))
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act:
        from . import activation

        out = getattr(activation, act)(out)
    return out


@defop("increment")
def increment(x, value=1.0, name=None):
    """x + value written into x, outside autograd (counters)."""
    with torch.no_grad():
        x.add_(value)
    return x


@defop("clip")
def clip(x, min=None, max=None, name=None):
    (x,) = cast("clip", tensor_of(x))
    return torch.clamp(x, min, max)


@defop("lerp")
def lerp(x, y, weight, name=None):
    x, y = cast("lerp", tensor_of(x), operand(y, tensor_of(x)))
    return x + weight * (y - x)


@defop("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input, x, y = cast("addmm", tensor_of(input), tensor_of(x),
                       tensor_of(y))
    return beta * input + alpha * (x @ y)


@defop("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (x,) = cast("stanh", tensor_of(x))
    return scale_b * torch.tanh(scale_a * x)


@defop("rsqrt_")
def rsqrt_(x, name=None):
    return x.rsqrt_()


# ---- reductions ----
def _flat_over(x, dim):
    """x with the axes `dim` (None: all) moved last and merged into
    one; and the shape a keepdim result takes."""
    nd = x.ndim
    if dim is None:
        dims = tuple(range(nd))
    else:
        dims = tuple(d % nd for d in ((dim,) if isinstance(dim, int)
                                      else dim))
    rest = [d for d in range(nd) if d not in dims]
    moved = x.permute(rest + list(dims)) if nd else x
    flat = moved.reshape([x.shape[d] for d in rest] + [-1])
    keep = [1 if d in dims else x.shape[d] for d in range(nd)]
    return flat, keep


def _keep(out, keep, keepdim, lead=()):
    return out.reshape(list(lead) + keep) if keepdim else out


def _sum(x, dim, keepdim):
    return torch.sum(_int_to_i64(x), dim=dim, keepdim=keepdim)


def _mean(x, dim, keepdim):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(dtype_mod.get_default_dtype())
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    flat, keep = _flat_over(_int_to_i64(x), dim)
    return _keep(flat.prod(-1), keep, keepdim)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=() if dim is None else dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=() if dim is None else dim, keepdim=keepdim)


@defop("sum")
def sum(x, axis=None, keepdim=False, name=None, dtype=None):
    """Σ over `axis`; `dtype` casts the input first (paddle's)."""
    (x,) = cast("sum", tensor_of(x))
    if dtype is not None:
        x = x.to(dtype_mod.convert_dtype(dtype))
    return _sum(x, axes_of(axis), keepdim)


@defop("mean")
def mean(x, axis=None, keepdim=False, name=None, dtype=None):
    (x,) = cast("mean", tensor_of(x))
    if dtype is not None:
        x = x.to(dtype_mod.convert_dtype(dtype))
    return _mean(x, axes_of(axis), keepdim)


prod = reduce_op("prod", _prod)
max = reduce_op("max", _amax)
min = reduce_op("min", _amin)
amax = max
amin = min
nansum = reduce_op("nansum", lambda x, d, k: torch.nansum(
    _int_to_i64(x), dim=d, keepdim=k))
nanmean = reduce_op("nanmean", lambda x, d, k: torch.nanmean(
    x, dim=d, keepdim=k))


@defop("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    (x,) = cast("std", tensor_of(x))
    return torch.std(x, dim=axes_of(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@defop("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    (x,) = cast("var", tensor_of(x))
    return torch.var(x, dim=axes_of(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@defop("median")
def median(x, axis=None, keepdim=False, name=None):
    """The middle value, the mean of the two middle ones for an even
    count (jnp.median)."""
    (x,) = cast("median", tensor_of(x))
    flat, keep = _flat_over(x, axes_of(axis))
    return _keep(torch.quantile(flat, 0.5, dim=-1), keep, keepdim)


@defop("quantile")
def quantile(x, q, axis=None, keepdim=False, name=None):
    (x,) = cast("quantile", tensor_of(x))
    flat, keep = _flat_over(x, axes_of(axis))
    qs = torch.as_tensor(q, dtype=flat.dtype, device=flat.device)
    out = torch.quantile(flat, qs, dim=-1)
    return _keep(out, keep, keepdim, lead=tuple(qs.shape))


@defop("logsumexp")
def logsumexp(x, axis=None, keepdim=False, name=None):
    (x,) = cast("logsumexp", tensor_of(x))
    dim = axes_of(axis)
    if dim is None:
        dim = tuple(range(x.ndim))
    return torch.logsumexp(x, dim=dim, keepdim=keepdim)


def _arg_extreme(fn, x, axis, keepdim, dtype):
    x = tensor_of(x)
    d = dtype_mod.convert_dtype(dtype)
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdim:
            out = out.reshape([1] * x.ndim)
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(d)


@defop("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme(torch.argmax, x, axis, keepdim, dtype)


@defop("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme(torch.argmin, x, axis, keepdim, dtype)


@defop("all")
def all(x, axis=None, keepdim=False, name=None):
    x = tensor_of(x)
    flat, keep = _flat_over(x, axes_of(axis))
    return _keep(torch.all(flat, dim=-1), keep, keepdim)


@defop("any")
def any(x, axis=None, keepdim=False, name=None):
    x = tensor_of(x)
    flat, keep = _flat_over(x, axes_of(axis))
    return _keep(torch.any(flat, dim=-1), keep, keepdim)


@defop("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = tensor_of(x)
    flat, keep = _flat_over(x, axes_of(axis))
    return _keep(torch.count_nonzero(flat, dim=-1), keep, keepdim).long()


# ---- cumulative ----
def _cum_dtype(x):
    """jnp's running sums and products keep an integer dtype (torch's
    would widen it to int64); bool counts in int64."""
    return torch.int64 if x.dtype == torch.bool else x.dtype


@defop("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    (x,) = cast("cumsum", tensor_of(x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, int(axis), dtype=_cum_dtype(x))


@defop("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = cast("cumprod", tensor_of(x))
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, int(dim), dtype=_cum_dtype(x))


def _cum_extreme(x, axis, dtype, greater):
    """(running extreme, the index where it was first reached): the
    index moves only where a value strictly beats the running one, so a
    tie keeps the first index (reference :263)."""
    x = tensor_of(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    ax = int(axis) % x.ndim
    vals = (torch.cummax if greater else torch.cummin)(x, ax).values
    n = x.shape[ax]
    shape = [1] * x.ndim
    shape[ax] = n
    iota = torch.arange(n, device=x.device).reshape(shape).expand(x.shape)
    prev = vals.narrow(ax, 0, n - 1)
    cur = vals.narrow(ax, 1, n - 1)
    moved = (cur > prev) if greater else (cur < prev)
    first = torch.ones_like(vals.narrow(ax, 0, 1), dtype=torch.bool)
    new = torch.cat([first, moved], dim=ax)
    idx = torch.cummax(torch.where(new, iota, 0), ax).values
    return vals, idx.to(dtype_mod.convert_dtype(dtype))


@defop("cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, True)


@defop("cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, False)


@defop("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = tensor_of(x)
    pre = None if prepend is None else tensor_of(prepend, like=x)
    app = None if append is None else tensor_of(append, like=x)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


@defop("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    x = tensor_of(x)
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@defop("kron")
def kron(x, y, name=None):
    return torch.kron(tensor_of(x), tensor_of(y))


@defop("inner")
def inner(x, y, name=None):
    return torch.inner(tensor_of(x), tensor_of(y))


@defop("outer")
def outer(x, y, name=None):
    return torch.outer(tensor_of(x).reshape(-1), tensor_of(y).reshape(-1))


# ---- comparison (non-differentiable outputs) ----
equal = binary_op("equal", torch.eq)
not_equal = binary_op("not_equal", torch.ne)
greater_than = binary_op("greater_than", torch.gt)
greater_equal = binary_op("greater_equal", torch.ge)
less_than = binary_op("less_than", torch.lt)
less_equal = binary_op("less_equal", torch.le)


@defop("equal_all")
def equal_all(x, y, name=None):
    x, y = tensor_of(x), tensor_of(y)
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


@defop("allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = tensor_of(x), tensor_of(y)
    return torch.tensor(bool(torch.allclose(x, y, rtol, atol, equal_nan)),
                        device=x.device)


@defop("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(tensor_of(x), tensor_of(y), rtol, atol, equal_nan)


isnan = unary_op("isnan", torch.isnan)
isinf = unary_op("isinf", torch.isinf)
isfinite = unary_op("isfinite", torch.isfinite)

# ---- logical / bitwise ----
logical_and = binary_op("logical_and", torch.logical_and)
logical_or = binary_op("logical_or", torch.logical_or)
logical_xor = binary_op("logical_xor", torch.logical_xor)
logical_not = unary_op("logical_not", torch.logical_not)
bitwise_and = binary_op("bitwise_and", torch.bitwise_and)
bitwise_or = binary_op("bitwise_or", torch.bitwise_or)
bitwise_xor = binary_op("bitwise_xor", torch.bitwise_xor)
bitwise_not = unary_op("bitwise_not", torch.bitwise_not)


__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and callable(v) and not isinstance(v, type)
    and getattr(v, "__module__", "").startswith(__package__)
    and n not in {"axes_of", "binary_op", "cast", "defop", "operand",
                  "reduce_op", "tensor_of", "unary_op"})
