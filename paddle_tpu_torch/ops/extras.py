"""Indexing, windowing, linalg and misc ops (counterpart of
paddle_tpu/ops/extras.py), from `logcumsumexp` to `lu_unpack`.

Each is torch's function where it has the reference's semantics and a
few tensor ops where it does not: `take` clips an out-of-range index
under mode "raise" (the reference's in-graph rule), `as_strided` and
`view` are copies with the reference's results, `unfold` puts the
window last, `renorm` clamps with the reference's 1e-7, `pdist` /
`cdist` give a zero gradient for identical points, `lu` returns 1-based
int32 pivots and `lu_unpack` rebuilds the permutation from them.
`poisson` and `svd_lowrank` draw from the port's generators.
"""
import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import rng
from ._helpers import defop, operand, tensor_of

__all__ = [
    "cumulative_trapezoid", "logcumsumexp", "index_add", "index_put",
    "histogramdd", "diagonal", "take", "nanmedian", "nanquantile",
    "renorm", "nan_to_num", "vander", "polygamma", "fmod", "isreal",
    "as_complex", "as_real", "poisson", "standard_normal", "msort",
    "positive", "float_power", "unstack", "vsplit", "hsplit", "dsplit",
    "as_strided", "view", "view_as", "unflatten", "unfold", "pdist",
    "cdist", "inv", "svd_lowrank", "eig", "eigvals", "lu", "lu_unpack",
]


# ------------------------------------------------------------ reductions

@defop("logcumsumexp")
def logcumsumexp(x, axis=None, dtype=None, name=None):
    x = tensor_of(x)
    if dtype is not None:
        x = x.to(dtype_mod.convert_dtype(dtype))
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, int(axis))


def _slice_axis(v, axis, start, stop):
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(start, stop)
    return v[tuple(idx)]


@defop("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1, name=None):
    y = tensor_of(y)
    avg = (_slice_axis(y, axis, 1, None) + _slice_axis(y, axis, 0, -1)) * 0.5
    if x is not None:
        return torch.cumsum(torch.diff(tensor_of(x), dim=axis) * avg, axis)
    return torch.cumsum(dx * avg, axis)


def _nan_over(x, axis, keepdim, fn):
    from .math import _flat_over, _keep

    flat, keep = _flat_over(x, None if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)))
    return fn(flat, keep)


@defop("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    """Median ignoring NaNs, the mean of the two middle values for an
    even count (jnp.nanmedian)."""
    from .math import _keep

    return _nan_over(tensor_of(x), axis, keepdim, lambda f, keep: _keep(
        torch.nanquantile(f, 0.5, dim=-1), keep, keepdim))


@defop("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    from .math import _keep

    x = tensor_of(x)
    qs = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return _nan_over(x, axis, keepdim, lambda f, keep: _keep(
        torch.nanquantile(f, qs, dim=-1), keep, keepdim,
        lead=tuple(qs.shape)))


# ------------------------------------------------------------- indexing

@defop("index_add")
def index_add(x, index, axis, value, name=None):
    """x with `value` added at `index` along `axis`."""
    x = tensor_of(x)
    return x.index_add(int(axis), tensor_of(index).long(),
                       tensor_of(value).to(x.dtype))


@defop("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    """x[indices] = value (+= with accumulate); a repeated index keeps
    the last write."""
    x = tensor_of(x)
    idx = tuple(tensor_of(i).long() if not tensor_of(i).dtype == torch.bool
                else tensor_of(i) for i in indices)
    v = operand(value, x).to(x.dtype)
    if accumulate or any(i.dtype == torch.bool for i in idx):
        return x.index_put(idx, v, accumulate=accumulate)
    b = torch.broadcast_tensors(*idx)
    v = v.broadcast_to(b[0].shape + x.shape[len(idx):])
    lin = torch.zeros_like(b[0])
    for d, i in enumerate(b):
        lin = lin * x.shape[d] + i % x.shape[d]
    from .manipulation import _last_writer

    rows = int(np.prod(x.shape[:len(idx)]))
    keep = _last_writer(lin.reshape(-1), rows)
    flat = x.reshape((rows,) + tuple(x.shape[len(idx):]))
    out = flat.index_put((lin.reshape(-1)[keep],),
                         v.reshape((-1,) + tuple(x.shape[len(idx):]))[keep])
    return out.reshape(x.shape)


@defop("take")
def take(x, index, mode="raise", name=None):
    """Gather from the flattened input. mode: "raise" and "clip" clip an
    out-of-range index, "wrap" wraps it."""
    x = tensor_of(x).reshape(-1)
    i = tensor_of(index).long()
    n = x.numel()
    return x[i % n if mode == "wrap" else i.clamp(0, n - 1)]


@defop("msort")
def msort(x, name=None):
    return torch.sort(tensor_of(x), dim=0, stable=True).values


# ------------------------------------------------------------ windowing

@defop("as_strided")
def as_strided(x, shape, stride, offset=0, name=None):
    """A copy of the elements at flat index offset + Σ i_d · stride_d."""
    x = tensor_of(x)
    shape = tuple(int(s) for s in shape)
    idx = torch.full(shape, int(offset), dtype=torch.long, device=x.device)
    for d, (sz, st) in enumerate(zip(shape, stride)):
        ar = torch.arange(sz, device=x.device) * int(st)
        idx = idx + ar.reshape((-1,) + (1,) * (len(shape) - d - 1))
    return x.reshape(-1)[idx]


@defop("unfold")
def unfold(x, axis, size, step, name=None):
    """Sliding windows of `size` every `step` along `axis`; the window
    becomes the trailing dim."""
    x = tensor_of(x)
    return x.unfold(int(axis) % x.ndim, int(size), int(step))


@defop("view")
def view(x, shape_or_dtype, name=None):
    """Reshape (a list / tuple) or reinterpret the bits as a dtype (a
    narrower one widens the last dim)."""
    x = tensor_of(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    return x.contiguous().view(dtype_mod.convert_dtype(shape_or_dtype))


@defop("view_as")
def view_as(x, other, name=None):
    return tensor_of(x).reshape(tuple(tensor_of(other).shape))


@defop("unflatten")
def unflatten(x, axis, shape, name=None):
    x = tensor_of(x)
    ax = int(axis) % x.ndim
    return x.reshape(tuple(x.shape[:ax]) + tuple(shape)
                     + tuple(x.shape[ax + 1:]))


@defop("unstack")
def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(tensor_of(x), dim=int(axis)))


def _np_style_split(opname, axis, min_nd):
    def op(x, num_or_indices, name=None):
        x = tensor_of(x)
        if x.ndim < min_nd:
            raise ValueError(f"{opname} needs at least {min_nd} dims")
        ax = 0 if (opname == "hsplit" and x.ndim == 1) else axis
        if isinstance(num_or_indices, int):
            return list(torch.tensor_split(x, num_or_indices, dim=ax)) \
                if x.shape[ax] % num_or_indices == 0 else _bad(opname)
        return list(torch.tensor_split(x, list(num_or_indices), dim=ax))

    op.__name__ = opname
    return defop(opname)(op)


def _bad(opname):
    raise ValueError(f"{opname}: array split does not result in an equal "
                     "division")


vsplit = _np_style_split("vsplit", 0, 2)
hsplit = _np_style_split("hsplit", 1, 1)
dsplit = _np_style_split("dsplit", 2, 3)


# ----------------------------------------------------------------- misc

@defop("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor_of(x), offset, axis1, axis2)


@defop("renorm")
def renorm(x, p, axis, max_norm, name=None):
    """Each slice along `axis` scaled to p-norm <= max_norm."""
    x = tensor_of(x)
    dims = tuple(d for d in range(x.ndim) if d != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    return x * factor


@defop("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(tensor_of(x), nan=nan, posinf=posinf,
                            neginf=neginf)


@defop("vander")
def vander(x, n=None, increasing=False, name=None):
    return torch.linalg.vander(tensor_of(x), N=n) if increasing else \
        torch.linalg.vander(tensor_of(x), N=n).flip(-1)


@defop("polygamma")
def polygamma(x, n, name=None):
    return torch.polygamma(int(n), tensor_of(x))


@defop("fmod")
def fmod(x, y, name=None):
    x = tensor_of(x)
    return torch.fmod(x, operand(y, x))


@defop("positive")
def positive(x, name=None):
    return tensor_of(x).clone()


@defop("float_power")
def float_power(x, y, name=None):
    """x ** y in float32, as the reference computes it."""
    x = tensor_of(x)
    return torch.pow(x.float(), operand(y, x).float())


@defop("histogramdd")
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    x = tensor_of(x)
    w = None if weights is None else tensor_of(weights)
    rng_ = None if ranges is None else [float(v) for pair in ranges
                                        for v in pair]
    h, edges = torch.histogramdd(x, bins=bins, range=rng_, weight=w,
                                 density=density)
    if not density and w is None:
        h = h.long()     # counts, in jnp's integer dtype
    return h, list(edges)


# -------------------------------------------------------------- complex

@defop("isreal")
def isreal(x, name=None):
    return torch.isreal(tensor_of(x))


@defop("as_complex")
def as_complex(x, name=None):
    """(..., 2) float → complex."""
    x = tensor_of(x)
    return torch.complex(x[..., 0], x[..., 1])


@defop("as_real")
def as_real(x, name=None):
    x = tensor_of(x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


# --------------------------------------------------------------- random

@defop("poisson")
def poisson(x, name=None):
    x = tensor_of(x).detach()
    return torch.poisson(x, generator=rng.next_generator(x.device))


@defop("standard_normal")
def standard_normal(shape, dtype=None, name=None):
    from .creation import randn

    return randn(shape, dtype=dtype)


# --------------------------------------------------------------- linalg

@defop("inv")
def inv(x, name=None):
    return torch.linalg.inv(tensor_of(x))


def _safe_p_norm(diff, p):
    """p-norm over the last axis with a zero gradient where the
    difference is 0 (the norm's own is NaN there)."""
    if p == float("inf"):
        return torch.amax(torch.abs(diff), dim=-1)
    if p == 0:
        return torch.sum((diff != 0).to(diff.dtype), dim=-1)
    sq = torch.sum(torch.abs(diff) ** p, dim=-1)
    nz = sq > 0
    safe = torch.where(nz, sq, 1.0)
    return torch.where(nz, safe ** (1.0 / p), 0.0)


@defop("pdist")
def pdist(x, p=2.0, name=None):
    """Condensed distances of the rows' i < j pairs."""
    x = tensor_of(x)
    iu, ju = np.triu_indices(x.shape[0], k=1)
    iu = torch.as_tensor(iu, device=x.device)
    ju = torch.as_tensor(ju, device=x.device)
    return _safe_p_norm(x[iu] - x[ju], p)


@defop("cdist")
def cdist(x, y, p=2.0, name=None):
    x, y = tensor_of(x), tensor_of(y)
    return _safe_p_norm(x[..., :, None, :] - y[..., None, :, :], p)


@defop("svd_lowrank")
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD: subspace iteration on a Gaussian sketch
    drawn from the port's generator; (U, S, V)."""
    xv = tensor_of(x).detach()
    if M is not None:
        xv = xv - tensor_of(M)
    m, n = xv.shape[-2], xv.shape[-1]
    q = min(q, m, n)
    omega = torch.randn(xv.shape[:-2] + (n, q), dtype=xv.dtype,
                        device=xv.device,
                        generator=rng.next_generator(xv.device))
    y = xv @ omega
    for _ in range(niter):
        y = xv @ (xv.transpose(-1, -2) @ y)
    Q, _ = torch.linalg.qr(y)
    B = Q.transpose(-1, -2) @ xv
    u, s, vh = torch.linalg.svd(B, full_matrices=False)
    return Q @ u, s, vh.transpose(-1, -2)


@defop("eig")
def eig(x, name=None):
    """General eigendecomposition (complex eigenvalues, eigenvectors)."""
    return tuple(torch.linalg.eig(tensor_of(x)))


@defop("eigvals")
def eigvals(x, name=None):
    return eig(x)[0]


@defop("lu")
def lu(x, pivot=True, get_infos=False, name=None):
    """Packed LU and 1-based int32 pivots (and a 0 info)."""
    x = tensor_of(x)
    lu_, piv = torch.linalg.lu_factor(x)
    outs = (lu_, piv.to(torch.int32))
    if get_infos:
        outs = outs + (torch.zeros((), dtype=torch.int32, device=x.device),)
    return outs


@defop("lu_unpack")
def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """(P, L, U) from the packed LU and its 1-based pivots (None for
    what is not unpacked)."""
    lu_v = tensor_of(lu_data)
    piv = tensor_of(lu_pivots).long() - 1
    m, n = lu_v.shape[-2], lu_v.shape[-1]
    k = min(m, n)
    L = torch.tril(lu_v[..., :, :k], -1) + torch.eye(
        m, k, dtype=lu_v.dtype, device=lu_v.device)
    U = torch.triu(lu_v[..., :k, :])
    batch = piv.shape[:-1]
    flat = piv.reshape(-1, piv.shape[-1]).cpu().tolist()
    perms = []
    for p1d in flat:
        perm = list(range(m))
        for i, j in enumerate(p1d):
            perm[i], perm[j] = perm[j], perm[i]
        perms.append(perm)
    perm = torch.tensor(perms, device=lu_v.device).reshape(batch + (m,))
    eye = torch.eye(m, dtype=lu_v.dtype, device=lu_v.device)
    P = eye[perm].transpose(-1, -2)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None,
            U if unpack_ludata else None)
