"""Linear algebra ops (counterpart of paddle_tpu/ops/linalg.py).

`matmul`, `mm`, `bmm`, `dot` and `mv` are plain products, which the JAX
package too computes outside any Pallas kernel: `torch.matmul` (cuBLAS
on the card), cast under AMP by their names. The decompositions and
solvers are `torch.linalg`'s, with the reference's conventions:
`slogdet` stacks (sign, logabsdet), `svd` returns (U, S, Vh), `eigh`
reads the `UPLO` triangle, `cholesky_solve(x, y)` solves with the
factor `y`, `histogram` counts in int64 over [min, max] (the data's
range when both are 0).
"""
import torch

from ._helpers import cast, defop, tensor_of

__all__ = [
    "matmul", "mm", "bmm", "dot", "mv", "t", "norm", "dist", "cond_number",
    "cross", "histogram", "bincount", "matrix_power", "inverse", "pinv",
    "det", "slogdet", "svd", "qr", "eigh", "eigvalsh", "cholesky",
    "cholesky_solve", "solve", "triangular_solve", "lstsq", "matrix_rank",
    "multi_dot", "einsum", "corrcoef", "cov",
]


@defop("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = cast("matmul", tensor_of(x), tensor_of(y))
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@defop("mm")
def mm(input, mat2, name=None):
    return matmul(input, mat2)


@defop("bmm")
def bmm(x, y, name=None):
    return matmul(x, y)


@defop("dot")
def dot(x, y, name=None):
    x, y = cast("dot", tensor_of(x), tensor_of(y))
    return torch.sum(x * y, dim=-1)


@defop("mv")
def mv(x, vec, name=None):
    x, vec = cast("mv", tensor_of(x), tensor_of(vec))
    return x @ vec


@defop("t")
def t(input, name=None):
    x = tensor_of(input)
    if x.ndim < 2:
        return x.clone()
    return x.transpose(-1, -2)


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@defop("norm")
def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """Frobenius / p-norm over `axis` (every element when None), by the
    reference's formulas: inf / -inf the max / min of |x|, 0 the count
    of nonzeros, otherwise (Σ|x|^p)^(1/p)."""
    (x,) = cast("norm", tensor_of(x))
    ax = _ax(axis)
    dim = () if ax is None else ax
    if p == "fro":
        if ax is None:
            return torch.sqrt(torch.sum(x * x))
        return torch.sqrt(torch.sum(x * x, dim=ax, keepdim=keepdim))
    if p in (float("inf"), "inf"):
        return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if p in (float("-inf"), "-inf"):
        return torch.amin(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=ax, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=ax, keepdim=keepdim) ** (1.0 / p)


@defop("dist")
def dist(x, y, p=2, name=None):
    x, y = cast("dist", tensor_of(x), tensor_of(y))
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


@defop("cond")
def cond_number(x, p=None, name=None):
    return torch.linalg.cond(tensor_of(x), p)


@defop("cross")
def cross(x, y, axis=9, name=None):
    """Cross product along `axis` (the default 9: the first dim of size
    3)."""
    x, y = tensor_of(x), tensor_of(y)
    ax = axis if axis != 9 else next(
        (i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=ax)


@defop("histogram")
def histogram(input, bins=100, min=0, max=0, name=None):
    x = tensor_of(input)
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    xf = x.double()
    h = torch.histc(xf, bins=bins, min=lo, max=hi)
    return h.long()


@defop("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    x = tensor_of(x)
    w = None if weights is None else tensor_of(weights)
    return torch.bincount(x, w, minlength=minlength)


@defop("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(tensor_of(x), n)


@defop("inverse")
def inverse(x, name=None):
    return torch.linalg.inv(tensor_of(x))


@defop("pinv")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(tensor_of(x), rtol=rcond, hermitian=hermitian)


@defop("det")
def det(x, name=None):
    return torch.linalg.det(tensor_of(x))


@defop("slogdet")
def slogdet(x, name=None):
    sign, logabs = torch.linalg.slogdet(tensor_of(x))
    return torch.stack([sign, logabs], dim=0)


@defop("svd")
def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(tensor_of(x), full_matrices=full_matrices))


@defop("qr")
def qr(x, mode="reduced", name=None):
    out = torch.linalg.qr(tensor_of(x), mode=mode)
    return out.R if mode == "r" else tuple(out)


@defop("eigh")
def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(tensor_of(x), UPLO=UPLO))


@defop("eigvalsh")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(tensor_of(x), UPLO=UPLO)


@defop("cholesky")
def cholesky(x, upper=False, name=None):
    c = torch.linalg.cholesky(tensor_of(x))
    return c.transpose(-1, -2) if upper else c


@defop("cholesky_solve")
def cholesky_solve(x, y, upper=False, name=None):
    """Solve A z = x for A = L Lᵀ given its factor y (lower unless
    `upper`)."""
    return torch.cholesky_solve(tensor_of(x), tensor_of(y), upper=upper)


@defop("solve")
def solve(x, y, name=None):
    return torch.linalg.solve(tensor_of(x), tensor_of(y))


@defop("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = tensor_of(x), tensor_of(y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


@defop("lstsq")
def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), jnp.linalg.lstsq's
    tuple."""
    a, b = tensor_of(x), tensor_of(y)
    out = torch.linalg.lstsq(a, b, rcond=rcond, driver=driver or "gelsd")
    return out.solution, out.residuals, out.rank, out.singular_values


@defop("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(tensor_of(x), atol=tol,
                                    hermitian=hermitian)


@defop("multi_dot")
def multi_dot(x, name=None):
    return torch.linalg.multi_dot([tensor_of(t) for t in x])


@defop("einsum")
def einsum(equation, *operands):
    ts = cast("einsum", *(tensor_of(t) for t in operands))
    return torch.einsum(equation, *ts)


@defop("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    x = tensor_of(x)
    return torch.corrcoef(x if rowvar else x.T)


@defop("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = tensor_of(x)
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0)
