"""paddle.linalg namespace (counterpart of paddle_tpu/linalg.py).

A re-export layer over ops/linalg.py and ops/extras.py with the
reference's export list, including `cond` (the condition number; the
tensor API's `cond` is control flow) and `inv`.
"""
from .ops.extras import eig, eigvals, inv, lu, lu_unpack  # noqa: F401
from .ops.linalg import (  # noqa: F401
    cholesky,
    cholesky_solve,
    corrcoef,
    cov,
    det,
    eigh,
    eigvalsh,
    lstsq,
    matrix_power,
    matrix_rank,
    multi_dot,
    norm,
    pinv,
    qr,
    slogdet,
    solve,
    svd,
    triangular_solve,
)
from .ops.linalg import cond_number as cond  # noqa: F401

__all__ = [
    "cholesky", "norm", "eig", "cov", "corrcoef", "cond", "matrix_power",
    "solve", "cholesky_solve", "inv", "eigvals", "multi_dot", "matrix_rank",
    "svd", "eigvalsh", "qr", "lu", "lu_unpack", "eigh", "det", "slogdet",
    "pinv", "triangular_solve", "lstsq",
]
