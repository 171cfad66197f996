from . import block_diag
from .linalg import (
    cholesky_upper,
    ichol,
    inv_tri_upper,
    log_det_tri,
    matmul,
    qr_r_positive,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
    syrk,
    tsqr_r,
)

__all__ = [
    "block_diag",
    "cholesky_upper",
    "ichol",
    "inv_tri_upper",
    "log_det_tri",
    "matmul",
    "qr_r_positive",
    "rows_sqr_norm",
    "solve_tri",
    "solve_tri_right",
    "syrk",
    "tsqr_r",
]
