from .linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)

__all__ = [
    "cholesky_upper",
    "inv_tri_upper",
    "log_det_tri",
    "matmul",
    "rows_sqr_norm",
    "solve_tri",
]
