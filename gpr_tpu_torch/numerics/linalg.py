"""Dense numerics core: the counterpart of ``gpr_tpu/numerics/linalg.py``.

Same conventions: inputs are row-major, X has shape (n, d); Cholesky factors
are UPPER triangular U with A = U^T U (LAPACK ``potrf uplo=U``).
"""

from __future__ import annotations

import torch

from ..config import apply_precision, config


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product under the configured precision policy."""
    apply_precision(config)
    return torch.matmul(a, b)


def cholesky_upper(a: torch.Tensor, jitter: float | None = None) -> torch.Tensor:
    """Upper-triangular U with ``a + jitter*I = U^T U``.

    Jitter defaults to ``config.cholesky_jitter``; in float32 it is raised to
    1e-5 of the mean absolute diagonal (the f32 rounding floor), as in the
    JAX package.  Pass ``jitter`` explicitly to override.  A matrix that is
    not positive definite gives NaN, as ``jnp.linalg.cholesky`` does, rather
    than an exception (so the call needs no device synchronisation).
    """
    if jitter is None:
        jitter = config.cholesky_jitter
        if a.dtype == torch.float32:
            diag_scale = torch.mean(
                torch.abs(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1
            )
            jitter = torch.clamp(1e-5 * diag_scale, min=jitter)
            jitter = jitter[..., None, None]
    if not (isinstance(jitter, (int, float)) and jitter == 0):
        # (no identity for a zero jitter: at the exact GP's n = 20,000 in
        # f64 each n x n temporary is 3.2 GB)
        a = a + jitter * torch.eye(a.shape[-1], dtype=a.dtype,
                                   device=a.device)
    u, info = torch.linalg.cholesky_ex(a, upper=True)
    failed = (info != 0)[..., None, None]
    return torch.where(failed, torch.full_like(u, float("nan")), u)


def log_det_tri(tri: torch.Tensor) -> torch.Tensor:
    """2 * sum(log diag) of a triangular Cholesky-like factor."""
    d = torch.diagonal(tri, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(d), dim=-1)


def solve_tri(tri: torch.Tensor, b: torch.Tensor, *, trans: bool = False,
              lower: bool = False) -> torch.Tensor:
    """Solve ``op(tri) x = b`` for triangular ``tri`` (default upper).

    ``b`` may be a vector, as for ``jax.scipy.linalg.solve_triangular``.
    ``trans=True`` solves against ``tri^T``, whose triangle is the other one.
    """
    vec = b.ndim == tri.ndim - 1
    rhs = b[..., None] if vec else b
    if trans:
        x = torch.linalg.solve_triangular(tri.mT, rhs, upper=lower)
    else:
        x = torch.linalg.solve_triangular(tri, rhs, upper=not lower)
    return x[..., 0] if vec else x


def solve_tri_right(b: torch.Tensor, tri: torch.Tensor, *, trans: bool = False,
                    lower: bool = False) -> torch.Tensor:
    """Solve ``x op(tri) = b``, i.e. ``x = b op(tri)^-1`` (right-side trsm)."""
    upper = lower if trans else not lower
    a = tri.mT if trans else tri
    return torch.linalg.solve_triangular(a, b, upper=upper, left=False)


def ichol(chol_u: torch.Tensor) -> torch.Tensor:
    """Full inverse of A from its upper Cholesky factor U (A = U^T U):
    A^-1 = U^-1 U^-T."""
    u_inv = inv_tri_upper(chol_u)
    return matmul(u_inv, u_inv.mT)


def inv_tri_upper(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular matrix (exactly upper triangular)."""
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return torch.linalg.solve_triangular(u, eye, upper=True)


def rows_sqr_norm(a: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms: diag(A A^T)."""
    return torch.sum(torch.square(a), dim=-1)


def syrk(a: torch.Tensor) -> torch.Tensor:
    """A^T A, the Gram matrix."""
    return matmul(a.mT, a)


def qr_r_positive(a: torch.Tensor) -> torch.Tensor:
    """R factor of a thin QR with the sign convention diag(R) > 0: then R
    is the unique upper Cholesky factor of A^T A.  The reduced mode, not
    ``mode="r"``, because only the former has a backward in PyTorch."""
    r = torch.linalg.qr(a, mode="reduced").R
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return r * sign[..., :, None]


def tsqr_r(a: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """R factor (positive diagonal) of an (n, m) matrix by a tall-skinny
    QR: one QR per row block, then one of the stacked R's.  Where
    ``n_blocks`` does not divide n, the plain ``qr_r_positive``."""
    n, m = a.shape
    if n % n_blocks != 0:
        return qr_r_positive(a)
    rs = torch.linalg.qr(a.reshape(n_blocks, n // n_blocks, m),
                         mode="reduced").R
    return qr_r_positive(rs.reshape(-1, m))
