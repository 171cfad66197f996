"""The data-parallel iterative exact GP: the counterpart of
``gpr_tpu/parallel/iter_sharded.py`` (``models/iterative.py`` over a 1-D
mesh of ranks).

The rows of X and of every CG vector live on their rank.  The product
(K + sigma2 I) v couples every row with every other, so its cross-rank part
K(X_local, X_remote) v_remote travels a ring: each of P hops contracts the
local rows against one rank's (inputs, vector) block, one (block, n/P)
``k_cross`` tile at a time, then passes that block one rank on
(``DataMesh.ppermute``; P - 1 transfers of the (n/P, d) and (n/P, r)
blocks).  Nothing n x n exists anywhere.  The CG iteration is the port's
``pcg`` with its column sums all-reduced, and the Nystrom preconditioner
splits by rows with one all-reduced m x m Gram.

Each function runs on every rank of ``mesh`` and takes this rank's rows
(``parallel.sharded.shard_batch``).
"""

from __future__ import annotations

import torch

from ..kernels.base import cross_inputs
from ..models.iterative import _row_blocks, pcg
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from .spmd import DataMesh

__all__ = ["sharded_iter_solve"]


@torch.no_grad()
def _ring_matvec(kernel, mesh: DataMesh, xs, v, sigma2, mask,
                 block_size: int):
    """(K + sigma2 I) v over row shards by a P-hop ring.  ``xs`` (n/P, d),
    ``v`` (n/P, r) with its masked rows 0 (they then add nothing to any
    tile product); the output's masked rows are zeroed.  The diagonal is
    corrected to the model's prior variances plus noise from the first
    hop's tiles, whose columns are the local rows (as ``kernel_matvec``
    does)."""
    blocks = _row_blocks(xs.shape[0], block_size)
    out = torch.zeros_like(v)
    self_value = torch.empty(xs.shape[0], dtype=v.dtype, device=v.device)
    x_rot, v_rot = xs, v
    for hop in range(mesh.size):
        for start, stop in blocks:
            tile = cross_inputs(kernel, xs[start:stop], x_rot)
            if hop == 0:
                self_value[start:stop] = torch.diagonal(
                    tile[:, start:stop])
            out[start:stop] += matmul(tile, v_rot)
        if hop + 1 < mesh.size:
            x_rot, v_rot = mesh.ppermute(x_rot), mesh.ppermute(v_rot)
    out = out + (kernel.k_diag(xs) - self_value + sigma2)[:, None] * v
    return out * mask[:, None]


def _sharded_precond(kernel, mesh: DataMesh, xs, sigma2, x_sub, mask):
    """r -> P^-1 r of the row-split Nystrom/FITC preconditioner anchored at
    the replicated rows ``x_sub``; its m x m Gram is the one cross-rank
    object.  Masked rows get d = 1 and v = 0, so P is the identity there
    (and CG's residuals are 0 there anyway)."""
    km = kernel.k_upper_inputs(x_sub)
    u_inv = inv_tri_upper(cholesky_upper(km, None))
    v = matmul(cross_inputs(kernel, xs, x_sub), u_inv) * mask[:, None]
    lam = torch.clamp(kernel.k_diag(xs) - rows_sqr_norm(v), min=0.0)
    d = torch.where(mask > 0, lam + sigma2, 1.0)
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    chol_c = cholesky_upper(
        eye + mesh.allsum(matmul(v.T, v / d[:, None])), 0.0)

    def apply(r):
        squeeze = r.ndim == 1
        rr = r[:, None] if squeeze else r
        rd = rr / d[:, None]
        w = mesh.allsum(matmul(v.T, rd))
        w = solve_tri(chol_c, solve_tri(chol_c, w, trans=True))
        out = rd - matmul(v, w) / d[:, None]
        return out[:, 0] if squeeze else out

    return apply


@torch.no_grad()
def sharded_iter_solve(kernel, mesh: DataMesh, X, B, sigma2, X_sub,
                       mask=None, *, tol: float = 1e-6, max_iter: int = 200,
                       block_size: int = 4096):
    """Solve (K + sigma2 I) x = B over the mesh: ``X`` and ``B`` ((n/P,)
    or (n/P, r)) are this rank's rows, the anchor rows ``X_sub`` (m, d)
    replicated.  Returns (x, iters, relres) with x the ranks' solutions
    gathered in row order (P n/P rows, the padded rows zero) on every
    rank."""
    if mask is None:
        mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    squeeze = B.ndim == 1
    bs = (B[:, None] if squeeze else B) * mask[:, None]
    pre = _sharded_precond(kernel, mesh, X, sigma2, X_sub, mask)

    def mv(v):
        return _ring_matvec(kernel, mesh, X, v, sigma2, mask, block_size)

    x, info = pcg(mv, bs, precond=pre, tol=tol, max_iter=max_iter,
                  colsum=lambda t: mesh.allsum(torch.sum(t, dim=0)))
    x = mesh.all_gather(x)
    return (x[:, 0] if squeeze else x), info["iters"], info["relres"]
