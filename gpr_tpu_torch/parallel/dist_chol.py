"""Distributed block Cholesky and triangular solves over the model axis of
a 2-D mesh: the counterpart of ``gpr_tpu/parallel/dist_chol.py``.

A symmetric m x m matrix lives as column blocks: member j of the model
axis (a :class:`~.spmd.DataMesh` of p ranks, ``mesh.rank`` = j) holds
A[:, j m_t:(j+1) m_t], m = p m_t, and no member ever holds m x m.

  * :func:`dist_cholesky_upper` factors A into upper R with R'R = A, one
    block column a member: right-looking over p block steps, each with one
    all-reduce that broadcasts the (m_t, m_t) diagonal block and one
    all-gather of the (m_t, m) row block of R.
  * :func:`dist_solve_lower_t` forward-substitutes R' t = u, broadcasting
    each solved (m_t,) piece; :func:`dist_solve_lower_cols` and
    :func:`dist_solve_upper_cols` solve each member's own right-hand
    columns; :func:`dist_spd_inverse_cols` gives column blocks of A^-1.
  * :func:`dist_transpose_cols` turns column blocks of W into those of W'
    by p - 1 ring shifts; :func:`dist_whiten_cols` and
    :func:`whiten_cols_replicated` form U^-T G U^-1 around it.

Every member runs every step with the same operations and selects with
masks (the JAX package's uniform SPMD): at step k each member solves
R_kj = R_kk^-T S_kj on its own slab, which for the owner (j == k) is
R_kk itself, and members left of the diagonal mask it to zero.  In the
port this also keeps every collective's input in every rank's autograd
graph, so the backward's collectives meet on every rank.  Non-owners of a
diagonal solve take an identity system with a zero right-hand side (the
double-where: a masked but NaN primal would poison the gradient).
"""

from __future__ import annotations

import torch

from ..numerics.linalg import cholesky_upper, log_det_tri, matmul, solve_tri
from .spmd import DataMesh

__all__ = [
    "dist_cholesky_upper",
    "dist_log_det_tri",
    "dist_solve_lower_cols",
    "dist_solve_lower_t",
    "dist_solve_upper_cols",
    "dist_spd_inverse_cols",
    "dist_transpose_cols",
    "dist_whiten_cols",
    "whiten_cols_replicated",
]


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    """A 0-d bool tensor on ``like``'s device, for ``torch.where``."""
    return torch.tensor(value, device=like.device)


def _eye_cols(mesh: DataMesh, m: int, m_t: int, like: torch.Tensor):
    """This member's (m, m_t) column block of the identity."""
    rows = torch.arange(m, device=like.device)[:, None]
    cols = mesh.rank * m_t + torch.arange(m_t, device=like.device)[None, :]
    return (rows == cols).to(like.dtype)


def dist_cholesky_upper(a_j: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Column block R_j of upper R with R'R = A, from this member's (m,
    m_t) column block ``a_j`` of symmetric positive definite A.  Requires
    m == p m_t."""
    m, m_t = a_j.shape
    p, j = mesh.size, mesh.rank
    if m != p * m_t:
        raise ValueError(f"column block {tuple(a_j.shape)} inconsistent "
                         f"with p={p}")
    s_j, blocks = a_j, []
    for k in range(p):
        s_kj = s_j[k * m_t:(k + 1) * m_t]
        # the owner's diagonal block, broadcast by an all-reduce of a mask
        dkk = mesh.allsum(torch.where(_flag(j == k, a_j), s_kj, 0.0))
        r_kk = cholesky_upper(dkk, jitter=0.0)
        r_kj = solve_tri(r_kk, s_kj, trans=True)  # == r_kk when j == k
        r_kj = torch.where(_flag(j >= k, a_j), r_kj, 0.0)
        blocks.append(r_kj)
        if k + 1 < p:
            # row block R_k (pieces left of the diagonal are 0)
            r_k = mesh.all_gather(r_kj, dim=1)  # (m_t, m)
            s_j = s_j - matmul(r_k.T, r_kj)
    return torch.cat(blocks)


def dist_log_det_tri(r_j: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """log det(R'R) = 2 sum log diag(R) from column blocks."""
    m_t = r_j.shape[1]
    j = mesh.rank
    return mesh.allsum(log_det_tri(r_j[j * m_t:(j + 1) * m_t]))


def dist_solve_lower_cols(r_j: torch.Tensor, b_own: torch.Tensor,
                          mesh: DataMesh) -> torch.Tensor:
    """Y with R' Y = B (forward substitution), R upper as column blocks
    (m, m_t); ``b_own`` (m, k) is this member's own right-hand columns.
    Row block k of R' is member k's column block transposed, broadcast a
    step."""
    m_t = r_j.shape[1]
    p, j = mesh.size, mesh.rank
    ys = []
    for k in range(p):
        rc_k = mesh.allsum(torch.where(_flag(j == k, r_j), r_j, 0.0))
        rhs = b_own[k * m_t:(k + 1) * m_t]
        if k:
            # sum_{i<k} R_ik' Y_i over the solved rows
            rhs = rhs - matmul(rc_k[:k * m_t].T, torch.cat(ys))
        ys.append(solve_tri(rc_k[k * m_t:(k + 1) * m_t], rhs, trans=True))
    return torch.cat(ys)


def dist_solve_upper_cols(r_j: torch.Tensor, b_own: torch.Tensor,
                          mesh: DataMesh) -> torch.Tensor:
    """X with R X = B (back substitution), the layout of
    :func:`dist_solve_lower_cols`.  Row block k of R is gathered (each
    member gives its (m_t, m_t) piece)."""
    m_t = r_j.shape[1]
    p = mesh.size
    xs = []
    for k in reversed(range(p)):
        r_k = mesh.all_gather(r_j[k * m_t:(k + 1) * m_t], dim=1)  # (m_t, m)
        rhs = b_own[k * m_t:(k + 1) * m_t]
        if xs:
            # only the solved (higher) rows contribute
            rhs = rhs - matmul(r_k[:, (k + 1) * m_t:], torch.cat(xs))
        xs.insert(0, solve_tri(r_k[:, k * m_t:(k + 1) * m_t], rhs))
    return torch.cat(xs)


def dist_spd_inverse_cols(a_chol_j: torch.Tensor,
                          mesh: DataMesh) -> torch.Tensor:
    """Column block of A^-1 from A's distributed Cholesky factor:
    P_j = U^-1 U^-T I_j by the two distributed solves (the fully
    distributed inducing factorization's Km^-1 columns)."""
    m, m_t = a_chol_j.shape
    y = dist_solve_lower_cols(a_chol_j, _eye_cols(mesh, m, m_t, a_chol_j),
                              mesh)
    return dist_solve_upper_cols(a_chol_j, y, mesh)


def dist_transpose_cols(w_j: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Column blocks of W -> column blocks of W' by a ring.

    Member j holds W[:, cols_j] and needs W'[:, cols_j], the row slab
    W[rows_j, :] transposed, whose chunk (rows_j, cols_k) lives on member
    k.  Shift t (t = 1 .. p-1): each member sends its chunk rows_{(j+t)%p}
    t ranks up the ring and files the one it receives under column block
    (j-t) % p: m^2 / p numbers a member in all.  The backward is the
    inverted ring."""
    m_t = w_j.shape[1]
    p, j = mesh.size, mesh.rank
    slab = [None] * p
    for t in range(p):
        send = ((j + t) % p) * m_t
        slab[(j - t) % p] = mesh.ppermute(w_j[send:send + m_t], shift=t)
    return torch.cat(slab, dim=1).T


def dist_whiten_cols(u_j: torch.Tensor, g_j: torch.Tensor,
                     mesh: DataMesh) -> torch.Tensor:
    """Column blocks of the two-sided whitening U^-T G U^-1 (G symmetric,
    U upper with U'U = Km) from column blocks of U and G: two distributed
    forward substitutions around one distributed transpose, since with
    W = U^-T G, U^-T W' = U^-T G U^-1."""
    w_j = dist_solve_lower_cols(u_j, g_j, mesh)
    return dist_solve_lower_cols(u_j, dist_transpose_cols(w_j, mesh), mesh)


def whiten_cols_replicated(chol_km: torch.Tensor, g_j: torch.Tensor,
                           mesh: DataMesh) -> torch.Tensor:
    """Column blocks of U^-T G U^-1 where U = chol_km is replicated (the
    replicated inducing modes): the two solves are local, only the
    transpose moves data."""
    w_j = solve_tri(chol_km, g_j, trans=True)
    return solve_tri(chol_km, dist_transpose_cols(w_j, mesh), trans=True)


def dist_solve_lower_t(r_j: torch.Tensor, u: torch.Tensor,
                       mesh: DataMesh) -> torch.Tensor:
    """t with R' t = u (forward substitution), R as column blocks; ``u``
    (m,) and t replicated.  Member k solves its own diagonal system and
    broadcasts the solved piece (m_t numbers a step)."""
    m_t = r_j.shape[1]
    p, j = mesh.size, mesh.rank
    eye = torch.eye(m_t, dtype=r_j.dtype, device=r_j.device)
    ts = []
    for k in range(p):
        rhs = u[k * m_t:(k + 1) * m_t]
        if k:
            # member k: R[0:k rows, k col-block]' t[0:k] from its own block
            rhs = rhs - matmul(r_j[:k * m_t].T, torch.cat(ts))
        owner = _flag(j == k, r_j)
        t_k = solve_tri(torch.where(owner, r_j[k * m_t:(k + 1) * m_t], eye),
                        torch.where(owner, rhs, 0.0), trans=True)
        ts.append(mesh.allsum(torch.where(owner, t_k, 0.0)))
    return torch.cat(ts)
