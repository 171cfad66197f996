"""PITC evidence: the partially-independent training conditional.  The
counterpart of ``gpr_tpu/models/pitc.py``.

PITC generalizes FITC's diagonal train-conditional correction to block
diagonal: within each block of training rows the exact covariance is kept,

  cov(y) = Q + S,   Q = Knm Km^-1 Kmn,
  S = blkdiag_b(K_bb - Q_bb) + sigma2 I.

``block_size=1`` is FITC; one block covering all n rows is the exact GP.
Each block is whitened by the inverse Cholesky factor of its (b, b)
conditional S_b, and the whitened tiles fold into the same O(m^2)
statistics as the FITC streaming pass, so the epilogue and the predictors
of ``models/streaming.py`` serve PITC unchanged:

  G     = sum_b (U_b^-T V_b)' (U_b^-T V_b),   u = sum_b (U_b^-T V_b)' (U_b^-T y_b)
  lds   = sum_b 2 log|diag U_b|,              yiy = sum_b |U_b^-T y_b|^2.

The block size IS the PITC partition, a modelling choice.  Where the JAX
package scans one block a step, this loop takes a chunk of whole blocks a
step (``CHUNK_ROWS`` rows, at least one block): one batched (c, b, b)
Cholesky and batched triangular solves per chunk, each chunk under
``torch.utils.checkpoint`` when a gradient will be taken (JAX's
``remat=True``), so autograd holds no S_b.  The chunk changes no block.
Gradients are autograd's, as the JAX package's are AD.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    solve_tri,
)
from .fitc import calc_inducing
from .stream_grad import _accumulate, _pad_blocks, _zero_carry
from .streaming import (
    StreamStats,
    _dewhiten,
    _whitened_solve,
    evidence_from_stats,
)

#: rows of blocks a step takes (whole blocks; at least one)
CHUNK_ROWS = 16_384


def _chunk_terms(kernel, z, u_inv, sigma2, x_c, y_c, mask_c, jitter):
    """The statistics of a chunk of c blocks: x_c (c, b, d), y_c and mask_c
    (c, b).  Padded rows decouple exactly: their rows and columns of S are
    zero and their diagonal 1."""
    c, b, d = x_c.shape
    m = z.shape[0]
    x_c = x_c.to(z.dtype)
    y_c = y_c.to(z.dtype) * mask_c
    flat = x_c.reshape(c * b, d)
    knm = kernel.k_cross(flat, z)
    kd = kernel.k_diag(flat).reshape(c, b)
    v = (matmul(knm, u_inv) * mask_c.reshape(-1, 1)).reshape(c, b, m)
    # the exact within-block covariance from the data-side gram
    # (k_upper_inputs, not k_cross of raw rows: see the JAX module), with
    # the family's exact diagonal; batched over the chunk's blocks
    kbb = torch.func.vmap(kernel.k_upper_inputs)(x_c)
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    kbb = torch.where(eye, kd[:, :, None], kbb)
    live2 = mask_c[:, :, None] * mask_c[:, None, :]
    s_mat = (kbb - matmul(v, v.mT)) * live2
    s_diag = torch.where(mask_c > 0, sigma2, torch.ones_like(mask_c))
    s_mat = s_mat + torch.where(eye, s_diag[:, :, None],
                                torch.zeros_like(s_mat))
    u_b = cholesky_upper(s_mat, jitter=jitter)  # S_b = U_b' U_b
    a = solve_tri(u_b, v, trans=True).reshape(c * b, m)  # U_b^-T V_b
    w = solve_tri(u_b, y_c, trans=True).reshape(c * b)  # U_b^-T y_b
    return (matmul(a.T, a), matmul(a.T, w), torch.sum(log_det_tri(u_b)),
            torch.dot(w, w), torch.sum(mask_c))


def pitc_stream_stats(kernel, inducing, sigma2, X, y, *,
                      block_size: int = 256, mask=None, remat: bool = True,
                      jitter: float = 0.0) -> StreamStats:
    """PITC's StreamStats over blocks of ``block_size`` rows (the
    partition), ``CHUNK_ROWS // block_size`` blocks (at least one) a step.
    ``mask`` (n,) of 0/1 weights excludes rows; ``jitter`` applies to each
    block conditional.  In f32 the chunks' sums are two-sum compensated."""
    z = inducing.z
    m = z.shape[0]
    u_inv = inv_tri_upper(inducing.chol_km)
    xb, yb, maskb = _pad_blocks(X, y, mask, block_size)
    maskb = maskb.to(z.dtype)
    sigma2 = torch.as_tensor(sigma2, dtype=z.dtype, device=z.device)
    step = max(1, CHUNK_ROWS // block_size)
    comp = z.dtype == torch.float32
    carry = _zero_carry([(m, m), (m,), (), (), ()], z.dtype, z.device)
    grad = torch.is_grad_enabled()
    for i in range(0, xb.shape[0], step):
        args = (kernel, z, u_inv, sigma2, xb[i:i + step], yb[i:i + step],
                maskb[i:i + step], jitter)
        if remat and grad:
            terms = checkpoint(_chunk_terms, *args, use_reentrant=False)
        else:
            terms = _chunk_terms(*args)
        carry = _accumulate(carry, terms, comp)
    gram, u_vec, lds, yiy, cnt = (hi + lo for hi, lo in carry)
    return StreamStats(gram=gram, u_vec=u_vec, log_det_s=lds, y_is_y=yiy,
                       is_r_sum=torch.zeros_like(lds), n=cnt)


def pitc_log_evidence(kernel, z, sigma2, X, y, *, block_size: int = 256,
                      jitter: float | None = None,
                      block_jitter: float = 0.0) -> torch.Tensor:
    """PITC log marginal likelihood, differentiable in the kernel's hypers,
    ``z`` and ``sigma2``.  ``block_size`` is the partition (1 gives the
    FITC evidence, >= n the exact GP); ``jitter`` applies to Km,
    ``block_jitter`` to each block conditional (default 0: the noise
    already regularizes S_b)."""
    inducing = calc_inducing(kernel, z, jitter)
    stats = pitc_stream_stats(kernel, inducing, sigma2, X, y,
                              block_size=block_size, jitter=block_jitter)
    return evidence_from_stats(inducing, stats, variational=False)


@torch.no_grad()
def pitc_coeffs(kernel, z, sigma2, X, y, *, block_size: int = 256,
                jitter: float | None = None, block_jitter: float = 0.0):
    """(inducing, r_mat, coeffs) for PITC prediction: its test conditional
    is FIC's, so ``predict_means_blocked`` and
    ``predict_variances_blocked`` take these directly."""
    inducing = calc_inducing(kernel, z, jitter)
    stats = pitc_stream_stats(kernel, inducing, sigma2, X, y,
                              block_size=block_size, jitter=block_jitter)
    r_tilde, t = _whitened_solve(inducing, stats)
    coeffs, r_mat = _dewhiten(inducing, r_tilde, t)
    return inducing, r_mat, coeffs
