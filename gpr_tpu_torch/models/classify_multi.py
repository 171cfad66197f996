"""Multi-class GP classification: the softmax Laplace over the FITC prior.
The counterpart of ``gpr_tpu/models/classify_multi.py``.

C latent functions over one shared FITC prior (one kernel, one inducing
set: the per-class priors are i.i.d., so V and d are computed once), the
softmax likelihood, and Laplace at the mode (GPML section 3.5, algorithm
3.3).  The softmax Hessian couples the classes at each point, W = D -
Pi Pi' (singular: each row of pi sums to 1), so (K + W^-1)^-1 goes through
the per-class E_c = (K + D_c^-1)^-1, each an m-space Woodbury,

  E_c x = q_c x - q_c V R_c^-1 R_c^-T V'(q_c x),   q_c = pi_c/(1 + pi_c d),
  R_c'R_c = I_m + V' diag(q_c) V,

and the coupling factor sum_c E_c = diag(Qbar) - G G' with
G = [diag(q_c) V R_c^-1]_c of rank Cm, whose inverse needs one (Cm, Cm)
Cholesky of H = I - G' Qbar^-1 G.  The evidence's determinant:

  log|I + K W| = sum_c [sum_i log1p(pi_ci d_i) + log|R_c'R_c|]
                 + sum_i log Qbar_i + log|H|.

Each Newton step takes the exact concave line maximum along the step (25
bisections on 0-d device tensors).  Hyper gradients are implicit by default
(``SoftmaxFixedPoint``, the coupled-W analogue of ``ift.LaplaceFixedPoint``:
one (I + K W)^-1 apply and one ``torch.autograd.grad``); ``grad_impl=
"unroll"`` differentiates through the iteration, each step under
``torch.utils.checkpoint``.

The entry points run the Newton steps, the backward's solve and the
m-space epilogue (the evidence's factors, the predictor state) in
``ift.MODE_DTYPE`` on the rows' V and d (``classify.prior_up``) and return
in the rows' dtype; the JAX package computes in the rows' dtype, where f32
Newton steps at bench's 10^6 rows end far from the mode
(``chip_smoke.py``'s classify_ext ablation).  Products over the rows take
8,192-row partial sums (``ift.tmatmul``).  Where the JAX package maps over
the m columns of an (n, m) matrix or over the classes, the port takes a
panel: ``_apply_coupling_inv`` applies to an (n, k) panel, and the
per-class triangular solves run batched on (C, m, m) stacks.  Class
probabilities are a Monte Carlo average over draws from a
``torch.Generator`` (``mc_softmax_probs``), not JAX's key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..numerics.linalg import (
    cholesky_upper,
    log_det_tri,
    matmul,
    solve_tri,
)
from .classify import fit_laplace, no_sigma2, prior_up
from .ift import LINE_BISECTIONS, _identity, grads_or_zeros, tmatmul, up

#: test points a chunk of the Monte Carlo class probabilities
MC_CHUNK = 8192


def _pairs(n_c):
    return [(c, c2) for c in range(n_c) for c2 in range(c, n_c)]


def _msolve(r, t):
    return solve_tri(r, solve_tri(r, t, trans=True))


def _per_class_factors(v, q, allsum):
    """(R_c, P_c = V' diag(q_c) V) for every class, as (C, m, m) stacks;
    ``q`` (n, C) nonnegative, 0 on masked rows."""
    m = v.shape[1]
    p_all = torch.stack([allsum(tmatmul(v * q[:, c:c + 1], v))
                         for c in range(q.shape[1])])
    p_all = 0.5 * (p_all + p_all.mT)
    eye = torch.eye(m, dtype=v.dtype, device=v.device)
    return cholesky_upper(eye + p_all, jitter=0.0), p_all


def _apply_e(v, q, r_all, x, allsum):
    """E_c x_c column by column for (n, C) x (or (n, 1), broadcast):
    E_c x = q_c x - q_c V R_c^-1 R_c^-T V'(q_c x)."""
    qx = q * x
    t = allsum(tmatmul(v, qx))  # (m, C)
    return qx - q * matmul(v, _msolve(r_all, t.T).T)


def _coupling_blocks(r_all, w_of):
    """H = I_Cm - G' Qbar^-1 G from the coupling Grams ``w_of(k)`` =
    V' diag(q_c q_c' / Qbar) V of pair k = (c, c'): block (c, c') is
    R_c^-T W_cc' R_c'^-1.  Returns H's upper Cholesky."""
    n_c, m = r_all.shape[0], r_all.shape[1]
    blocks = [[None] * n_c for _ in range(n_c)]
    for k, (c, c2) in enumerate(_pairs(n_c)):
        g = solve_tri(r_all[c], w_of(k), trans=True)  # R_c^-T W
        g = solve_tri(r_all[c2], g.T, trans=True).T  # ... R_c'^-1
        blocks[c][c2] = g
        if c2 != c:
            blocks[c2][c] = g.T
    gqg = torch.cat([torch.cat(row, dim=1) for row in blocks], dim=0)
    h = (torch.eye(n_c * m, dtype=r_all.dtype, device=r_all.device)
         - 0.5 * (gqg + gqg.T))
    return cholesky_upper(h, jitter=0.0)


def _coupling_chol(v, q, qbar_inv, r_all, allsum):
    """H's upper Cholesky from the rows: C(C+1)/2 weighted Grams."""
    def w_of(k):
        c, c2 = _pairs(q.shape[1])[k]
        w = q[:, c] * q[:, c2] * qbar_inv
        return allsum(tmatmul(v * w[:, None], v))

    return _coupling_blocks(r_all, w_of)


def _coupling_solve(r_all, h_chol, gt):
    """(C, m, k) stack w_c = R_c^-1 [H^-1 (R^-T gt)]_c from the (C, m, k)
    stack gt_c = V'(q_c Qbar^-1 x): the m-space middle of
    ``_apply_coupling_inv``, class-major as H's blocks."""
    n_c, m, k = gt.shape
    w = solve_tri(r_all, gt, trans=True).reshape(n_c * m, k)
    w = _msolve(h_chol, w).reshape(n_c, m, k)
    return solve_tri(r_all, w)


def _apply_coupling_inv(v, q, qbar_inv, r_all, h_chol, x, allsum):
    """(sum_c E_c)^-1 x = Qbar^-1 x + Qbar^-1 G H^-1 G' Qbar^-1 x for an
    (n,) vector or an (n, k) panel ``x``."""
    vec = x.ndim == 1
    qx = qbar_inv[:, None] * (x[:, None] if vec else x)
    n_c = q.shape[1]
    gt = torch.stack([allsum(tmatmul(v, q[:, c:c + 1] * qx))
                      for c in range(n_c)])  # (C, m, k)
    gw = _coupling_solve(r_all, h_chol, gt)
    g_w = sum(q[:, c:c + 1] * matmul(v, gw[c]) for c in range(n_c))
    out = qx + qbar_inv[:, None] * g_w
    return out[:, 0] if vec else out


def _kdot(v, d, x, allsum=_identity):
    """K x column by column, K = V V' + diag(d)."""
    return matmul(v, allsum(tmatmul(v, x))) + d[:, None] * x


def row_weights(f, d, mask):
    """(pi, q, qbar_inv) at the latent ``f`` (..., C) over the rows' ``d``
    and ``mask`` (...,): q_c = pi_c / (1 + pi_c d), qbar_inv = 1/sum_c q_c,
    masked rows zeroed."""
    pi = torch.softmax(f, dim=-1) * mask[..., None]
    q = pi / (1.0 + pi * d[..., None])
    qbar = torch.sum(q, dim=-1)
    qbar_inv = torch.where(mask > 0, 1.0 / torch.where(qbar > 0, qbar, 1.0),
                           0.0)
    return pi, q, qbar_inv


def _mode_weights(v, d, f_hat, mask, allsum):
    """(pi, q, qbar_inv, r_all, h_chol) at a latent: the factors the
    epilogue and the backward share."""
    pi, q, qbar_inv = row_weights(f_hat, d, mask)
    r_all, _ = _per_class_factors(v, q, allsum)
    h_chol = _coupling_chol(v, q, qbar_inv, r_all, allsum)
    return pi, q, qbar_inv, r_all, h_chol


@torch.no_grad()
def softmax_line_max(f, f_n, a, a_n, y1h, mask, allsum=_identity):
    """The step s in [0, 1] of the exact concave line maximum along
    a_s = (1 - s) a + s a_n: Psi is elementwise in the cached (f, f_n) up
    to three dot products, so each of the LINE_BISECTIONS probes of dPsi/ds
    is one pass over the (..., C) rows, on the device."""
    aff = allsum(torch.sum(a * f))
    afn = allsum(torch.sum(a * f_n))
    ann = allsum(torch.sum(a_n * f_n))
    df = f_n - f

    def dpsi(s):
        pi_s = torch.softmax(f + s * df, dim=-1)
        quad_p = (-2.0 * (1.0 - s) * aff + (2.0 - 4.0 * s) * afn
                  + 2.0 * s * ann)
        lik_p = allsum(torch.sum(mask[..., None] * (y1h - pi_s) * df))
        return -0.5 * quad_p + lik_p

    lo = torch.zeros((), dtype=f.dtype, device=f.device)
    hi = torch.ones((), dtype=f.dtype, device=f.device)
    for _ in range(LINE_BISECTIONS):
        mid = 0.5 * (lo + hi)
        pos = dpsi(mid) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return torch.where(dpsi(one) >= 0, one, lo)


def _newton_step(v, d, y1h, mask, f, a, allsum):
    """One softmax Newton step (GPML algorithm 3.3 through the m-space
    factors) with the exact line maximum; the new (f, a)."""
    pi, q, qbar_inv = row_weights(f, d, mask)
    grad = (y1h - pi) * mask[:, None]
    # W f per point: diag(pi) f - pi (pi . f)
    wf = pi * f - pi * torch.sum(pi * f, dim=1, keepdim=True)
    b = (wf + grad) * mask[:, None]

    r_all, _ = _per_class_factors(v, q, allsum)
    h_chol = _coupling_chol(v, q, qbar_inv, r_all, allsum)
    c_vec = _apply_e(v, q, r_all, _kdot(v, d, b, allsum), allsum)
    t = _apply_coupling_inv(v, q, qbar_inv, r_all, h_chol,
                            torch.sum(c_vec, dim=1), allsum)
    a_n = b - c_vec + _apply_e(v, q, r_all, t[:, None], allsum)
    f_n = _kdot(v, d, a_n, allsum)
    s = softmax_line_max(f, f_n, a, a_n, y1h, mask, allsum)
    return (1.0 - s) * f + s * f_n, (1.0 - s) * a + s * a_n


def softmax_newton_scan(v, d, y_onehot, mask, *, newton_iters: int = 15,
                        allsum=_identity):
    """Newton mode-finding for the softmax Laplace over the rows.

    ``y_onehot`` (n, C); ``mask`` zeroes padded rows; ``allsum`` reduces the
    cross-row sums (identity on one device).  The steps run in
    ``ift.MODE_DTYPE`` on V, d and the labels cast to it (casts autograd
    differentiates), each under ``torch.utils.checkpoint`` where autograd
    records.  Returns (f_hat, a), both (n, C) in the rows' dtype, f_hat =
    K a column by column."""
    dtype = mask.dtype
    v, d, y_onehot, mask = (up(t) for t in (v, d, y_onehot, mask))
    f = torch.zeros_like(y_onehot)
    a = torch.zeros_like(y_onehot)
    remat = torch.is_grad_enabled()
    for _ in range(newton_iters):
        if remat:
            f, a = checkpoint(_newton_step, v, d, y_onehot, mask, f, a,
                              allsum, use_reentrant=False)
        else:
            f, a = _newton_step(v, d, y_onehot, mask, f, a, allsum)
    return f.to(dtype), a.to(dtype)


def _m_apply(v, q, qbar_inv, r_all, h_chol, x, allsum):
    """M x with M = (K + W^-1)^-1 = E - E 1 (sum_c E_c)^-1 1' E (GPML
    algorithm 3.3's inverse); also M = W (I + K W)^-1, defined for the
    singular W."""
    ex = _apply_e(v, q, r_all, x, allsum)
    t = _apply_coupling_inv(v, q, qbar_inv, r_all, h_chol,
                            torch.sum(ex, dim=1), allsum)
    return ex - _apply_e(v, q, r_all, t[:, None], allsum)


def softmax_ift_solve(v, d, y1h, mask, a, abar, allsum=_identity):
    """u = (I + K W)^-1 abar at the mode a, with one round of iterative
    refinement, in ``ift.MODE_DTYPE``, returned in abar's dtype."""
    v, d, mask, a, x = (up(t) for t in (v, d, mask, a, abar))
    pi, q, qbar_inv, r_all, h_chol = _mode_weights(
        v, d, _kdot(v, d, a, allsum), mask, allsum)

    def wdot(x):
        # W x per row: diag(pi) x - pi (pi . x), masked
        return (pi * x - pi * torch.sum(pi * x, dim=1, keepdim=True)
                ) * mask[:, None]

    def solve(x):
        # (I + K W)^-1 x = x - K M x
        return x - _kdot(v, d, _m_apply(v, q, qbar_inv, r_all, h_chol, x,
                                        allsum), allsum)

    u = solve(x)
    # one round of iterative refinement, as in the binary core
    u = u + solve(x - (u + _kdot(v, d, wdot(u), allsum)))
    return u.to(abar.dtype)


class SoftmaxFixedPoint(torch.autograd.Function):
    """(allsum, newton_iters, v, d, y1h, mask) -> a at the softmax Laplace
    mode, with the implicit gradient: theta_bar = (dF/dtheta)' u,
    u = (I + K W)^-1 abar, F = mask (y1h - softmax(K a)) - a at fixed a.
    v and d get one ``torch.autograd.grad``, y1h the identity block
    mask u, mask None."""

    @staticmethod
    def forward(ctx, allsum, newton_iters, v, d, y1h, mask):
        _, a = softmax_newton_scan(v, d, y1h, mask, newton_iters=newton_iters,
                                   allsum=allsum)
        ctx.allsum = allsum
        ctx.save_for_backward(v, d, y1h, mask, a)
        return a

    @staticmethod
    @once_differentiable
    def backward(ctx, abar):
        v, d, y1h, mask, a = ctx.saved_tensors
        allsum = ctx.allsum
        a = a.detach()
        u = softmax_ift_solve(v, d, y1h, mask, a, abar, allsum)
        with torch.enable_grad():
            v_ = v.detach().requires_grad_(True)
            d_ = d.detach().requires_grad_(True)
            g = (y1h - torch.softmax(_kdot(v_, d_, a, allsum), dim=1)
                 ) * mask[:, None]
            vbar, dbar = grads_or_zeros(g, [v_, d_], u)
        return None, None, vbar, dbar, mask[:, None] * u, None


def softmax_mode(v, d, y_onehot, mask, *, newton_iters: int = 15,
                 allsum=_identity, grad_impl: str = "ift"):
    """(f_hat, a) at the softmax Laplace mode; ``grad_impl`` "ift" (default)
    or "unroll", as in ``models/ift.py``."""
    if grad_impl == "ift":
        a = SoftmaxFixedPoint.apply(allsum, newton_iters, v, d, y_onehot,
                                    mask)
        return _kdot(v, d, a, allsum), a
    if grad_impl == "unroll":
        return softmax_newton_scan(v, d, y_onehot, mask,
                                   newton_iters=newton_iters, allsum=allsum)
    raise ValueError(f"grad_impl must be 'ift' or 'unroll', got {grad_impl}")


def one_hot(labels, n_classes, dtype):
    """(n, C) one-hot rows of integer ``labels`` in ``dtype``."""
    return F.one_hot(labels.long(), n_classes).to(dtype)


def multiclass_laplace_mode(kernel, z, X, labels, n_classes: int, *,
                            newton_iters: int = 15,
                            jitter: float | None = None,
                            grad_impl: str = "ift"):
    """``labels``: (n,) integers in [0, n_classes).  Returns (f_hat, a,
    inducing, v, d, y_onehot), all but the inducing state in
    ``ift.MODE_DTYPE``."""
    inducing, v, d = prior_up(kernel, z, X, jitter)
    y_onehot = one_hot(labels, n_classes, v.dtype)
    f_hat, a = softmax_mode(
        v, d, y_onehot, torch.ones(X.shape[0], dtype=v.dtype,
                                   device=v.device),
        newton_iters=newton_iters, grad_impl=grad_impl)
    return f_hat, a, inducing, v, d, y_onehot


def evidence_from_mode(v, d, f_hat, a, y_onehot, mask, allsum=_identity):
    """The Laplace evidence at the mode over the rows; masked rows
    contribute exactly nothing."""
    pi, q, qbar_inv, r_all, h_chol = _mode_weights(v, d, f_hat, mask,
                                                   allsum)
    qbar = torch.sum(q, dim=1)
    log_det = allsum(torch.sum(torch.log1p(pi * d[:, None])))
    log_det = log_det + torch.sum(log_det_tri(r_all))
    log_det = log_det + allsum(torch.sum(
        mask * torch.log(torch.where(mask > 0, qbar, 1.0)))
    ) + log_det_tri(h_chol)
    log_lik = allsum(torch.sum(mask[:, None] * y_onehot * f_hat) - torch.sum(
        mask * torch.logsumexp(f_hat, dim=1)))
    return -0.5 * allsum(torch.sum(a * f_hat)) + log_lik - 0.5 * log_det


def multiclass_log_evidence(kernel, z, X, labels, n_classes: int, *,
                            newton_iters: int = 15,
                            jitter: float | None = None,
                            grad_impl: str = "ift"):
    """The softmax Laplace marginal likelihood log q(y | X, hypers),
    differentiable in the kernel's hypers and ``z`` (implicit gradients by
    default)."""
    f_hat, a, _, v, d, y1h = multiclass_laplace_mode(
        kernel, z, X, labels, n_classes, newton_iters=newton_iters,
        jitter=jitter, grad_impl=grad_impl)
    return evidence_from_mode(v, d, f_hat, a, y1h,
                              torch.ones(X.shape[0], dtype=v.dtype,
                                         device=v.device)).to(X.dtype)


def conj_u(u, mat):
    """U^-1 mat U^-T for a stack of (m, m) matrices."""
    return solve_tri(u, solve_tri(u, mat).mT).mT


def multiclass_posterior_state(kernel, z, X, labels, n_classes: int, *,
                               newton_iters: int = 15,
                               jitter: float | None = None):
    """The m-space predictor state of the softmax Laplace, every n-sized
    object reduced away:

      coeffs  (m, C):     U^-1 V'a                       mu* = K*m coeffs
      a_tilde (C, m, m):  U^-1 (V'E_c V) U^-T
      b_tilde (C, C, m, m): U^-1 (V'E_c (sum E)^-1 E_c' V) U^-T

    so Sigma*_cc' = delta k** - delta k*' a_tilde_c k* + k*' b_tilde_cc' k*
    with the raw cross-covariance row k* = K(x*, Z).  Forms the C (n, m)
    matrices F_c = E_c V and their coupling solves as (n, m) panels.
    Returns (inducing, coeffs, a_tilde, b_tilde)."""
    f_hat, a, inducing, v, d, _ = multiclass_laplace_mode(
        kernel, z, X, labels, n_classes, newton_iters=newton_iters,
        jitter=jitter)
    pi = torch.softmax(f_hat, dim=1)
    q = pi / (1.0 + pi * d[:, None])
    qbar_inv = 1.0 / torch.sum(q, dim=1)
    r_all, p_all = _per_class_factors(v, q, _identity)
    h_chol = _coupling_chol(v, q, qbar_inv, r_all, _identity)

    # A_c = P_c - P_c (R_c'R_c)^-1 P_c
    minv_p = _msolve(r_all, p_all)
    a_all = p_all - matmul(p_all, minv_p)
    # F_c = E_c V = q_c V - q_c V (R_c'R_c)^-1 P_c;  B_cc' = F_c' S^-1 F_c'
    f_all = [q[:, c:c + 1] * v - q[:, c:c + 1] * matmul(v, minv_p[c])
             for c in range(n_classes)]
    sinv_f = [_apply_coupling_inv(v, q, qbar_inv, r_all, h_chol, f_c,
                                  _identity) for f_c in f_all]
    b_all = torch.stack([torch.stack([tmatmul(f_all[c], sinv_f[c2])
                                      for c2 in range(n_classes)])
                         for c in range(n_classes)])  # (C, C, m, m)
    u = up(inducing.chol_km)
    coeffs = solve_tri(u, tmatmul(v, a))  # (m, C)
    return inducing, *(t.to(X.dtype) for t in (
        coeffs, conj_u(u, a_all), conj_u(u, b_all)))


def latent_gaussians(kernel, z, coeffs, a_tilde, b_tilde, Xstar):
    """(mu (t, C), Sigma (t, C, C)) of the latent posterior at Xstar from the
    persistable state, with the 1e-10 jitter of the per-point Cholesky."""
    n_c = coeffs.shape[1]
    ktm = kernel.k_cross(Xstar, z)  # (t, m)
    mu = matmul(ktm, coeffs)
    kss = kernel.k_diag(Xstar)
    quad_a = torch.einsum("tm,cmk,tk->tc", ktm, a_tilde, ktm)
    quad_b = torch.einsum("tm,cdmk,tk->tcd", ktm, b_tilde, ktm)
    eye_c = torch.eye(n_c, dtype=ktm.dtype, device=ktm.device)
    sigma = (kss[:, None, None] * eye_c - quad_a[:, :, None] * eye_c
             + quad_b)
    # jitter for the per-point Cholesky (PSD up to rounding)
    sigma = sigma + 1e-10 * kss[:, None, None].mean() * eye_c
    return mu, sigma


def mc_softmax_probs(mu, sigma, eps):
    """The Monte Carlo class probabilities mean_s softmax(mu + eps_s R) per
    point, R'R = Sigma (one batched Cholesky of the (t, C, C) stack), over
    the (S, C) standard normal draws ``eps``; MC_CHUNK points at a time."""
    r = cholesky_upper(sigma, jitter=0.0)
    out = []
    for i in range(0, mu.shape[0], MC_CHUNK):
        draws = mu[i:i + MC_CHUNK, None, :] + matmul(eps, r[i:i + MC_CHUNK])
        out.append(torch.mean(torch.softmax(draws, dim=2), dim=1))
    return torch.cat(out)


def multiclass_predict_from_state(kernel, z, coeffs, a_tilde, b_tilde,
                                  Xstar, *, n_samples: int = 1024,
                                  generator=None):
    """(probs, mu, sigma) at Xstar from the persistable state: the latent
    C-variate Gaussian per point and the Monte Carlo softmax average over
    ``n_samples`` joint draws (the C-dimensional logistic-Gaussian integral
    has no closed form), drawn from ``generator`` (default
    ``torch.Generator(Xstar.device).manual_seed(0)``)."""
    mu, sigma = latent_gaussians(kernel, z, coeffs, a_tilde, b_tilde, Xstar)
    if generator is None:
        generator = torch.Generator(Xstar.device).manual_seed(0)
    eps = torch.randn((n_samples, coeffs.shape[1]), generator=generator,
                      dtype=mu.dtype, device=mu.device)
    return mc_softmax_probs(mu, sigma, eps), mu, sigma


def multiclass_predict(kernel, z, X, labels, n_classes: int, Xstar, *,
                       newton_iters: int = 15, jitter: float | None = None,
                       n_samples: int = 1024, generator=None):
    """(probs, mu, sigma) at Xstar: ``multiclass_posterior_state`` then
    ``multiclass_predict_from_state``."""
    inducing, coeffs, a_tilde, b_tilde = multiclass_posterior_state(
        kernel, z, X, labels, n_classes, newton_iters=newton_iters,
        jitter=jitter)
    return multiclass_predict_from_state(
        kernel, inducing.z, coeffs, a_tilde, b_tilde, Xstar,
        n_samples=n_samples, generator=generator)


def fit_classify_multi(X, labels, pack, n_classes: int, *,
                       newton_iters: int = 15, jitter: float | None = None,
                       normalize: bool = True, mesh=None,
                       block_size: int | None = None, **fit_kwargs):
    """Hyper and inducing training of the softmax Laplace classifier with
    the device L-BFGS: the JAX ``fit_classify_multi(family, ...)`` minus
    ``family``.  Build ``pack`` with ``learn_sigma2=False``.
    ``block_size`` streams the Newton (``classify_multi_stream.py``).
    With ``mesh`` (a ``parallel.DataMesh``; call it on every rank) the rows
    shard over the mesh and the objective is
    ``parallel.sharded_multiclass_log_evidence``; both options compose.
    Returns (kernel, z, state)."""
    no_sigma2(pack, "classification")
    if mesh is not None:
        from ..parallel.classify_sharded import (
            sharded_multiclass_log_evidence,
        )
        from ..parallel.sharded import shard_batch

        def objective(x, Xs, ls, mask):
            kernel, z, _ = pack.unpack(x)
            return sharded_multiclass_log_evidence(
                kernel, mesh, z, Xs, ls, n_classes, mask,
                newton_iters=newton_iters, jitter=jitter,
                block_size=block_size)

        data = shard_batch(mesh, X, labels)
    else:
        if block_size is not None:
            from .classify_multi_stream import stream_multiclass_log_evidence

        def objective(x, X, labels):
            kernel, z, _ = pack.unpack(x)
            if block_size is not None:
                return stream_multiclass_log_evidence(
                    kernel, z, X, labels, n_classes, block_size=block_size,
                    newton_iters=newton_iters, jitter=jitter)
            return multiclass_log_evidence(kernel, z, X, labels, n_classes,
                                           newton_iters=newton_iters,
                                           jitter=jitter)

        data = (X, labels)
    st = fit_laplace(objective, pack, data, normalize, X.shape[0],
                     mesh=mesh, **fit_kwargs)
    kernel, z, _ = pack.unpack(st.x)
    return kernel, z, st
