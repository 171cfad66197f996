"""Streaming (blockwise) softmax Laplace: the multi-class classifier with V
never materialized, memory O(n C + block m).  The counterpart of
``gpr_tpu/models/classify_multi_stream.py``.

Every V product of the softmax Newton step (``classify_multi.py``) runs as
a sweep over row blocks that recomputes the Knm tile
(``classify_stream._make_sweep``).  The coupled step packs into six
sweeps:

  1. V'b, the per-class Grams P_c = V' diag(q_c) V and the coupling Grams
     W_cc' = V' diag(q_c q_c' / Qbar) V  ->  R_c and H in m-space
  2. rows Kb = V(V'b) + d b; accumulate V'(q Kb)       (the E_c applies)
  3. rows c = E_c Kb; accumulate G' Qbar^-1 (sum_c c)  (the coupling solve)
  4. rows t = (sum_c E_c)^-1 (sum_c c); accumulate V'(q t)
  5. rows a_n = b - c + E_c t; accumulate V'a_n
  6. rows f_n = V(V'a_n) + d a_n

and the exact line maximum is elementwise in the cached (f, f_n).  As in
the binary stream the steps run in ``ift.MODE_DTYPE``, each tile computed
in the kernel's dtype and cast; so do the epilogue's Grams and factors
(the dense path's ``classify.prior_up``), and the evidence and the state
come back in the rows' dtype.

The predictor state streams through an identity the dense path does not
use: with M_c = I - R_c^-1 R_c^-T P_c, F_c = E_c V = diag(q_c) V M_c, so

  B_cc' = F_c' (sum E)^-1 F_c'
        = M_c' W_cc' M_c' + g_c' H^-1 g_c',   g_c = [R_e^-T W_ec M_c]_e,

and the (C, C, m, m) state needs only the m-space Grams the evidence
accumulates: no (n, m) F_c ever forms.

``StreamSoftmaxFixedPoint`` is the implicit gradient: its backward is one
streamed (I + K W)^-1 apply with a refinement round plus one
``torch.autograd.grad`` through a two-sweep K apply; it gives X no
cotangent (None; the JAX package returns zeros).  ``allsum`` reduces the
accumulators ((m, C) panels, small stacks of m x m matrices, scalars) over
row shards.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..kernels.base import hyper_leaves, kernel_with
from ..numerics.linalg import cholesky_upper, log_det_tri, matmul, solve_tri
from .classify_multi import (
    _coupling_blocks,
    _coupling_solve,
    _msolve,
    _pairs,
    conj_u,
    multiclass_predict_from_state,
    one_hot,
    row_weights,
    softmax_line_max,
)
from .classify_stream import _make_sweep, _prior
from .ift import _identity, grads_or_zeros, up
from .stream_grad import _pad_blocks


def _row_parts(f, y1h, d, maskb):
    """(pi, q, qbar_inv, b) of the Newton step per row, over all the
    blocked (nb, block, C) rows at once: O(n C), which the sweeps then
    slice (the JAX package recomputes them in each sweep's body)."""
    pi, q, qbar_inv = row_weights(f, d, maskb)
    grad = (y1h - pi) * maskb[..., None]
    wf = pi * f - pi * torch.sum(pi * f, dim=-1, keepdim=True)
    return pi, q, qbar_inv, (wf + grad) * maskb[..., None]


def _gram_contrib(v_i, q_i, qbar_inv_i, n_c):
    """One block's P_c (C, m, m) and W_cc' (C(C+1)/2, m, m), as one batched
    product of the block's V against its C(C+1)/2 + C weighted copies."""
    w = torch.stack([q_i[:, c] for c in range(n_c)]
                    + [q_i[:, c] * q_i[:, c2] * qbar_inv_i
                       for c, c2 in _pairs(n_c)])
    grams = matmul((v_i[None] * w[:, :, None]).mT, v_i)
    return grams[:n_c], grams[n_c:]


def _factors_from_grams(p_acc, w_acc):
    """(P symmetrized, R_c stack, H's Cholesky) from the summed Grams."""
    m = p_acc.shape[1]
    p_acc = 0.5 * (p_acc + p_acc.mT)
    eye = torch.eye(m, dtype=p_acc.dtype, device=p_acc.device)
    r_all = cholesky_upper(eye + p_acc, jitter=0.0)
    return p_acc, r_all, _coupling_blocks(r_all, lambda k: w_acc[k])


def _zeros(shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _cols(r_all, t):
    """(R_c'R_c)^-1 t_c for the columns of the (m, C) panel ``t``."""
    return _msolve(r_all, t.T).T


def _stream_step(sweep, d, y1h, maskb, f, a, m, allsum):
    """One softmax Newton step in six sweeps (module docstring); the new
    (f, a)."""
    n_c = y1h.shape[-1]
    zmc = _zeros((m, n_c), f)
    _, q, qbi, b = _row_parts(f, y1h, d, maskb)

    # sweep 1: V'b, the per-class and the coupling Grams
    def body1(v_i, q_i, qbi_i, b_i):
        return (), (matmul(v_i.T, b_i), *_gram_contrib(v_i, q_i, qbi_i, n_c))

    (vtb, p_acc, w_acc), _ = sweep(body1, (
        zmc, _zeros((n_c, m, m), f), _zeros((len(_pairs(n_c)), m, m), f)),
        q, qbi, b)
    _, r_all, h_chol = _factors_from_grams(p_acc, w_acc)

    # sweep 2: rows Kb = V(V'b) + d b; accumulate V'(q Kb)
    def body2(v_i, q_i, b_i, d_i):
        kb_i = matmul(v_i, vtb) + d_i[:, None] * b_i
        return (kb_i,), (matmul(v_i.T, q_i * kb_i),)

    (t1,), (kb,) = sweep(body2, (zmc,), q, b, d)
    t_e = _cols(r_all, t1)

    # sweep 3: rows c = E_c Kb; accumulate G' Qbar^-1 (sum_c c)
    def body3(v_i, kb_i, q_i, qbi_i):
        cvec_i = q_i * kb_i - q_i * matmul(v_i, t_e)
        qx_i = qbi_i * torch.sum(cvec_i, dim=-1)
        return (cvec_i,), (matmul(v_i.T, q_i * qx_i[:, None]),)

    (gt,), (cvec,) = sweep(body3, (zmc,), kb, q, qbi)
    gw = _coupling_solve(r_all, h_chol, gt.T[:, :, None])[..., 0]

    # sweep 4: rows t = (sum_c E_c)^-1 (sum_c c); accumulate V'(q t)
    def body4(v_i, cvec_i, q_i, qbi_i):
        tc_i = qbi_i * torch.sum(cvec_i, dim=-1) + qbi_i * torch.sum(
            q_i * matmul(v_i, gw.T), dim=-1)
        return (tc_i,), (matmul(v_i.T, q_i * tc_i[:, None]),)

    (t2,), (tcoup,) = sweep(body4, (zmc,), cvec, q, qbi)
    t_e2 = _cols(r_all, t2)

    # sweep 5: rows a_n = b - c + E_c t; accumulate V'a_n
    def body5(v_i, cvec_i, tc_i, q_i, b_i):
        e_t = q_i * tc_i[:, None] - q_i * matmul(v_i, t_e2)
        a_n_i = b_i - cvec_i + e_t
        return (a_n_i,), (matmul(v_i.T, a_n_i),)

    (vta_n,), (a_n,) = sweep(body5, (zmc,), cvec, tcoup, q, b)

    # sweep 6: rows f_n = V(V'a_n) + d a_n
    _, (f_n,) = sweep(lambda v_i, a_n_i, d_i: (
        (matmul(v_i, vta_n) + d_i[:, None] * a_n_i,), ()), (), a_n, d)

    s = softmax_line_max(f, f_n, a, a_n, y1h, maskb, allsum)
    return (1.0 - s) * f + s * f_n, (1.0 - s) * a + s * a_n


def softmax_newton_scan_stream(kernel, z, u_inv, d, xb, y1h, maskb, *,
                               newton_iters: int = 15, allsum=_identity):
    """Blockwise Newton mode-finding; (f_hat, a) as (nb, block, C) tensors
    in the rows' dtype.  The iteration of ``classify_multi.
    softmax_newton_scan`` with every V product a sweep, in
    ``ift.MODE_DTYPE``."""
    m, dtype = z.shape[0], maskb.dtype
    sweep = _make_sweep(kernel, z, u_inv, xb, allsum, cast=True)
    d, y1h, maskb = up(d), up(y1h), up(maskb)
    f = torch.zeros_like(y1h)
    a = torch.zeros_like(y1h)
    for _ in range(newton_iters):
        f, a = _stream_step(sweep, d, y1h, maskb, f, a, m, allsum)
    return f.to(dtype), a.to(dtype)


def _stream_kdot_mc(sweep, d, x, m, n_c):
    """K x column by column over blocked (nb, block, C) rows: two sweeps,
    V'x (m, C), then the rows V (V'x) + d x."""
    (vtx,), _ = sweep(lambda v_i, x_i: ((), (matmul(v_i.T, x_i),)),
                      (_zeros((m, n_c), x),), x)
    _, (rows,) = sweep(lambda v_i, x_i, d_i: (
        (matmul(v_i, vtx) + d_i[:, None] * x_i,), ()), (), x, d)
    return rows


def _stream_softmax_solve(kernel, names, hypers, allsum, jitter, z, xb, y1h,
                          maskb, a, abar):
    """u = (I + K W)^-1 abar at the streaming mode a (about twelve sweeps,
    one refinement round included), in ``ift.MODE_DTYPE`` on the tiles of
    the kernel's dtype, returned in abar's dtype."""
    view = kernel_with(kernel, dict(zip(names, hypers)))
    _, u_inv, d = _prior(view, z, xb, jitter)
    sweep = _make_sweep(view, z, u_inv, xb, allsum, cast=True)
    d, y1h, maskb, a, x = (up(t) for t in (d, y1h, maskb, a, abar))
    m, n_c = z.shape[0], y1h.shape[-1]
    zmc = _zeros((m, n_c), d)

    def kdot(x):
        return _stream_kdot_mc(sweep, d, x, m, n_c)

    pi, q, qbar_inv, _ = _row_parts(kdot(a), y1h, d, maskb)
    (p_acc, w_acc), _ = sweep(
        lambda v_i, q_i, qbi_i: ((), _gram_contrib(v_i, q_i, qbi_i, n_c)),
        (_zeros((n_c, m, m), d), _zeros((len(_pairs(n_c)), m, m), d)),
        q, qbar_inv)
    _, r_all, h_chol = _factors_from_grams(p_acc, w_acc)

    def m_apply(x):
        # M x = E x - E 1 (sum_c E_c)^-1 1' E x, streamed: the shape of
        # Newton sweeps 2-5 with x in the Kb slot
        (t1,), _ = sweep(lambda v_i, q_i, x_i: (
            (), (matmul(v_i.T, q_i * x_i),)), (zmc,), q, x)
        t_e = _cols(r_all, t1)

        def body_ex(v_i, q_i, qbi_i, x_i):
            ex_i = q_i * x_i - q_i * matmul(v_i, t_e)
            qx_i = qbi_i * torch.sum(ex_i, dim=-1)
            return (ex_i,), (matmul(v_i.T, q_i * qx_i[:, None]),)

        (gt,), (ex,) = sweep(body_ex, (zmc,), q, qbar_inv, x)
        gw = _coupling_solve(r_all, h_chol, gt.T[:, :, None])[..., 0]

        def body_tc(v_i, ex_i, q_i, qbi_i):
            tc_i = qbi_i * torch.sum(ex_i, dim=-1) + qbi_i * torch.sum(
                q_i * matmul(v_i, gw.T), dim=-1)
            return (tc_i,), (matmul(v_i.T, q_i * tc_i[:, None]),)

        (t2,), (tc,) = sweep(body_tc, (zmc,), ex, q, qbar_inv)
        t_e2 = _cols(r_all, t2)
        _, (mx,) = sweep(lambda v_i, ex_i, tc_i, q_i: (
            (ex_i - (q_i * tc_i[:, None] - q_i * matmul(v_i, t_e2)),), ()),
            (), ex, tc, q)
        return mx

    def solve(x):
        # (I + K W)^-1 x = x - K M x
        return x - kdot(m_apply(x))

    def wdot(x):
        # W x per row: diag(pi) x - pi (pi . x), masked
        return (pi * x - pi * torch.sum(pi * x, dim=-1, keepdim=True)
                ) * maskb[..., None]

    u = solve(x)
    # one round of iterative refinement (models/ift.py)
    u = u + solve(x - (u + kdot(wdot(u))))
    return u.to(abar.dtype)


class StreamSoftmaxFixedPoint(torch.autograd.Function):
    """(kernel, newton_iters, allsum, jitter, n_hyper, z, xb, y1h, maskb,
    *hypers) -> a at the streaming softmax mode, (nb, block, C), with the
    implicit gradient for z and the kernel's hypers (its ``hyper_leaves``,
    the view rebuilt with ``kernel_with``); y1h gets the identity block
    mask u, X and the mask None."""

    @staticmethod
    def forward(ctx, kernel, newton_iters, allsum, jitter, n_hyper, z, xb,
                y1h, maskb, *hypers):
        names = hyper_leaves(kernel)[0]
        view = kernel_with(kernel, dict(zip(names, hypers)))
        _, u_inv, d = _prior(view, z, xb, jitter)
        _, a = softmax_newton_scan_stream(view, z, u_inv, d, xb, y1h, maskb,
                                          newton_iters=newton_iters,
                                          allsum=allsum)
        ctx.kernel, ctx.names = kernel, names
        ctx.allsum, ctx.jitter = allsum, jitter
        ctx.save_for_backward(z, xb, y1h, maskb, a, *hypers)
        return a

    @staticmethod
    @once_differentiable
    def backward(ctx, abar):
        z, xb, y1h, maskb, a, *hypers = ctx.saved_tensors
        allsum, jitter = ctx.allsum, ctx.jitter
        a = a.detach()
        u = _stream_softmax_solve(ctx.kernel, ctx.names, hypers, allsum,
                                  jitter, z, xb, y1h, maskb, a, abar)

        # theta_bar = vjp of (hypers, z) -> mask (y1h - softmax(K a))
        with torch.enable_grad():
            z_ = z.detach().requires_grad_(True)
            hypers_ = [h.detach().requires_grad_(True) for h in hypers]
            view_ = kernel_with(ctx.kernel, dict(zip(ctx.names, hypers_)))
            _, u_inv_, d_ = _prior(view_, z_, xb, jitter)
            sweep_ = _make_sweep(view_, z_, u_inv_, xb, allsum)
            f = _stream_kdot_mc(sweep_, d_, a, z.shape[0], a.shape[-1])
            g = (y1h - torch.softmax(f, dim=-1)) * maskb[..., None]
            zbar, *h_bars = grads_or_zeros(g, [z_, *hypers_], u)
        return (None, None, None, None, None, zbar, None,
                maskb[..., None] * u, None, *h_bars)


def stream_multiclass_parts(kernel, z, X, labels, n_classes: int, *,
                            block_size: int = 8192, newton_iters: int = 15,
                            jitter: float | None = None, mask=None,
                            allsum=_identity, grad_impl: str = "ift"):
    """The mode and the m-space posterior epilogue, streaming.

    Returns (inducing, f_hat, a, d, y1h, maskb, vta, p_acc, r_all, h_chol,
    w_full, log_det, log_lik, quad): what the evidence and the predictor
    state need, w_full the (C, C, m, m) coupling Grams (pairs mirrored);
    all but the inducing state in ``ift.MODE_DTYPE``.  ``grad_impl`` "ift"
    (default, ``StreamSoftmaxFixedPoint``) or "unroll"."""
    xb, lb, maskb = _pad_blocks(X, labels, mask, block_size)
    inducing, u_inv, d = _prior(kernel, z, xb, jitter)
    y1h = one_hot(lb, n_classes, xb.dtype) * maskb[..., None]
    m = z.shape[0]
    if grad_impl == "ift":
        hypers = hyper_leaves(kernel)[1]
        a = StreamSoftmaxFixedPoint.apply(kernel, newton_iters, allsum,
                                          jitter, len(hypers), z, xb, y1h,
                                          maskb, *hypers)
        f_hat = None
    elif grad_impl == "unroll":
        f_hat, a = softmax_newton_scan_stream(
            kernel, z, u_inv, d, xb, y1h, maskb, newton_iters=newton_iters,
            allsum=allsum)
    else:
        raise ValueError(
            f"grad_impl must be 'ift' or 'unroll', got {grad_impl}")
    sweep = _make_sweep(kernel, z, u_inv, xb, allsum, cast=True)
    d, y1h, maskb, a = up(d), up(y1h), up(maskb), up(a)
    f_hat = (_stream_kdot_mc(sweep, d, a, m, n_classes) if f_hat is None
             else up(f_hat))

    # one epilogue sweep: V'a and the mode's Grams
    pi, q, qbi, _ = _row_parts(f_hat, y1h, d, maskb)

    def body(v_i, a_i, q_i, qbi_i):
        return (), (matmul(v_i.T, a_i),
                    *_gram_contrib(v_i, q_i, qbi_i, n_classes))

    (vta, p_acc, w_acc), _ = sweep(body, (
        _zeros((m, n_classes), d), _zeros((n_classes, m, m), d),
        _zeros((len(_pairs(n_classes)), m, m), d)), a, q, qbi)
    p_acc, r_all, h_chol = _factors_from_grams(p_acc, w_acc)
    w_full = [[None] * n_classes for _ in range(n_classes)]
    for k, (c, c2) in enumerate(_pairs(n_classes)):
        w_sym = 0.5 * (w_acc[k] + w_acc[k].T)
        w_full[c][c2] = w_sym
        w_full[c2][c] = w_sym  # the weight is symmetric in (c, c')
    w_full = torch.stack([torch.stack(row) for row in w_full])

    # the elementwise log-det and likelihood pieces over the mode's rows
    qbar = torch.sum(q, dim=-1)
    log_det = allsum(torch.sum(torch.log1p(pi * d[..., None])))
    log_det = log_det + torch.sum(log_det_tri(r_all))
    log_det = log_det + allsum(torch.sum(maskb * torch.log(torch.where(
        maskb > 0, torch.where(qbar > 0, qbar, 1.0), 1.0)))
    ) + log_det_tri(h_chol)
    log_lik = allsum(torch.sum(maskb[..., None] * y1h * f_hat) - torch.sum(
        maskb * torch.logsumexp(f_hat, dim=-1)))
    quad = allsum(torch.sum(a * f_hat))
    return (inducing, f_hat, a, d, y1h, maskb, vta, p_acc, r_all, h_chol,
            w_full, log_det, log_lik, quad)


def stream_multiclass_log_evidence(kernel, z, X, labels, n_classes: int, *,
                                   block_size: int = 8192,
                                   newton_iters: int = 15,
                                   jitter: float | None = None, mask=None,
                                   allsum=_identity, grad_impl: str = "ift"):
    """The softmax Laplace marginal likelihood, streaming: the dense
    ``multiclass_log_evidence`` to rounding at any block partition, with
    memory O(n C + block m)."""
    *_, log_det, log_lik, quad = stream_multiclass_parts(
        kernel, z, X, labels, n_classes, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter, mask=mask, allsum=allsum,
        grad_impl=grad_impl)
    return (-0.5 * quad + log_lik - 0.5 * log_det).to(X.dtype)


def stream_multiclass_state(kernel, z, X, labels, n_classes: int, *,
                            block_size: int = 8192, newton_iters: int = 15,
                            jitter: float | None = None, mask=None,
                            allsum=_identity):
    """The predictor state (coeffs, a_tilde, b_tilde) of
    ``classify_multi.multiclass_posterior_state``, streaming, from the
    epilogue's Grams alone through F_c = diag(q_c) V M_c (module
    docstring).  Returns (inducing, coeffs, a_tilde, b_tilde)."""
    (inducing, _, _, _, _, _, vta, p_acc, r_all, h_chol, w_full,
     *_) = stream_multiclass_parts(
        kernel, z, X, labels, n_classes, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter, mask=mask, allsum=allsum)
    eye = torch.eye(z.shape[0], dtype=vta.dtype, device=vta.device)
    # M_c = I - (R_c'R_c)^-1 P_c;  A_c = P_c - P_c (R_c'R_c)^-1 P_c
    minv_p = _msolve(r_all, p_acc)
    m_all = eye - minv_p
    a_all = p_acc - matmul(p_acc, minv_p)
    # g_c = [R_e^-T W_ec M_c]_e, class-major: (Cm, m) per class
    g_stacks = [torch.cat([
        solve_tri(r_all[e], matmul(w_full[e, c], m_all[c]), trans=True)
        for e in range(n_classes)]) for c in range(n_classes)]
    hinv_g = [_msolve(h_chol, g) for g in g_stacks]
    b_all = torch.stack([torch.stack([
        matmul(m_all[c].T, matmul(w_full[c, c2], m_all[c2]))
        + matmul(g_stacks[c].T, hinv_g[c2]) for c2 in range(n_classes)])
        for c in range(n_classes)])  # (C, C, m, m)
    u = up(inducing.chol_km)
    return inducing, *(t.to(X.dtype) for t in (
        solve_tri(u, vta), conj_u(u, a_all), conj_u(u, b_all)))


def stream_multiclass_predict(kernel, z, X, labels, n_classes: int, Xstar,
                              *, block_size: int = 8192,
                              newton_iters: int = 15,
                              jitter: float | None = None,
                              n_samples: int = 1024, generator=None):
    """(probs, mu, sigma) at Xstar from the streaming state: only (t, m)
    test objects materialize."""
    inducing, coeffs, a_tilde, b_tilde = stream_multiclass_state(
        kernel, z, X, labels, n_classes, block_size=block_size,
        newton_iters=newton_iters, jitter=jitter)
    return multiclass_predict_from_state(
        kernel, inducing.z, coeffs, a_tilde, b_tilde, Xstar,
        n_samples=n_samples, generator=generator)
