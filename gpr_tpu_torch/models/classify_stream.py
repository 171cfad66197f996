"""Streaming (blockwise) Laplace: the Newton mode, the evidence and the
predictor state with V = Knm U^-1 never materialized.  The counterpart of
``gpr_tpu/models/classify_stream.py``.

Every V-involving product of the Newton step runs as a sweep over row
blocks that recomputes the Knm tile (the structure of the regression
streaming evidence), so memory is a handful of (n,) vectors and one
(block, m) tile.  The step's data dependencies pack into six sweeps:

  1. accumulate V'b and the Woodbury Gram (Vw)'(Vw)
  2. rows Kb = V(V'b) + d b; accumulate Vw'(sqrt(e) c),  c = sw Kb
  3. rows atil = e c - sqrt(e) Vw s1 and a_n = b - sw atil; accumulate V'a_n
  4. rows f_n = V(V'a_n) + d a_n; accumulate the refinement residual
     Vw'(sqrt(e)(sw f_n - atil))
  5. rows of the refined atil/a_n; accumulate V'a_n (refined)
  6. rows of the refined f_n

and the exact line maximum is elementwise in the cached (f, f_n).  The math
is ``ift.newton_scan_generic``'s step for step.

Where autograd records, each block of a sweep runs under
``torch.utils.checkpoint`` (JAX's per-block remat), so no (block, m) tile
is kept for the backward.  ``StreamFixedPoint`` is the implicit gradient:
its forward runs the Newton sweeps without a graph, its backward is one
streaming (I + K W)^-1 apply with a refinement round plus one
``torch.autograd.grad`` through a two-sweep K-apply.  The kernel's hypers,
z and the floating likelihood leaves are its explicit inputs; X gets no
cotangent (None; the JAX package returns zeros).

Every accumulator is an m-vector, an m x m matrix or a scalar; ``allsum``
reduces them over row shards (identity on one device).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..kernels.base import hyper_leaves, kernel_with
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from .classify import latent_moments, log_sigmoid, logit_parts, mackay_squash
from .fitc import calc_inducing
from .ift import (
    _identity,
    float_leaves,
    floor_w,
    grads_or_zeros,
    line_max,
    split_lik_grads,
    up,
)
from .stream_grad import _pad_blocks


def _block(kernel, z, u_inv, body, cast, x_i, *rest):
    v_i = matmul(kernel.k_cross(x_i, z), u_inv)
    return body(up(v_i) if cast else v_i, *rest)


def _make_sweep(kernel, z, u_inv, xb, allsum=_identity, cast=False):
    """sweep(body, acc0, *row_args) -> (summed accumulators, row outputs).

    ``body(v_i, *block_slices) -> (row_outs, acc_contribs)``, two tuples of
    tensors, sees the V tile of one row block (cast to ``ift.MODE_DTYPE``
    where ``cast``); the contributions are summed in block order from ``acc0`` (then
    one ``allsum``) and the row outputs stacked to (nb, block).  Each block
    runs under ``torch.utils.checkpoint`` when autograd records."""

    def sweep(body, acc0, *row_args):
        remat = torch.is_grad_enabled()
        acc = list(acc0)
        outs = []
        for i in range(xb.shape[0]):
            args = (kernel, z, u_inv, body, cast, xb[i],
                    *(r[i] for r in row_args))
            out, contrib = (checkpoint(_block, *args, use_reentrant=False)
                            if remat else _block(*args))
            acc = [s + c for s, c in zip(acc, contrib)]
            outs.append(out)
        stacked = tuple(torch.stack(o) for o in zip(*outs))
        return tuple(allsum(s) for s in acc), stacked

    return sweep


def _prior_diag_block(kernel, z, u_inv, x_i, d_floor):
    v_i = matmul(kernel.k_cross(x_i, z), u_inv)
    d_i = kernel.k_diag(x_i) - rows_sqr_norm(v_i)
    return torch.maximum(d_i, d_i.new_tensor(d_floor))


def stream_prior_diag(kernel, z, u_inv, xb, d_floor=1e-8):
    """The FITC conditional diagonal d = kdiag - rowsq(V), (nb, block):
    one sweep, no accumulators."""
    remat = torch.is_grad_enabled()
    return torch.stack([
        checkpoint(_prior_diag_block, kernel, z, u_inv, x_i, d_floor,
                   use_reentrant=False) if remat
        else _prior_diag_block(kernel, z, u_inv, x_i, d_floor)
        for x_i in xb])


def _msolve(rm, t):
    return solve_tri(rm, solve_tri(rm, t, trans=True))


def _woodbury(w, d, maskb):
    """(sw, e, sqrt(e), sw sqrt(e)) of the floored, masked curvature."""
    sw = maskb * torch.sqrt(torch.where(w > 0.0, w, 1.0))
    e = 1.0 / (1.0 + w * d)
    se = torch.sqrt(e)
    return sw, e, se, sw * se


def _stream_step(sweep, parts, d, lik, maskb, f, a, m, allsum):
    """One Newton step in six sweeps (module docstring); the new (f, a)."""
    dtype, dev = f.dtype, f.device
    zm = torch.zeros((m,), dtype=dtype, device=dev)
    zmm = torch.zeros((m, m), dtype=dtype, device=dev)
    grad, w = parts(f, lik, maskb)
    w = floor_w(w, maskb)
    b = w * f + grad
    sw, e, se, swe = _woodbury(w, d, maskb)

    def body1(v_i, b_i, swe_i):
        vw_i = v_i * swe_i[:, None]
        return (), (matmul(v_i.T, b_i), matmul(vw_i.T, vw_i))

    (vtb, mm), _ = sweep(body1, (zm, zmm), b, swe)
    rm = cholesky_upper(torch.eye(m, dtype=dtype, device=dev) + mm,
                        jitter=0.0)

    def body2(v_i, b_i, d_i, sw_i, se_i, swe_i):
        kb_i = matmul(v_i, vtb) + d_i * b_i
        return (kb_i,), (matmul((v_i * swe_i[:, None]).T,
                                se_i * (sw_i * kb_i)),)

    (t2,), (kb,) = sweep(body2, (zm,), b, d, sw, se, swe)
    s1 = _msolve(rm, t2)

    def body3(v_i, kb_i, b_i, sw_i, e_i, se_i, swe_i):
        atil_i = e_i * (sw_i * kb_i) - se_i * matmul(v_i * swe_i[:, None],
                                                     s1)
        a_n_i = b_i - sw_i * atil_i
        return (atil_i, a_n_i), (matmul(v_i.T, a_n_i),)

    (vta,), (atil, a_n) = sweep(body3, (zm,), kb, b, sw, e, se, swe)

    def body4(v_i, a_n_i, atil_i, d_i, sw_i, se_i, swe_i):
        f_n_i = matmul(v_i, vta) + d_i * a_n_i
        x_i = sw_i * f_n_i - atil_i
        return (f_n_i,), (matmul((v_i * swe_i[:, None]).T, se_i * x_i),)

    (t3,), (f_n,) = sweep(body4, (zm,), a_n, atil, d, sw, se, swe)
    s2 = _msolve(rm, t3)

    def body5(v_i, f_n_i, atil_i, b_i, sw_i, e_i, se_i, swe_i):
        x_i = sw_i * f_n_i - atil_i
        atil2_i = atil_i + e_i * x_i - se_i * matmul(v_i * swe_i[:, None],
                                                     s2)
        a_n_i = b_i - sw_i * atil2_i
        return (a_n_i,), (matmul(v_i.T, a_n_i),)

    (vta2,), (a_n,) = sweep(body5, (zm,), f_n, atil, b, sw, e, se, swe)

    def body6(v_i, a_n_i, d_i):
        return (matmul(v_i, vta2) + d_i * a_n_i,), ()

    _, (f_n,) = sweep(body6, (), a_n, d)

    s = line_max(parts, lik, maskb, f, f_n, a, a_n, allsum)
    return (1.0 - s) * f + s * f_n, (1.0 - s) * a + s * a_n


def newton_scan_stream(kernel, z, u_inv, d, xb, lik, maskb, *,
                       newton_iters: int = 15, allsum=_identity,
                       parts=None):
    """Blockwise Newton mode-finding; (f_hat, a) as (nb, block) tensors.
    ``lik`` is the tuple of blocked likelihood data (a bare tensor means
    binary labels in {-1, +1}); ``parts(f, lik, maskb) -> (grad, W)``
    supplies the likelihood, masked rows zeroed.  As in
    ``ift.newton_scan_generic`` the steps run in ``ift.MODE_DTYPE``, each V
    tile computed in the kernel's dtype and cast, and (f_hat, a) come back
    in the rows' dtype."""
    if not isinstance(lik, tuple):
        lik = (lik,)
    if parts is None:
        parts = logit_parts
    m, dtype = z.shape[0], maskb.dtype
    sweep = _make_sweep(kernel, z, u_inv, xb, allsum, cast=True)
    d, maskb = up(d), up(maskb)
    lik = tuple(up(l) for l in lik)
    f = torch.zeros_like(maskb)
    a = torch.zeros_like(maskb)
    for _ in range(newton_iters):
        f, a = _stream_step(sweep, parts, d, lik, maskb, f, a, m, allsum)
    return f.to(dtype), a.to(dtype)


def _stream_kdot(sweep, d, x, m, dtype):
    """K x over blocked rows (K = V V' + diag(d)): two sweeps, V'x and then
    the rows V (V'x) + d x."""
    zm = torch.zeros((m,), dtype=dtype, device=x.device)
    (vtx,), _ = sweep(lambda v_i, x_i: ((), (matmul(v_i.T, x_i),)), (zm,),
                      x)
    _, (rows,) = sweep(lambda v_i, x_i, d_i: ((matmul(v_i, vtx)
                                               + d_i * x_i,), ()), (), x, d)
    return rows


def _prior(kernel, z, xb, jitter):
    """(inducing, u_inv, d, sweep) of the streaming FITC prior."""
    inducing = calc_inducing(kernel, z, jitter)
    u_inv = inv_tri_upper(inducing.chol_km)
    return inducing, u_inv, stream_prior_diag(kernel, z, u_inv, xb)


def _stream_ift_solve(kernel, names, hypers, parts, allsum, jitter, z, xb,
                      maskb, a, lik, abar):
    """u = (I + K W)^-1 abar at the streaming mode a, with one refinement
    round, in ``ift.MODE_DTYPE`` on the V tiles of the kernel's dtype
    (``ift.ift_solve``: in f32 the subtraction loses the gradient),
    returned in abar's dtype."""
    view = kernel_with(kernel, dict(zip(names, hypers)))
    _, u_inv, d = _prior(view, z, xb, jitter)
    sweep = _make_sweep(view, z, u_inv, xb, allsum, cast=True)
    d, maskb, a, x = (up(t) for t in (d, maskb, a, abar))
    lik = tuple(up(l) for l in lik)
    m, dtype, dev = z.shape[0], d.dtype, xb.device

    def kdot(x):
        return _stream_kdot(sweep, d, x, m, dtype)

    _, w = parts(kdot(a), lik, maskb)
    w = floor_w(w, maskb)
    sw, e, se, swe = _woodbury(w, d, maskb)

    def body_mm(v_i, swe_i):
        vw_i = v_i * swe_i[:, None]
        return (), (matmul(vw_i.T, vw_i),)

    (mm,), _ = sweep(body_mm, (torch.zeros((m, m), dtype=dtype,
                                           device=dev),), swe)
    rm = cholesky_upper(torch.eye(m, dtype=dtype, device=dev) + mm,
                        jitter=0.0)
    zm = torch.zeros((m,), dtype=dtype, device=dev)

    def solve(x):
        # (I + K W)^-1 x = x - K sw B^-1 sw x, B^-1 via the m-factor
        c = sw * x
        (t1,), _ = sweep(lambda v_i, c_i, swe_i, se_i: (
            (), (matmul((v_i * swe_i[:, None]).T, se_i * c_i),)),
            (zm,), c, swe, se)
        s = _msolve(rm, t1)
        _, (yrows,) = sweep(lambda v_i, c_i, e_i, se_i, swe_i, sw_i: (
            (sw_i * (e_i * c_i - se_i * matmul(v_i * swe_i[:, None],
                                               s)),), ()),
            (), c, e, se, swe, sw)
        return x - kdot(yrows)

    u = solve(x)
    # one round of iterative refinement (models/ift.py)
    u = u + solve(x - (u + kdot(w * u)))
    return u.to(abar.dtype)


class StreamFixedPoint(torch.autograd.Function):
    """(kernel, parts, newton_iters, allsum, jitter, n_hyper, z, xb, maskb,
    *hypers, *lik) -> a at the streaming Laplace mode, (nb, block), with
    the implicit gradient for z, the kernel's hypers (its ``hyper_leaves``,
    the view rebuilt with ``kernel_with``) and the floating leaves of
    ``lik``.  ``parts`` is a module-level hook: all likelihood data rides
    in ``lik``."""

    @staticmethod
    def forward(ctx, kernel, parts, newton_iters, allsum, jitter, n_hyper,
                z, xb, maskb, *rest):
        hypers, lik = rest[:n_hyper], rest[n_hyper:]
        names = hyper_leaves(kernel)[0]
        view = kernel_with(kernel, dict(zip(names, hypers)))
        _, u_inv, d = _prior(view, z, xb, jitter)
        _, a = newton_scan_stream(view, z, u_inv, d, xb, lik, maskb,
                                  newton_iters=newton_iters, allsum=allsum,
                                  parts=parts)
        ctx.kernel, ctx.names, ctx.parts = kernel, names, parts
        ctx.allsum, ctx.jitter, ctx.n_hyper = allsum, jitter, n_hyper
        ctx.save_for_backward(z, xb, maskb, a, *rest)
        return a

    @staticmethod
    @once_differentiable
    def backward(ctx, abar):
        z, xb, maskb, a, *rest = ctx.saved_tensors
        hypers, lik = rest[:ctx.n_hyper], rest[ctx.n_hyper:]
        parts, allsum, jitter = ctx.parts, ctx.allsum, ctx.jitter
        a = a.detach()
        m, dtype = z.shape[0], xb.dtype
        u = _stream_ift_solve(ctx.kernel, ctx.names, hypers, parts, allsum,
                              jitter, z, xb, maskb, a, lik, abar)

        # theta_bar = vjp of (hypers, z, floating lik) -> dl/df(K a)
        with torch.enable_grad():
            z_ = z.detach().requires_grad_(True)
            hypers_ = [h.detach().requires_grad_(True) for h in hypers]
            lik_, diff = float_leaves(lik)
            view_ = kernel_with(ctx.kernel, dict(zip(ctx.names, hypers_)))
            _, u_inv_, d_ = _prior(view_, z_, xb, jitter)
            sweep_ = _make_sweep(view_, z_, u_inv_, xb, allsum)
            g, _ = parts(_stream_kdot(sweep_, d_, a, m, dtype), lik_, maskb)
            zbar, *bars = grads_or_zeros(g, [z_, *hypers_, *diff], u)
        h_bars, l_bars = bars[:len(hypers)], bars[len(hypers):]
        return (None, None, None, None, None, None, zbar, None, None,
                *h_bars, *split_lik_grads(lik, l_bars))


def _block_lik(X, lik_rows, mask, block_size, lik_is_row):
    """(xb, lik, maskb): the rows padded and blocked, the per-row entries
    of ``lik_rows`` (flagged by ``lik_is_row``) with them."""
    if lik_is_row is None:
        lik_is_row = (True,) * len(lik_rows)
    first = lik_is_row.index(True)
    xb, _, maskb = _pad_blocks(X, lik_rows[first], mask, block_size)
    lik = tuple(_pad_blocks(X, arr, mask, block_size)[1] if is_row else arr
                for arr, is_row in zip(lik_rows, lik_is_row))
    return xb, lik, maskb


def stream_laplace_parts(kernel, z, X, lik_rows, *, parts, loglik,
                         block_size: int = 8192, newton_iters: int = 15,
                         jitter: float | None = None, mask=None,
                         allsum=_identity, lik_is_row=None,
                         grad_impl: str = "ift"):
    """Generic streaming Laplace: the mode and the m-space posterior
    epilogue for any log-concave likelihood.

    ``lik_rows`` is the tuple of likelihood data; entries flagged True in
    ``lik_is_row`` (default: all) are (n,) per-row tensors blocked with the
    data, the rest (a dispersion, cutpoints) pass through, so the same
    module-level ``parts``/``loglik`` hooks serve the dense and streaming
    paths.  Returns (inducing, f_hat, a, d, vta, rn, log_det_b, log_lik,
    quad) with f_hat, a, d as (nb, block) tensors, vta = V'a and
    rn'rn = I + Vw'Vw at the mode.  ``grad_impl`` "ift" (default) or
    "unroll"."""
    xb, lik, maskb = _block_lik(X, lik_rows, mask, block_size, lik_is_row)
    inducing, u_inv, d = _prior(kernel, z, xb, jitter)
    m, dtype = z.shape[0], xb.dtype
    sweep = _make_sweep(kernel, z, u_inv, xb, allsum)
    if grad_impl == "ift":
        hypers = hyper_leaves(kernel)[1]
        a = StreamFixedPoint.apply(kernel, parts, newton_iters, allsum,
                                   jitter, len(hypers), z, xb, maskb,
                                   *hypers, *lik)
        f_hat = _stream_kdot(sweep, d, a, m, dtype)
    elif grad_impl == "unroll":
        f_hat, a = newton_scan_stream(kernel, z, u_inv, d, xb, lik, maskb,
                                      newton_iters=newton_iters,
                                      allsum=allsum, parts=parts)
    else:
        raise ValueError(
            f"grad_impl must be 'ift' or 'unroll', got {grad_impl}")
    _, w = parts(f_hat, lik, maskb)
    w = floor_w(w, maskb)
    e = 1.0 / (1.0 + w * d)
    swe = maskb * torch.sqrt(torch.where(w > 0.0, w, 1.0) * e)

    # one epilogue sweep: V'a and the mode's Woodbury Gram
    def body(v_i, a_i, swe_i):
        vw_i = v_i * swe_i[:, None]
        return (), (matmul(v_i.T, a_i), matmul(vw_i.T, vw_i))

    (vta, mm), _ = sweep(body, (
        torch.zeros((m,), dtype=dtype, device=xb.device),
        torch.zeros((m, m), dtype=dtype, device=xb.device)), a, swe)
    rn = cholesky_upper(torch.eye(m, dtype=dtype, device=xb.device) + mm,
                        jitter=0.0)
    log_det_b = allsum(torch.sum(torch.log1p(w * d))) + log_det_tri(rn)
    log_lik = allsum(torch.sum(maskb * loglik(f_hat, lik)))
    quad = allsum(torch.sum(a * f_hat))
    return inducing, f_hat, a, d, vta, rn, log_det_b, log_lik, quad


def stream_laplace_log_evidence(kernel, z, X, lik_rows, *, parts, loglik,
                                block_size: int = 8192,
                                newton_iters: int = 15,
                                jitter: float | None = None, mask=None,
                                allsum=_identity, lik_is_row=None,
                                grad_impl: str = "ift"):
    """-0.5 a'f + log lik - 0.5 log|B| from the generic streaming parts:
    the family's dense Laplace evidence to rounding at any block
    partition."""
    *_, log_det_b, log_lik, quad = stream_laplace_parts(
        kernel, z, X, lik_rows, parts=parts, loglik=loglik,
        block_size=block_size, newton_iters=newton_iters, jitter=jitter,
        mask=mask, allsum=allsum, lik_is_row=lik_is_row,
        grad_impl=grad_impl)
    return -0.5 * quad + log_lik - 0.5 * log_det_b


def _binary_loglik(f, lik):
    return log_sigmoid(lik[0] * f)


def stream_classify_parts(kernel, z, X, y, *, block_size: int = 8192,
                          newton_iters: int = 15,
                          jitter: float | None = None, mask=None,
                          allsum=_identity, grad_impl: str = "ift"):
    """The binary instance of ``stream_laplace_parts``."""
    return stream_laplace_parts(
        kernel, z, X, (y,), parts=logit_parts, loglik=_binary_loglik,
        block_size=block_size, newton_iters=newton_iters, jitter=jitter,
        mask=mask, allsum=allsum, grad_impl=grad_impl)


def stream_classify_log_evidence(kernel, z, X, y, *, block_size: int = 8192,
                                 newton_iters: int = 15,
                                 jitter: float | None = None, mask=None,
                                 allsum=_identity, grad_impl: str = "ift"):
    """The Laplace marginal likelihood, streaming: the dense
    ``classify_log_evidence`` to rounding, with memory O(n + block m)."""
    *_, log_det_b, log_lik, quad = stream_classify_parts(
        kernel, z, X, y, block_size=block_size, newton_iters=newton_iters,
        jitter=jitter, mask=mask, allsum=allsum, grad_impl=grad_impl)
    return -0.5 * quad + log_lik - 0.5 * log_det_b


def stream_classify_predict(kernel, z, X, y, Xstar, *,
                            block_size: int = 8192, newton_iters: int = 15,
                            jitter: float | None = None):
    """(prob, latent_mean, latent_var) at Xstar from the streaming state
    (V'a and Rn of the epilogue sweep); only (t, m) test objects
    materialize."""
    inducing, _, _, _, vta, rn, *_ = stream_classify_parts(
        kernel, z, X, y, block_size=block_size, newton_iters=newton_iters,
        jitter=jitter)
    mu, var = latent_moments(kernel, inducing, vta, rn, Xstar)
    return mackay_squash(mu, var), mu, var
