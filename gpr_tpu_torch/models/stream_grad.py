"""Streaming statistics and their hand-written VJP: the counterpart of
``gpr_tpu/models/stream_grad.py``.

``_forward_scan`` and ``_backward_scan`` are the plain blocked loops that
the CUDA kernels of ``ops/fused_stats.py`` are checked against, and the
``impl="reference"`` path of ``models/streaming.py`` for every kernel
family.  ``StreamStatsFn`` is ``make_stream_stats_cv``: a
``torch.autograd.Function`` whose forward runs the SE-iso forward-statistics
kernel (``impl`` "fused_acc" or "fused", CUDA tensors) or ``_forward_scan``,
and whose backward runs the SE-iso backward kernel or ``_backward_scan``.
It saves only its inputs: every Knm tile is recomputed in the backward, so
nothing n x m is ever stored.

The kernel's hypers go in positionally, the fields that are not None in
``param_names`` order (``kernels.base.hyper_leaves``; a combinator's are
the dotted leaves of its terms), and the gradient accumulators are
positional over them, as in the JAX package.  Each tile's kernel pullback
is the family's ``k_cross_vjp`` where it has one, else autograd's
(``torch.func.vjp`` of ``k_cross`` and ``k_diag``): the combinators and
the task family have none, as in the JAX package, where ``jax.vjp`` pulls
their tiles back.

The backward is the JAX package's ``bwd_variant="ug"`` schedule: the Gram
cotangent is symmetrized once, UG = U^-1 (G-bar + G-bar') is formed once,
and each tile's VG = Knm UG reads Knm with no serial dependency on V.
"""

from __future__ import annotations

import itertools

import torch
from torch.autograd.function import once_differentiable

from ..kernels.base import hyper_leaves, kernel_with
from ..numerics.linalg import matmul, rows_sqr_norm
from ..tracing import span


def _two_sum(hi, lo, x):
    """Error-free accumulation (Knuth two-sum): (hi, lo) += x with the
    rounding error of the add captured in lo.  In f32 this keeps a length-T
    reduction accurate to ~1 ulp instead of ~sqrt(T) ulps.  PyTorch runs
    each add as written, so the cancellation survives."""
    s = hi + x
    bp = s - hi
    err = (hi - (s - bp)) + (x - bp)
    return s, lo + err


def _pad_blocks(X, y, mask, block_size):
    """(nb, B, d), (nb, B), (nb, B) views of the rows, zero-padded (mask 0)
    up to a whole number of blocks."""
    n = X.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if mask is None:
        mask = torch.ones(n, dtype=X.dtype, device=X.device)
    if pad:
        X = torch.cat([X, X.new_zeros(pad, X.shape[1])])
        y = torch.cat([y, y.new_zeros(pad)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    return (
        X.reshape(nb, block_size, X.shape[1]),
        y.reshape(nb, block_size),
        mask.reshape(nb, block_size),
    )


def _accumulate(carry, terms, comp):
    if comp:
        return [_two_sum(hi, lo, t) for (hi, lo), t in zip(carry, terms)]
    return [(hi + t, lo) for (hi, lo), t in zip(carry, terms)]


def _zero_carry(shapes, dtype, device):
    return [(torch.zeros(sh, dtype=dtype, device=device),
             torch.zeros(sh, dtype=dtype, device=device)) for sh in shapes]


def _forward_scan(kernel, z, u_inv, sigma2, xb, yb, maskb, acc_dtype,
                  per_row=False):
    """Forward statistics over pre-blocked rows (nb, B, ...):
    (gram, u_vec, log_det_s, y_is_y, is_r_sum, n) in ``acc_dtype``.
    ``sigma2`` is the scalar noise variance or, when ``per_row``, per-row
    noise variances blocked like y (nb, B), as the JAX scan's ``nzb``.

    When the accumulators are f32 every carry is a compensated (hi, lo)
    pair, folded to one float at the end: per-tile rounding stays, but the
    cross-tile accumulation noise goes.
    """
    m = z.shape[0]
    comp = acc_dtype == torch.float32
    carry = _zero_carry([(m, m), (m,), (), (), (), ()], acc_dtype, z.device)
    noise = sigma2 if per_row else itertools.repeat(sigma2)
    for x_b, y_b, mask_b, noise_b in zip(xb, yb, maskb, noise):
        x_b = x_b.to(z.dtype)
        y_b = y_b.to(z.dtype)
        mask_b = mask_b.to(z.dtype)
        if per_row:
            noise_b = noise_b.to(z.dtype)
        knm = kernel.k_cross(x_b, z)
        kd = kernel.k_diag(x_b)
        v = matmul(knm, u_inv)
        r = kd - rows_sqr_norm(v)
        # padded rows are gated on both sides of every nonlinearity, as in
        # the JAX scan body (no inf * 0 in a backward pass)
        live = mask_b > 0
        s = torch.where(live, r + noise_b, torch.ones_like(r))
        is_ = mask_b / s
        sqrt_is = torch.where(
            live, torch.sqrt(torch.where(live, is_, torch.ones_like(is_))),
            torch.zeros_like(is_),
        )
        a = v * sqrt_is[:, None]
        terms = (
            matmul(a.T, a).to(acc_dtype),
            matmul(v.T, is_ * y_b).to(acc_dtype),
            torch.sum(mask_b * torch.log(s)).to(acc_dtype),
            torch.sum(is_ * y_b * y_b).to(acc_dtype),
            torch.sum(is_ * r).to(acc_dtype),
            torch.sum(mask_b).to(acc_dtype),
        )
        carry = _accumulate(carry, terms, comp)
    return tuple(hi + lo if comp else hi for hi, lo in carry)


def _backward_scan(kernel, z, u_inv, sigma2, xb, yb, maskb, cot, acc_dtype,
                   need_y=True):
    """Pull the statistic cotangents ``cot`` = (G-bar, u-bar, lds-bar,
    yiy-bar, isr-bar) back through the blocked rows: the cotangents of the
    kernel's hyper fields that are not None (``param_names`` order; for
    SE-iso log_ell_bar, log_sf2_bar), then z_bar, u_inv_bar and sigma2_bar, in
    ``acc_dtype``, and the (nb, B) y cotangent (None unless ``need_y``).

    The gradient carries are compensated (hi, lo) pairs when the
    accumulators are f32, as in the forward.
    """
    dt = z.dtype
    gbar, ubar, lds_bar, yiy_bar, isr_bar = cot
    # every tile sees the same cotangents: symmetrize the Gram's once
    gsym = (gbar + gbar.T).to(dt)
    ubar_c, lds_c, yiy_c, isr_c = (t.to(dt)
                                   for t in (ubar, lds_bar, yiy_bar, isr_bar))
    u_inv_t = u_inv.T
    ug = matmul(u_inv, gsym)
    comp = acc_dtype == torch.float32
    names, hypers = hyper_leaves(kernel)
    carry = _zero_carry([tuple(h.shape) for h in hypers]
                        + [tuple(z.shape), tuple(u_inv.shape), ()],
                        acc_dtype, z.device)
    hand_pull = getattr(kernel, "k_cross_vjp", None)
    y_bar = []
    for x_b, y_b, mask_b in zip(xb, yb, maskb):
        x_b = x_b.to(dt)
        y_b = y_b.to(dt)
        mask_b = mask_b.to(dt)
        if hand_pull is not None:
            knm = kernel.k_cross(x_b, z)
            kd = kernel.k_diag(x_b)
            pull = (lambda cot, x_b=x_b, knm=knm:
                    hand_pull(x_b, z, knm, *cot))
        else:
            (knm, kd), pull = torch.func.vjp(
                lambda *leaves, x_b=x_b: _tile(kernel, names, leaves[:-1],
                                               x_b, leaves[-1]),
                *hypers, z)
        # gram = sum (V sqrt(is))' (V sqrt(is)): with vg = V (G-bar +
        # G-bar'), the whitened-row cotangent collapses to
        #   V-bar += is * vg,   is-bar += 1/2 rowdot(vg, V)
        # so the backward needs no sqrt and no whitened tile at all.
        v = matmul(knm, u_inv)
        vg = matmul(knm, ug)
        r = kd - rows_sqr_norm(v)
        live = mask_b > 0
        s = torch.where(live, r + sigma2, torch.ones_like(r))
        is_ = mask_b / s
        # u_vec = sum V'(is y): V-bar += outer(is y, u-bar),
        #                       is-bar += y * (V u-bar)
        isy = is_ * y_b
        vu = matmul(v, ubar_c)
        vbar = is_[:, None] * vg + isy[:, None] * ubar_c[None, :]
        is_bar = (y_b * vu + 0.5 * torch.sum(vg * v, dim=1)
                  + yiy_c * y_b * y_b + isr_c * r)
        if need_y:
            # y enters u_vec and y_is_y only: its cotangent reuses vu
            y_bar.append(is_ * vu + 2.0 * yiy_c * isy)
        # is = mask/s; lds = sum mask log s; s = live ? r+sigma2 : 1
        s_bar = (lds_c * mask_b - is_bar * is_) / s
        s_bar_live = torch.where(live, s_bar, torch.zeros_like(s_bar))
        r_bar = s_bar_live + isr_c * is_
        # r = kd - rowsq(V)
        vbar = vbar - 2.0 * v * r_bar[:, None]
        knm_bar = matmul(vbar, u_inv_t)
        terms = (*pull((knm_bar, r_bar)), matmul(knm.T, vbar),
                 torch.sum(s_bar_live))
        carry = _accumulate(carry, [t.to(acc_dtype) for t in terms], comp)
    out = tuple(hi + lo if comp else hi for hi, lo in carry)
    return (*out, torch.stack(y_bar) if need_y else None)


def _tile(kernel, names, hypers, x_b, z):
    """(k_cross, k_diag) of one row tile for the hypers ``hypers`` (the
    fields ``names``): the function autograd pulls back where the family
    has no ``k_cross_vjp``."""
    view = kernel_with(kernel, dict(zip(names, hypers)))
    return view.k_cross(x_b, z), view.k_diag(x_b)


class StreamStatsFn(torch.autograd.Function):
    """(z, u_inv, sigma2, X, y, mask, *hypers) -> the six streaming
    statistics, with the hand VJP.

    ``kernel`` (whose static fields and None options the view keeps),
    ``block_size`` and ``impl`` ("fused_acc", "fused" or "reference") ride
    along as non-tensor arguments; ``hypers`` are the kernel's fields that
    are not None, in ``param_names`` order (``kernels.base.hyper_leaves``).  The
    kernel impls are SE-iso's and need CUDA tensors; the backward of either
    runs the backward kernel.  The X and mask cotangents are structural
    zeros (None); the y cotangent is exact.
    """

    @staticmethod
    def forward(ctx, kernel, block_size, impl, z, u_inv, sigma2, X, y, mask,
                *hypers):
        # imported here: ops.fused_stats imports this module
        from ..ops import fused_stats

        names, _ = hyper_leaves(kernel)
        ctx.save_for_backward(z, u_inv, sigma2, X, y, mask, *hypers)
        ctx.kernel, ctx.names = kernel, names
        ctx.block_size, ctx.impl = block_size, impl
        if impl == "reference":
            view = kernel_with(kernel, dict(zip(names, hypers)))
            xb, yb, maskb = _pad_blocks(X, y, mask, block_size)
            out = _forward_scan(view, z, u_inv, sigma2, xb, yb, maskb,
                                z.dtype)
        else:
            fwd = {"fused_acc": fused_stats.se_iso_stream_stats_fused_acc,
                   "fused": fused_stats.se_iso_stream_stats_fused}[impl]
            out = fwd(*hypers, z, u_inv, sigma2, X, y, mask,
                      block_size=block_size, acc_dtype=z.dtype)
        ctx.mark_non_differentiable(out[-1])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar, ubar, lds_bar, yiy_bar, isr_bar, _n_bar):
        from ..ops import fused_stats

        z, u_inv, sigma2, X, y, mask, *hypers = ctx.saved_tensors
        need_y = ctx.needs_input_grad[7]
        cot = (gbar, ubar, lds_bar, yiy_bar, isr_bar)
        with span("gpr.step.stats_bwd", rows=X.shape[0]):
            if ctx.impl == "reference":
                view = kernel_with(ctx.kernel, dict(zip(ctx.names, hypers)))
                xb, yb, maskb = _pad_blocks(X, y, mask, ctx.block_size)
                *grads, y_bar = _backward_scan(view, z, u_inv, sigma2, xb,
                                               yb, maskb, cot, z.dtype,
                                               need_y)
                if y_bar is not None:
                    y_bar = y_bar.reshape(-1)[:X.shape[0]]
            else:
                *grads, y_bar = fused_stats.se_iso_stream_bwd_fused(
                    *hypers, z, u_inv, sigma2, X, y, mask, *cot,
                    block_size=ctx.block_size, acc_dtype=z.dtype,
                    need_y=need_y)
        *h_bars, zb, uib, s2b = (
            g.to(like.dtype)
            for g, like in zip(grads, (*hypers, z, u_inv, sigma2)))
        if y_bar is not None:
            y_bar = y_bar.to(y.dtype)
        return (None, None, None, zb, uib, s2b, None, y_bar, None, *h_bars)
