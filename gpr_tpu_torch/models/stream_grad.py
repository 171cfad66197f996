"""Forward statistics of the streaming evidence: the forward half of
``gpr_tpu/models/stream_grad.py``.

``_forward_scan`` is the plain blocked loop that the CUDA kernels of
``ops/fused_stats.py`` are checked against, and the ``impl="reference"``
path of ``models/streaming.py``.  The hand-written VJP
(``make_stream_stats_cv``) comes with the training step.
"""

from __future__ import annotations

import torch

from ..numerics.linalg import matmul, rows_sqr_norm


def _two_sum(hi, lo, x):
    """Error-free accumulation (Knuth two-sum): (hi, lo) += x with the
    rounding error of the add captured in lo.  In f32 this keeps a length-T
    reduction accurate to ~1 ulp instead of ~sqrt(T) ulps.  PyTorch runs
    each add as written, so the cancellation survives."""
    s = hi + x
    bp = s - hi
    err = (hi - (s - bp)) + (x - bp)
    return s, lo + err


def _forward_scan(kernel, z, u_inv, sigma2, xb, yb, maskb, acc_dtype):
    """Forward statistics over pre-blocked rows (nb, B, ...):
    (gram, u_vec, log_det_s, y_is_y, is_r_sum, n) in ``acc_dtype``.

    When the accumulators are f32 every carry is a compensated (hi, lo)
    pair, folded to one float at the end: per-tile rounding stays, but the
    cross-tile accumulation noise goes.
    """
    m = z.shape[0]
    comp = acc_dtype == torch.float32
    shapes = [(m, m), (m,), (), (), (), ()]
    carry = [
        (torch.zeros(sh, dtype=acc_dtype, device=z.device),
         torch.zeros(sh, dtype=acc_dtype, device=z.device))
        for sh in shapes
    ]
    for x_b, y_b, mask_b in zip(xb, yb, maskb):
        x_b = x_b.to(z.dtype)
        y_b = y_b.to(z.dtype)
        mask_b = mask_b.to(z.dtype)
        knm = kernel.k_cross(x_b, z)
        kd = kernel.k_diag(x_b)
        v = matmul(knm, u_inv)
        r = kd - rows_sqr_norm(v)
        # padded rows are gated on both sides of every nonlinearity, as in
        # the JAX scan body (no inf * 0 once a backward pass exists)
        live = mask_b > 0
        s = torch.where(live, r + sigma2, torch.ones_like(r))
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
        if comp:
            carry = [_two_sum(hi, lo, t) for (hi, lo), t in zip(carry, terms)]
        else:
            carry = [(hi + t, lo) for (hi, lo), t in zip(carry, terms)]
    return tuple(hi + lo if comp else hi for hi, lo in carry)
