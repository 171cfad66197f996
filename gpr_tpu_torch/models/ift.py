"""Implicit-function-theorem gradients for the Laplace fixed point.
The counterpart of ``gpr_tpu/models/ift.py``.

Every non-Gaussian likelihood of the package (logit binary, Poisson,
binomial, negative binomial, ordinal) trains by maximizing the Laplace
evidence at the Newton mode f_hat of

  psi(f) = log p(y | f) - 0.5 f' K^-1 f,       K = V V' + diag(d).

The mode satisfies F(a; theta) = g(K(theta) a; theta) - a = 0 with
a = K^-1 f_hat and g = d log p / df, so by the implicit function theorem
(GPML section 5.5.1) the cotangent abar of a maps to

  theta_bar = (dF/dtheta)' u,      u = (I + K W)^-1 abar,

with W = -d2 log p / df2 >= 0 diagonal.  (I + K W)^-1 collapses through the
FITC low-rank structure like a Newton step,

  (I + K W)^-1 x = x - K sqrt(W) B^-1 sqrt(W) x,   B = I + sqrt(W) K sqrt(W),

one m x m Cholesky and a few (n, m) products, and (dF/dtheta)' u is one
``torch.autograd.grad`` of theta -> g(K(theta) a; theta) at a held fixed.
``LaplaceFixedPoint`` is that rule as a ``torch.autograd.Function``: its
forward runs the Newton iteration without a graph, its backward costs about
one Newton step.  ``grad_impl="unroll"`` differentiates through the
iteration instead, each step under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint``), as the comparison route.

Two choices depart from the JAX package, which computes in the rows'
dtype: the Newton steps and the backward's (I + K W)^-1 solve run in
MODE_DTYPE (f64) on the rows' V and d, whose f32 rounding at 10^6 rows
leaves the f32 mode short and the f32 solve's gradient wrong; and products
summed over the rows take 8,192-row partial sums (``tmatmul``).  In f64
both change rounding only.

A likelihood is a pair of hooks: ``parts(f, lik, mask) -> (dl/df, W)`` and
``loglik(f, lik) -> per-row log p``, where ``lik`` is a tuple of tensors.
Its floating leaves (a dispersion, cutpoints) get implicit gradients; its
integer leaves (labels) get none.  ``allsum`` reduces the cross-row sums
(identity on one device); it is the hook a data-parallel path plugs into.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..numerics.linalg import cholesky_upper, log_det_tri, matmul, solve_tri

#: bisections of the exact line maximum (s resolved to ~3e-8)
LINE_BISECTIONS = 25
#: floor of the likelihood curvature W on live rows
W_FLOOR = 1e-12
#: rows a partial sum of a product over the rows takes (``tmatmul``)
REDUCE_ROWS = 8192
#: the dtype of the Newton mode and of the IFT backward's solve
MODE_DTYPE = torch.float64


def _identity(x):
    return x


def up(x):
    """A floating tensor in MODE_DTYPE (others as they are)."""
    return x.to(MODE_DTYPE) if x.is_floating_point() else x


def floor_w(w, mask):
    """mask * max(w, W_FLOOR): the floored, masked curvature."""
    return mask * torch.maximum(w, w.new_tensor(W_FLOOR))


def tmatmul(a, b):
    """a' b, the product summed over the rows of ``a`` (n, m) and ``b`` (n,)
    or (n, k) in partial sums of REDUCE_ROWS rows, then across them.  One
    f32 product over 10^6 rows accumulates ~n ulp in its long inner loops,
    and K's row sums of O(n |v|^2) carry that into the evidence's factor
    and the gradient; the partial sums are the streaming path's
    (``chip_smoke.py``'s laplace ablation prints the one-product
    evidence's miss).  Up to REDUCE_ROWS rows it is one product."""
    n = a.shape[0]
    if n <= REDUCE_ROWS:
        return matmul(a.T, b)
    nb = n // REDUCE_ROWS
    n0 = nb * REDUCE_ROWS
    a_c = a[:n0].reshape(nb, REDUCE_ROWS, a.shape[1]).transpose(1, 2)
    b_c = b[:n0].reshape(nb, REDUCE_ROWS, -1)
    out = torch.sum(matmul(a_c, b_c), dim=0)
    if n0 < n:
        out = out + matmul(a[n0:].T, b[n0:].reshape(n - n0, -1))
    return out.reshape(a.shape[1:] + b.shape[1:])


def fitc_kdot(v, d, x, allsum=_identity):
    """K x with K = V V' + diag(d); ``allsum`` reduces the m-vector over
    row shards."""
    return matmul(v, allsum(tmatmul(v, x))) + d * x


def make_binv(v, d, w, mask, allsum=_identity):
    """(binv, sw, rm): apply B^-1 with B = I + sqrt(W) K sqrt(W) through the
    m x m Woodbury factor rm.  ``w`` must be floored and masked already
    (>= 0, exactly 0 on masked rows); the double where keeps the sqrt's
    cotangent finite on those rows."""
    sw = mask * torch.sqrt(torch.where(w > 0.0, w, 1.0))
    e = 1.0 / (1.0 + w * d)
    se = torch.sqrt(e)
    vw = v * (sw * se)[:, None]
    mm = (torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
          + allsum(tmatmul(vw, vw)))
    rm = cholesky_upper(mm, jitter=0.0)

    def binv(x):
        t = solve_tri(rm, allsum(tmatmul(vw, se * x)), trans=True)
        return e * x - se * matmul(vw, solve_tri(rm, t))

    return binv, sw, rm


@torch.no_grad()
def line_max(parts, lik, mask, f, f_n, a, a_n, allsum=_identity):
    """The step s in [0, 1] of the exact concave line maximum along
    a_s = (1 - s) a + s a_n.  Psi is elementwise in the cached (f, f_n) up
    to three dot products (K's symmetry gives a'f_n = a_n'f), so each of
    the LINE_BISECTIONS probes of dPsi/ds is one elementwise pass.  The
    bisection stays on the device (0-d tensors, ``torch.where``): no host
    synchronisation.  s carries no gradient, as in the JAX package, whose
    bisection is constant under AD."""
    aff = allsum(torch.sum(a * f))
    afn = allsum(torch.sum(a * f_n))
    ann = allsum(torch.sum(a_n * f_n))
    df = f_n - f

    def dpsi(s):
        g_s, _ = parts(f + s * df, lik, mask)
        quad_p = (-2.0 * (1.0 - s) * aff + (2.0 - 4.0 * s) * afn
                  + 2.0 * s * ann)
        return -0.5 * quad_p + allsum(torch.sum(g_s * df))

    lo = torch.zeros((), dtype=f.dtype, device=f.device)
    hi = torch.ones((), dtype=f.dtype, device=f.device)
    for _ in range(LINE_BISECTIONS):
        mid = 0.5 * (lo + hi)
        pos = dpsi(mid) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return torch.where(dpsi(one) >= 0, one, lo)


def _newton_step(parts, v, d, lik, mask, f, a, allsum):
    """One stabilized Newton step (GPML algorithm 3.1 with the m-space
    Woodbury solve), one round of iterative refinement and the exact line
    maximum; returns the new (f, a)."""
    grad, w = parts(f, lik, mask)
    w = floor_w(w, mask)
    b = w * f + grad
    kb = fitc_kdot(v, d, b, allsum)
    binv, sw, _ = make_binv(v, d, w, mask, allsum)
    atil = binv(sw * kb)
    a_n = b - sw * atil
    f_n = fitc_kdot(v, d, a_n, allsum)
    # one round of iterative refinement on B atil = sw K b: along B's top
    # subspace a_n cancels ~cond(B) digits, which large-n f32 cannot spare;
    # the residual is -(sw K a_n - atil), and K a_n = f_n is at hand
    atil = atil + binv(sw * f_n - atil)
    a_n = b - sw * atil
    f_n = fitc_kdot(v, d, a_n, allsum)
    s = line_max(parts, lik, mask, f, f_n, a, a_n, allsum)
    return (1.0 - s) * f + s * f_n, (1.0 - s) * a + s * a_n


def newton_scan_generic(parts, v, d, lik, mask, *, newton_iters: int,
                        allsum=_identity):
    """The shared Newton scaffold over the rows: ``newton_iters`` steps
    from f = a = 0.  ``parts(f, lik, mask) -> (grad, W)`` supplies the
    likelihood; W is floored at W_FLOOR and masked here.  Where autograd
    records (the "unroll" route), each step runs under
    ``torch.utils.checkpoint`` (the JAX package's remat).

    The steps run in MODE_DTYPE on V, d and the likelihood's data cast to
    it (casts autograd differentiates), and (f_hat, a) come back in the
    rows' dtype: in f32 at bench's 1M rows the Newton direction stops
    ascending within a few steps (the line search returns s = 0) well short
    of Psi's maximum, while f64 steps on the same f32 V converge
    (``chip_smoke.py``'s laplace ablation prints the f32 evidence's miss)."""
    dtype = mask.dtype
    v, d, mask = (up(t) for t in (v, d, mask))
    lik = tuple(up(l) for l in lik)
    f = torch.zeros_like(mask)
    a = torch.zeros_like(mask)
    remat = torch.is_grad_enabled()
    for _ in range(newton_iters):
        if remat:
            f, a = checkpoint(_newton_step, parts, v, d, lik, mask, f, a,
                              allsum, use_reentrant=False)
        else:
            f, a = _newton_step(parts, v, d, lik, mask, f, a, allsum)
    return f.to(dtype), a.to(dtype)


def split_lik_grads(lik, grads):
    """Cotangents of ``lik``: ``grads`` in order for its floating leaves,
    None for the integer ones."""
    it = iter(grads)
    return [next(it) if l.is_floating_point() else None for l in lik]


def float_leaves(lik):
    """(detached copies that require grad where floating, those copies)."""
    full = [l.detach().requires_grad_(True) if l.is_floating_point() else l
            for l in lik]
    return tuple(full), [l for l in full if l.is_floating_point()]


def grads_or_zeros(outputs, inputs, cotangent):
    """torch.autograd.grad with zeros for inputs the outputs do not reach."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs=cotangent,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


def ift_solve(parts, allsum, v, d, mask, a, lik, abar):
    """u = (I + K W)^-1 abar at the mode a, with one round of iterative
    refinement, computed in MODE_DTYPE and returned in abar's dtype.
    (I + K W)^-1 x = x - K sw B^-1 sw x subtracts two vectors that agree to
    about cond(I + K W) digits, all of f32's at bench's shape, where the
    f32 solve's implicit gradient is wrong by orders of magnitude
    (``chip_smoke.py``'s laplace ablation), so the solve runs in f64
    whatever the forward's dtype."""
    v, d, mask, a, x = (up(t) for t in (v, d, mask, a, abar))
    lik = [up(l) for l in lik]
    _, w = parts(fitc_kdot(v, d, a, allsum), lik, mask)
    w = floor_w(w, mask)
    binv, sw, _ = make_binv(v, d, w, mask, allsum)

    def solve(x):
        # (I + K W)^-1 x = x - K sw B^-1 sw x
        return x - fitc_kdot(v, d, sw * binv(sw * x), allsum)

    u = solve(x)
    # one round of iterative refinement, as in the forward
    u = u + solve(x - (u + fitc_kdot(v, d, w * u, allsum)))
    return u.to(abar.dtype)


class LaplaceFixedPoint(torch.autograd.Function):
    """(parts, allsum, newton_iters, v, d, mask, *lik) -> a at the Laplace
    mode, with the implicit gradient (module docstring) for v, d and the
    floating leaves of ``lik``; mask and integer leaves get None."""

    @staticmethod
    def forward(ctx, parts, allsum, newton_iters, v, d, mask, *lik):
        _, a = newton_scan_generic(parts, v, d, lik, mask,
                                   newton_iters=newton_iters, allsum=allsum)
        ctx.parts, ctx.allsum = parts, allsum
        ctx.save_for_backward(v, d, mask, a, *lik)
        return a

    @staticmethod
    @once_differentiable
    def backward(ctx, abar):
        v, d, mask, a, *lik = ctx.saved_tensors
        parts, allsum = ctx.parts, ctx.allsum
        a = a.detach()
        u = ift_solve(parts, allsum, v, d, mask, a, lik, abar)

        # theta_bar = (dF/dtheta)' u, F = g(K(theta) a; lik) - a at fixed a
        with torch.enable_grad():
            v_ = v.detach().requires_grad_(True)
            d_ = d.detach().requires_grad_(True)
            lik_, diff = float_leaves(lik)
            g, _ = parts(fitc_kdot(v_, d_, a, allsum), lik_, mask)
            vbar, dbar, *lbar = grads_or_zeros(g, [v_, d_, *diff], u)
        return (None, None, None, vbar, dbar, None,
                *split_lik_grads(lik, lbar))


def laplace_mode_generic(parts, v, d, lik, mask, *, newton_iters: int,
                         allsum=_identity, grad_impl: str = "ift"):
    """(f_hat, a) at the mode.  ``grad_impl``: "ift" (default) the implicit
    gradient of ``LaplaceFixedPoint``; "unroll" autograd through the
    checkpointed iteration."""
    if grad_impl == "ift":
        a = LaplaceFixedPoint.apply(parts, allsum, newton_iters, v, d, mask,
                                    *lik)
        return fitc_kdot(v, d, a, allsum), a
    if grad_impl == "unroll":
        return newton_scan_generic(parts, v, d, lik, mask,
                                   newton_iters=newton_iters, allsum=allsum)
    raise ValueError(f"grad_impl must be 'ift' or 'unroll', got {grad_impl}")


def laplace_evidence_core(parts, loglik, v, d, lik, mask, *,
                          newton_iters: int, allsum=_identity,
                          grad_impl: str = "ift"):
    """The Laplace marginal likelihood (GPML eq. 3.32) over the FITC prior
    for any log-concave likelihood: -0.5 a'f + sum log p(y|f) - 0.5 log|B|,
    every n x n object eliminated through the low-rank structure.
    ``loglik(f, lik)`` gives per-row log p (masked rows multiplied out
    here).  Differentiable in (v, d, floating lik leaves) by ``grad_impl``."""
    f_hat, a = laplace_mode_generic(parts, v, d, lik, mask,
                                    newton_iters=newton_iters, allsum=allsum,
                                    grad_impl=grad_impl)
    _, w = parts(f_hat, lik, mask)
    w = floor_w(w, mask)
    _, _, rm = make_binv(v, d, w, mask, allsum)
    log_det_b = allsum(torch.sum(torch.log1p(w * d))) + log_det_tri(rm)
    log_lik = allsum(torch.sum(mask * loglik(f_hat, lik)))
    return -0.5 * allsum(torch.dot(a, f_hat)) + log_lik - 0.5 * log_det_b
