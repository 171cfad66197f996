"""Ordinal GP regression: cumulative probit over ordered categories,
Laplace-FITC, with learnable cutpoints.  The counterpart of
``gpr_tpu/models/ordinal.py``.

Targets y in {0..K-1}, a latent GP f and ordered cutpoints
b_1 < ... < b_{K-1} (first plus log increments, so the order holds
unconditionally):

  p(y = k | f) = Phi(b_{k+1} - f) - Phi(b_k - f),   b_0 = -inf, b_K = +inf.

The likelihood is log-concave in f, so the stabilized Newton of
``models/ift.py`` applies.  With z0 = b_y - f, z1 = b_{y+1} - f, p the cell
mass and r_i = phi(z_i)/p:

  dl/df = r0 - r1,   W = (r0 - r1)^2 + z1 r1 - z0 r0  (>= 0),

the boundary categories dropping their term.  Every ratio is computed in
log space (the cell mass by a flip-to-the-smaller-tail
log(Phi(b) - Phi(a))), and every masked branch sees safe inputs, so no
unselected inf or NaN reaches a gradient.  The cutpoints are a floating
leaf of the likelihood tuple (implicit gradient) and ride the optimization
vector through ``optim.pack.extend_pack``.  Class probabilities at test
inputs are the exact Gaussian integrals of the probit cells:
p(y* = k) = Phi((b_{k+1} - mu)/sqrt(1 + var)) - Phi((b_k - mu)/sqrt(1 + var)).
"""

from __future__ import annotations

import math

import torch
from torch.special import log_ndtr, ndtr

from .classify import (
    _fitc_prior,
    fit_laplace,
    latent_moments,
    mode_factor,
    no_mesh,
    no_sigma2,
)
from .ift import (
    W_FLOOR,
    laplace_evidence_core,
    newton_scan_generic,
    tmatmul,
)

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_2 = 0.6931471805599453


def cutpoints_from_raw(raw: torch.Tensor) -> torch.Tensor:
    """(K-1,) raw vector -> strictly increasing cutpoints: b_1 = raw_0,
    b_{j+1} = b_j + exp(raw_j)."""
    first = raw[:1]
    return torch.cat([first, first + torch.cumsum(torch.exp(raw[1:]), 0)])


def default_cutpoint_raw(n_classes: int, dtype=torch.float64,
                         device=None) -> torch.Tensor:
    """Evenly spaced cutpoints spanning ~[-1, 1] on the latent scale."""
    if n_classes < 2:
        raise ValueError("ordinal regression needs n_classes >= 2")
    k = n_classes - 1
    if k == 1:
        return torch.zeros((1,), dtype=dtype, device=device)
    gap = 2.0 / (k - 1)
    return torch.cat([torch.full((1,), -1.0, dtype=dtype, device=device),
                      torch.full((k - 1,), math.log(gap), dtype=dtype,
                                 device=device)])


def _log_phi(z):
    return -0.5 * z * z - _LOG_SQRT_2PI


def _log1mexp(r, eps):
    """log(1 - exp(r)) for r <= -eps, stable at both ends, with every
    unselected branch fed a safe input (near 0 log1p(-exp(r)) gives -inf,
    whose cotangent would poison the gradient)."""
    r = torch.minimum(r, r.new_tensor(-eps))
    near = r > -_LOG_2  # the switch point (Maechler 2012)
    r_n = torch.where(near, r, -1.0)
    r_f = torch.where(near, -1.0, r)
    return torch.where(near, torch.log(-torch.expm1(r_n)),
                       torch.log1p(-torch.exp(r_f)))


def _log_cell(z0, z1, has_lo, has_hi):
    """log(Phi(z1) - Phi(z0)) with boundary masks, stable in both tails.
    Masked bounds carry a safe z (the caller substitutes 0), and the
    both-bounds branch sees safe inputs where a mask deselects it."""
    eps = torch.finfo(z1.dtype).eps
    both_sel = has_lo & has_hi
    # flip so the difference is between lower-tail CDFs (log_ndtr is
    # accurate there): Phi(z1) - Phi(z0) = Phi(-z0) - Phi(-z1)
    flip = (z0 + z1) > 0.0
    a = torch.where(both_sel, torch.where(flip, -z1, z0), -1.0)
    b = torch.where(both_sel, torch.where(flip, -z0, z1), 1.0)
    la, lb = log_ndtr(a), log_ndtr(b)
    both = lb + _log1mexp(la - lb, eps)
    only_hi = log_ndtr(z1)  # k = 0: the cell is Phi(z1)
    only_lo = log_ndtr(-z0)  # k = K-1: the cell is 1 - Phi(z0)
    return torch.where(has_lo, torch.where(has_hi, both, only_lo), only_hi)


def _bounds(f, y, cuts):
    """Per-row (z0, z1, has_lo, has_hi) with safe substitutes where masked;
    ``y`` integer, ``cuts`` (K-1,) increasing."""
    k1 = cuts.shape[0]
    has_lo = y > 0
    has_hi = y < k1
    b_lo = cuts[torch.clamp(y - 1, 0, k1 - 1)]
    b_hi = cuts[torch.clamp(y, 0, k1 - 1)]
    z0 = torch.where(has_lo, b_lo - f, 0.0)
    z1 = torch.where(has_hi, b_hi - f, 0.0)
    return z0, z1, has_lo, has_hi


def _ord_parts(f, y, cuts, mask):
    """(dl/df, W) of the cumulative-probit log likelihood, elementwise."""
    z0, z1, has_lo, has_hi = _bounds(f, y, cuts)
    logp = _log_cell(z0, z1, has_lo, has_hi)
    r0 = torch.where(has_lo, torch.exp(_log_phi(z0) - logp), 0.0)
    r1 = torch.where(has_hi, torch.exp(_log_phi(z1) - logp), 0.0)
    w = torch.square(r0 - r1) + z1 * r1 - z0 * r0
    return mask * (r0 - r1), mask * torch.maximum(w, w.new_tensor(0.0))


def _ord_loglik(f, y, cuts):
    return _log_cell(*_bounds(f, y, cuts))


def ord_parts(f, lik, mask):
    """The ``ift`` parts convention, lik = (y, cuts): ``cuts`` floating
    (implicit gradient), ``y`` integer (none)."""
    y, cuts = lik
    return _ord_parts(f, y, cuts, mask)


def ord_loglik(f, lik):
    y, cuts = lik
    return _ord_loglik(f, y, cuts)


def ordinal_newton_scan(v, d, y, cuts, mask, *, newton_iters: int = 20,
                        allsum=lambda x: x):
    """Newton mode-finding, the cumulative-probit instance of
    ``ift.newton_scan_generic``; (f_hat, a)."""
    return newton_scan_generic(ord_parts, v, d, (y, cuts), mask,
                               newton_iters=newton_iters, allsum=allsum)


def ordinal_laplace_mode(kernel, z, X, y, cut_raw, *,
                         newton_iters: int = 20,
                         jitter: float | None = None):
    """(f_hat, a, inducing, v, d, cuts); ``y`` integer (n,) in {0..K-1},
    ``cut_raw`` (K-1,) the unconstrained cutpoint vector."""
    cuts = cutpoints_from_raw(cut_raw)
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    f_hat, a = ordinal_newton_scan(
        v, d, y, cuts, torch.ones(y.shape, dtype=v.dtype, device=v.device),
        newton_iters=newton_iters)
    return f_hat, a, inducing, v, d, cuts


def ordinal_log_evidence(kernel, z, X, y, cut_raw, *,
                         newton_iters: int = 20,
                         jitter: float | None = None,
                         block_size: int | None = None,
                         grad_impl: str = "ift"):
    """Laplace marginal likelihood, differentiable in the kernel's hypers,
    ``z`` and ``cut_raw``; ``block_size`` streams it."""
    cuts = cutpoints_from_raw(cut_raw)
    if block_size is not None:
        from .classify_stream import stream_laplace_log_evidence

        return stream_laplace_log_evidence(
            kernel, z, X, (y, cuts), parts=ord_parts, loglik=ord_loglik,
            lik_is_row=(True, False), block_size=block_size,
            newton_iters=newton_iters, jitter=jitter, grad_impl=grad_impl)
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    return laplace_evidence_core(
        ord_parts, ord_loglik, v, d, (y, cuts),
        torch.ones(y.shape, dtype=v.dtype, device=v.device),
        newton_iters=newton_iters, grad_impl=grad_impl)


def cell_probs(cuts, mu, var):
    """(n*, K) exact probit-cell probabilities of N(mu, var) latents."""
    cdf = ndtr((cuts[None, :] - mu[:, None])
               * (1.0 / torch.sqrt(1.0 + var))[:, None])
    ones = torch.ones((mu.shape[0], 1), dtype=cdf.dtype, device=cdf.device)
    upper = torch.cat([cdf, ones], dim=1)
    lower = torch.cat([torch.zeros_like(ones), cdf], dim=1)
    return torch.clamp(upper - lower, min=0.0)


def ordinal_predict(kernel, z, X, y, cut_raw, Xstar, *,
                    newton_iters: int = 20, jitter: float | None = None):
    """(probs (n*, K), latent_mean, latent_var) at Xstar."""
    f_hat, a, inducing, v, d, cuts = ordinal_laplace_mode(
        kernel, z, X, y, cut_raw, newton_iters=newton_iters, jitter=jitter)
    _, w = _ord_parts(f_hat, y, cuts, torch.ones_like(f_hat))
    w = torch.maximum(w, w.new_tensor(W_FLOOR))
    mu, var = latent_moments(kernel, inducing, tmatmul(v, a),
                             mode_factor(v, d, w), Xstar)
    return cell_probs(cuts, mu, var), mu, var


def fit_ordinal(X, y, pack, cut_raw0, *, newton_iters: int = 20,
                jitter: float | None = None, normalize: bool = True,
                mesh=None, block_size: int | None = None, **fit_kwargs):
    """Joint hyper, inducing and cutpoint training on the ordinal-Laplace
    evidence.  ``pack`` carries ``learn_sigma2=False`` (the latent scale is
    the kernel amplitude's against unit probit noise); the cutpoint raws
    are appended by ``optim.pack.extend_pack``.  ``mesh`` (JAX's
    data-parallel path) is not ported.  Returns (kernel, z, cut_raw,
    state)."""
    from ..optim.pack import extend_pack

    no_sigma2(pack, "the ordinal likelihood")
    if mesh is not None and block_size is not None:
        raise ValueError(
            "fit_ordinal streams per shard via mesh=... alone; block_size "
            "composes with the single-device path only")
    no_mesh(mesh, "fit_ordinal")
    ext = extend_pack(pack, torch.as_tensor(cut_raw0))

    def objective(x, X, y):
        kernel, z, _ = ext.unpack(x)
        return ordinal_log_evidence(kernel, z, X, y, ext.unpack_extra(x),
                                    newton_iters=newton_iters,
                                    jitter=jitter, block_size=block_size)

    st = fit_laplace(objective, ext, (X, y), normalize, X.shape[0],
                     **fit_kwargs)
    kernel, z, _ = ext.unpack(st.x)
    return kernel, z, ext.unpack_extra(st.x), st
