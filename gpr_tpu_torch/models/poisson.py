"""Poisson (count) GP regression: the Laplace approximation over the FITC
prior.  The counterpart of ``gpr_tpu/models/poisson.py``.

  y_i ~ Poisson(E_i exp(f_i)),   f ~ GP(0, K_FITC),

by the stabilized Newton of ``models/ift.py``: the Poisson log likelihood
is strictly concave in f and W = diag(E e^f) its (positive) Hessian.
``log_exposure`` carries the offset log E_i; the latent f is the log rate
per unit exposure.  W is unbounded above, so the latent is clamped at
|f + log E| <= 30 inside exp() only.  Under the log link the predictive
rate is lognormal: E[rate] = exp(mu* + s2*/2),
Var[rate] = (e^{s2*} - 1) e^{2 mu* + s2*}.
"""

from __future__ import annotations

import torch

from .classify import (
    _fitc_prior,
    fit_laplace,
    latent_moments,
    mode_factor,
    no_sigma2,
)
from .ift import (
    W_FLOOR,
    laplace_evidence_core,
    newton_scan_generic,
    tmatmul,
)

_F_CLAMP = 30.0


def _rate_w(f, log_exposure, mask):
    """W = E exp(f), clamped in the exponent; masked rows contribute 0."""
    return mask * torch.exp(torch.clamp(f + log_exposure, -_F_CLAMP,
                                        _F_CLAMP))


def pois_parts(f, lik, mask):
    """(dl/df, W) of the Poisson log likelihood, lik = (y, log_exposure)."""
    y, le = lik
    rate = _rate_w(f, le, mask)
    return mask * (y - rate), rate


def _pois_loglik(f, y, le):
    eta = f + le
    return (y * eta - torch.exp(torch.clamp(eta, -_F_CLAMP, _F_CLAMP))
            - torch.lgamma(y + 1.0))


def pois_loglik(f, lik):
    y, le = lik
    return _pois_loglik(f, y, le)


def _exposure(y, log_exposure):
    if log_exposure is None:
        return torch.zeros_like(y)
    return torch.as_tensor(log_exposure, dtype=y.dtype, device=y.device)


def poisson_newton_scan(v, d, y, log_exposure, mask, *,
                        newton_iters: int = 20, allsum=lambda x: x):
    """Newton mode-finding for the Poisson-Laplace; (f_hat, a)."""
    return newton_scan_generic(pois_parts, v, d, (y, log_exposure), mask,
                               newton_iters=newton_iters, allsum=allsum)


def poisson_laplace_mode(kernel, z, X, y, *, log_exposure=None,
                         newton_iters: int = 20,
                         jitter: float | None = None):
    """(f_hat, a, inducing, v, d) with f_hat = K a the latent log-rate
    mode; ``y`` nonnegative counts (float)."""
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    f_hat, a = poisson_newton_scan(v, d, y, _exposure(y, log_exposure),
                                   torch.ones_like(y),
                                   newton_iters=newton_iters)
    return f_hat, a, inducing, v, d


def poisson_log_evidence(kernel, z, X, y, *, log_exposure=None,
                         newton_iters: int = 20,
                         jitter: float | None = None,
                         block_size: int | None = None,
                         grad_impl: str = "ift"):
    """Laplace marginal likelihood with the Poisson likelihood (the -log y!
    constant included), differentiable in the kernel's hypers and ``z``.
    ``block_size`` streams it (``classify_stream.py``)."""
    le = _exposure(y, log_exposure)
    if block_size is not None:
        from .classify_stream import stream_laplace_log_evidence

        return stream_laplace_log_evidence(
            kernel, z, X, (y, le), parts=pois_parts, loglik=pois_loglik,
            block_size=block_size, newton_iters=newton_iters, jitter=jitter,
            grad_impl=grad_impl)
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    return laplace_evidence_core(
        pois_parts, pois_loglik, v, d, (y, le), torch.ones_like(y),
        newton_iters=newton_iters, grad_impl=grad_impl)


def poisson_predict(kernel, z, X, y, Xstar, *, log_exposure=None,
                    newton_iters: int = 20, jitter: float | None = None):
    """(rate_mean, rate_var, latent_mean, latent_var) at Xstar, per unit
    exposure (lognormal moments of the latent posterior)."""
    le = _exposure(y, log_exposure)
    f_hat, a, inducing, v, d = poisson_laplace_mode(
        kernel, z, X, y, log_exposure=le, newton_iters=newton_iters,
        jitter=jitter)
    w = _rate_w(f_hat, le, torch.ones_like(y))
    w = torch.maximum(w, w.new_tensor(W_FLOOR))
    mu, var = latent_moments(kernel, inducing, tmatmul(v, a),
                             mode_factor(v, d, w), Xstar)
    rate_mean = torch.exp(mu + 0.5 * var)
    rate_var = (torch.exp(var) - 1.0) * torch.exp(2.0 * mu + var)
    return rate_mean, rate_var, mu, var


def fit_poisson(X, y, pack, *, log_exposure=None, newton_iters: int = 20,
                jitter: float | None = None, normalize: bool = True,
                block_size: int | None = None, **fit_kwargs):
    """Hyper and inducing training on the Poisson-Laplace evidence (the JAX
    ``fit_poisson(family, ...)`` minus ``family``; the pack carries
    ``learn_sigma2=False``).  Returns (kernel, z, state)."""
    no_sigma2(pack, "the Poisson likelihood")

    def objective(x, X, y):
        kernel, z, _ = pack.unpack(x)
        return poisson_log_evidence(kernel, z, X, y,
                                    log_exposure=log_exposure,
                                    newton_iters=newton_iters, jitter=jitter,
                                    block_size=block_size)

    st = fit_laplace(objective, pack, (X, y), normalize, X.shape[0],
                     **fit_kwargs)
    kernel, z, _ = pack.unpack(st.x)
    return kernel, z, st
