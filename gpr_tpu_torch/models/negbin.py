"""Negative-binomial (overdispersed count) GP regression: Laplace-FITC with
a learnable dispersion.  The counterpart of ``gpr_tpu/models/negbin.py``.

  y_i ~ NegBin(mean mu_i = E_i exp(f_i), dispersion r),
  Var[y_i | f_i] = mu_i + mu_i^2 / r,      f ~ GP(0, K_FITC),
  dl/df = y - (y + r) p,   W = (y + r) p (1 - p),   p = sigmoid(eta - log r),

by the stabilized Newton of ``models/ift.py``.  r is a floating leaf of
the likelihood tuple, so the implicit gradient reaches it.  ``fit_negbin``
carries r in the pack's sigma2 slot (both are log-parameterized
positives).  Predictions combine the lognormal latent with the NB
conditional by the law of total variance:

  E[y*] = m1,  Var[y*] = m1 + (1 + 1/r) m2 - m1^2,
  m1 = exp(mu + s2/2),  m2 = exp(2 mu + 2 s2)   (unit exposure).
"""

from __future__ import annotations

import torch

from .classify import _fitc_prior, fit_laplace, latent_moments, mode_factor
from .ift import (
    W_FLOOR,
    laplace_evidence_core,
    newton_scan_generic,
    tmatmul,
)
from .poisson import _exposure

_ETA_CLAMP = 30.0


def _nb_parts(f, y, r, log_exposure, mask):
    """(dl/df, W) of the NB2 log likelihood, elementwise; masked rows 0."""
    p = torch.sigmoid(f + log_exposure - torch.log(r))
    return mask * (y - (y + r) * p), mask * (y + r) * p * (1.0 - p)


def nb_parts(f, lik, mask):
    """The ``ift`` parts convention, lik = (y, r, log_exposure)."""
    y, r, le = lik
    return _nb_parts(f, y, r, le, mask)


def _nb_loglik(f, y, r, log_exposure):
    eta = f + log_exposure
    log_r = torch.log(r)
    return (torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
            + r * log_r + y * eta
            - (y + r) * torch.logaddexp(
                log_r.expand_as(eta),
                torch.clamp(eta, -_ETA_CLAMP, _ETA_CLAMP)))


def nb_loglik(f, lik):
    y, r, le = lik
    return _nb_loglik(f, y, r, le)


def _dispersion(r, like):
    if torch.is_tensor(r):
        return r.to(dtype=like.dtype, device=like.device)
    return torch.tensor(r, dtype=like.dtype, device=like.device)


def negbin_newton_scan(v, d, y, r, log_exposure, mask, *,
                       newton_iters: int = 20, allsum=lambda x: x):
    """Newton mode-finding for the NB2-Laplace; (f_hat, a)."""
    return newton_scan_generic(nb_parts, v, d, (y, r, log_exposure), mask,
                               newton_iters=newton_iters, allsum=allsum)


def negbin_laplace_mode(kernel, z, X, y, r, *, log_exposure=None,
                        newton_iters: int = 20,
                        jitter: float | None = None):
    """(f_hat, a, inducing, v, d); ``r`` the scalar dispersion > 0."""
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    f_hat, a = negbin_newton_scan(v, d, y, _dispersion(r, v),
                                  _exposure(y, log_exposure),
                                  torch.ones_like(y),
                                  newton_iters=newton_iters)
    return f_hat, a, inducing, v, d


def negbin_log_evidence(kernel, z, X, y, r, *, log_exposure=None,
                        newton_iters: int = 20,
                        jitter: float | None = None,
                        block_size: int | None = None,
                        grad_impl: str = "ift"):
    """Laplace marginal likelihood, differentiable in the kernel's hypers,
    ``z`` and ``r``; ``block_size`` streams it."""
    le = _exposure(y, log_exposure)
    if block_size is not None:
        from .classify_stream import stream_laplace_log_evidence

        return stream_laplace_log_evidence(
            kernel, z, X, (y, _dispersion(r, y), le), parts=nb_parts,
            loglik=nb_loglik, lik_is_row=(True, False, True),
            block_size=block_size, newton_iters=newton_iters, jitter=jitter,
            grad_impl=grad_impl)
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    return laplace_evidence_core(
        nb_parts, nb_loglik, v, d, (y, _dispersion(r, v), le),
        torch.ones_like(y), newton_iters=newton_iters, grad_impl=grad_impl)


def negbin_predict(kernel, z, X, y, r, Xstar, *, log_exposure=None,
                   newton_iters: int = 20, jitter: float | None = None):
    """(count_mean, count_var, latent_mean, latent_var) at Xstar per unit
    exposure."""
    le = _exposure(y, log_exposure)
    f_hat, a, inducing, v, d = negbin_laplace_mode(
        kernel, z, X, y, r, log_exposure=le, newton_iters=newton_iters,
        jitter=jitter)
    r = _dispersion(r, v)
    _, w = _nb_parts(f_hat, y, r, le, torch.ones_like(y))
    w = torch.maximum(w, w.new_tensor(W_FLOOR))
    mu, var = latent_moments(kernel, inducing, tmatmul(v, a),
                             mode_factor(v, d, w), Xstar)
    m1 = torch.exp(mu + 0.5 * var)
    m2 = torch.exp(2.0 * mu + 2.0 * var)
    return m1, m1 + (1.0 + 1.0 / r) * m2 - m1 * m1, mu, var


def fit_negbin(X, y, pack, *, log_exposure=None, newton_iters: int = 20,
               jitter: float | None = None, normalize: bool = True,
               block_size: int | None = None, **fit_kwargs):
    """Hyper, inducing and dispersion training on the NB2-Laplace evidence.
    Build ``pack`` with ``make_pack(kernel, z0, r0)``: its sigma2 slot
    carries r.  Returns (kernel, z, r, state)."""
    if not pack.learn_sigma2:
        raise ValueError(
            "fit_negbin learns the dispersion through the pack's sigma2 "
            "slot: build the pack with make_pack(kernel, z0, r0) "
            "(learn_sigma2 left True)")

    def objective(x, X, y):
        kernel, z, r = pack.unpack(x)
        return negbin_log_evidence(kernel, z, X, y, r,
                                   log_exposure=log_exposure,
                                   newton_iters=newton_iters, jitter=jitter,
                                   block_size=block_size)

    st = fit_laplace(objective, pack, (X, y), normalize, X.shape[0],
                     **fit_kwargs)
    kernel, z, r = pack.unpack(st.x)
    return kernel, z, r, st
