"""Binomial GP regression: y successes of N trials, Laplace-FITC.  The
counterpart of ``gpr_tpu/models/binomial.py``.

  y_i ~ Binomial(N_i, sigmoid(f_i)),     f ~ GP(0, K_FITC),
  l_i = ln C(N_i, y_i) + y_i f_i - N_i softplus(f_i),
  dl/df = y - N sigmoid(f),   W = N sigmoid(f)(1 - sigmoid(f)) <= N/4,

by the stabilized Newton of ``models/ift.py``.  At N_i = 1 this is the
binary classifier (``classify.py``) with y in {0, 1}.
"""

from __future__ import annotations

import torch

from .classify import (
    _fitc_prior,
    fit_laplace,
    latent_moments,
    mackay_squash,
    mode_factor,
    no_sigma2,
)
from .ift import (
    W_FLOOR,
    laplace_evidence_core,
    newton_scan_generic,
    tmatmul,
)


def _bin_parts(f, y, trials, mask):
    """(dl/df, W) of the binomial log likelihood, elementwise."""
    p = torch.sigmoid(f)
    return mask * (y - trials * p), mask * trials * p * (1.0 - p)


def bin_parts(f, lik, mask):
    """The ``ift`` parts convention, lik = (y, trials)."""
    y, trials = lik
    return _bin_parts(f, y, trials, mask)


def _bin_loglik(f, y, trials):
    return (torch.lgamma(trials + 1.0) - torch.lgamma(y + 1.0)
            - torch.lgamma(trials - y + 1.0) + y * f
            - trials * torch.logaddexp(torch.zeros_like(f), f))


def bin_loglik(f, lik):
    y, trials = lik
    return _bin_loglik(f, y, trials)


def binomial_newton_scan(v, d, y, trials, mask, *, newton_iters: int = 15,
                         allsum=lambda x: x):
    """Newton mode-finding for the binomial Laplace; (f_hat, a)."""
    return newton_scan_generic(bin_parts, v, d, (y, trials), mask,
                               newton_iters=newton_iters, allsum=allsum)


def binomial_laplace_mode(kernel, z, X, y, trials, *,
                          newton_iters: int = 15,
                          jitter: float | None = None):
    """(f_hat, a, inducing, v, d); ``y`` successes of ``trials``, both (n,)
    floats."""
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    f_hat, a = binomial_newton_scan(v, d, y, trials, torch.ones_like(y),
                                    newton_iters=newton_iters)
    return f_hat, a, inducing, v, d


def binomial_log_evidence(kernel, z, X, y, trials, *,
                          newton_iters: int = 15,
                          jitter: float | None = None,
                          block_size: int | None = None,
                          grad_impl: str = "ift"):
    """Laplace marginal likelihood, differentiable in the kernel's hypers
    and ``z``; ``block_size`` streams it."""
    if block_size is not None:
        from .classify_stream import stream_laplace_log_evidence

        return stream_laplace_log_evidence(
            kernel, z, X, (y, trials), parts=bin_parts, loglik=bin_loglik,
            block_size=block_size, newton_iters=newton_iters, jitter=jitter,
            grad_impl=grad_impl)
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    return laplace_evidence_core(
        bin_parts, bin_loglik, v, d, (y, trials), torch.ones_like(y),
        newton_iters=newton_iters, grad_impl=grad_impl)


def binomial_predict(kernel, z, X, y, trials, Xstar, *,
                     newton_iters: int = 15, jitter: float | None = None):
    """(prob, latent_mean, latent_var) at Xstar: the success probability by
    MacKay's probit approximation on the latent moments."""
    f_hat, a, inducing, v, d = binomial_laplace_mode(
        kernel, z, X, y, trials, newton_iters=newton_iters, jitter=jitter)
    _, w = _bin_parts(f_hat, y, trials, torch.ones_like(y))
    w = torch.maximum(w, w.new_tensor(W_FLOOR))
    mu, var = latent_moments(kernel, inducing, tmatmul(v, a),
                             mode_factor(v, d, w), Xstar)
    return mackay_squash(mu, var), mu, var


def fit_binomial(X, y, trials, pack, *, newton_iters: int = 15,
                 jitter: float | None = None, normalize: bool = True,
                 block_size: int | None = None, **fit_kwargs):
    """Hyper and inducing training on the binomial-Laplace evidence (the
    pack carries ``learn_sigma2=False``).  Returns (kernel, z, state)."""
    no_sigma2(pack, "the binomial likelihood")

    def objective(x, X, y, trials):
        kernel, z, _ = pack.unpack(x)
        return binomial_log_evidence(kernel, z, X, y, trials,
                                     newton_iters=newton_iters,
                                     jitter=jitter, block_size=block_size)

    st = fit_laplace(objective, pack, (X, y, trials), normalize, X.shape[0],
                     **fit_kwargs)
    kernel, z, _ = pack.unpack(st.x)
    return kernel, z, st
