"""Closed-form leave-one-out cross-validation for the sparse FITC model:
the counterpart of ``gpr_tpu/models/loo.py``.

The FITC marginal of the targets is the dense Gaussian y ~ N(0, A), A =
Qnn + diag(r) + sigma2 I, so the exact-GP LOO identities (Sundararajan &
Keerthi 2001) apply, and both ingredients come in O(n m) from the dense
engine's state:

    alpha = A^-1 y     = is * (y - mean_train)
    c     = diag(A^-1) = is - is^2 * rowsq(Knm R^-1)      [R'R = B]
    LOO:  mu_i = y_i - alpha_i / c_i,  var_i = 1 / c_i   (predictive)
    log p_LOO = sum_i log N(y_i | mu_i, var_i)

Differentiable end to end: ``loo_objective`` is a training objective like
the evidence (``optim.fit(objective="loo")``).  The variational flag does
not enter: it changes the evidence bound l1, not the joint.  It needs the
materialized Knm, so the streaming states do not serve it.
"""

from __future__ import annotations

import math

import torch

from ..numerics.linalg import rows_sqr_norm, solve_tri_right
from .fitc import calc_means, calc_model, calc_trained

LOG_2PI = math.log(2.0 * math.pi)


def loo_posterior(trained):
    """Per-point LOO predictive (mu_i, var_i) of a dense trained state,
    O(n m)."""
    model = trained.model
    w = solve_tri_right(model.knm, model.r_mat)  # Knm R^-1   (n, m)
    c = model.is_ - model.is_ ** 2 * rows_sqr_norm(w)
    alpha = model.is_ * (trained.y - calc_means(trained))
    var = 1.0 / c
    mu = trained.y - alpha * var
    return mu, var


def loo_log_likelihood(trained) -> torch.Tensor:
    """sum_i log N(y_i | mu_-i, var_-i): the LOO pseudo-likelihood."""
    mu, var = loo_posterior(trained)
    resid = trained.y - mu
    return -0.5 * torch.sum(torch.log(var) + resid * resid / var + LOG_2PI)


def loo_objective(kernel, z, sigma2, X, y, *,
                  factorization: str | None = None,
                  jitter: float | None = None) -> torch.Tensor:
    """Differentiable LOO pseudo-likelihood of the sparse model, with the
    signature of ``models.log_evidence``; maximize it the same way."""
    model = calc_model(kernel, X, z, sigma2, factorization=factorization,
                       jitter=jitter)
    return loo_log_likelihood(calc_trained(model, y))
