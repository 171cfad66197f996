"""Exact (dense) GP regression: the counterpart of
``gpr_tpu/models/exact.py``.

For n small enough that chol(K + sigma2 I) fits, the exact marginal
likelihood, posterior and leave-one-out (LOO) quantities; as m -> n the
variational FITC evidence approaches the exact one from below (Titsias
2009).  Math (GPML ch. 2 and 5; upper Cholesky factors, R'R = A):

    A      = K(X, X) + sigma2 I,   R = chol_upper(A)
    alpha  = A^-1 y,               log Z = -1/2 (y' alpha + log|A| + n log 2pi)
    mean*  = k* alpha,             var* = k_diag(X*) - colsq(R^-T k*')
    LOO:   c_i = diag(A^-1)_i = rowsq(R^-1)_i,
           mu_i = y_i - alpha_i / c_i,   var_i = 1 / c_i

One factorization per evaluation; K is O(n^2) memory (at n = 20,000 in f64
one copy is 3.2 GB).  Gradients are autograd's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class ExactModel:
    """Dense prior quantities (the analogue of ``fitc.ModelState``)."""

    z: torch.Tensor  # (n, dz) training inputs in inducing representation
    sigma2: torch.Tensor
    chol_a: torch.Tensor  # upper R with R'R = K + sigma2 I (+ jitter)


@dataclasses.dataclass(frozen=True)
class ExactTrained:
    """Dense posterior (the analogue of ``fitc.TrainedState``)."""

    model: ExactModel
    y: torch.Tensor  # (n,)
    alpha: torch.Tensor  # (n,) A^-1 y
    l: torch.Tensor  # log evidence


def calc_exact(kernel, X, sigma2, *, jitter: float | None = 0.0) -> ExactModel:
    """chol(K(X, X) + sigma2 I) from the data-side gram
    ``k_upper_inputs``.  ``jitter`` defaults to 0 (sigma2 regularizes the
    diagonal); None takes the configured policy."""
    z = kernel.inducing_from_inputs(X)
    a = kernel.k_upper_inputs(X).clone()
    a.diagonal().add_(sigma2)  # + sigma2 I, without an n x n identity
    return ExactModel(
        z=z, sigma2=torch.as_tensor(sigma2, dtype=a.dtype, device=a.device),
        chol_a=cholesky_upper(a, jitter),
    )


def exact_trained(model: ExactModel, y) -> ExactTrained:
    alpha = solve_tri(model.chol_a, solve_tri(model.chol_a, y, trans=True))
    l = -0.5 * (torch.dot(y, alpha) + log_det_tri(model.chol_a)
                + y.shape[0] * LOG_2PI)
    return ExactTrained(model=model, y=y, alpha=alpha, l=l)


def log_evidence_exact(kernel, X, y, sigma2, *,
                       jitter: float | None = 0.0) -> torch.Tensor:
    """Differentiable in the kernel's hypers and ``sigma2``."""
    return exact_trained(calc_exact(kernel, X, sigma2, jitter=jitter), y).l


def predict_means_exact(kernel, trained: ExactTrained, Xs) -> torch.Tensor:
    return matmul(kernel.k_cross(Xs, trained.model.z), trained.alpha)


def predict_variances_exact(kernel, trained: ExactTrained, Xs, *,
                            predictive: bool = True) -> torch.Tensor:
    """Pointwise posterior variance; ``predictive`` adds sigma2."""
    ks = kernel.k_cross(Xs, trained.model.z)
    vs = solve_tri(trained.model.chol_a, ks.T, trans=True)  # (n, n*)
    var = kernel.k_diag(Xs) - rows_sqr_norm(vs.T)
    return var + trained.model.sigma2 if predictive else var


def covariances_exact(kernel, trained: ExactTrained, Xs, *,
                      predictive: bool = False) -> torch.Tensor:
    """Full posterior covariance at Xs, (n*, n*)."""
    kss = kernel.k_upper(kernel.inducing_from_inputs(Xs))
    ks = kernel.k_cross(Xs, trained.model.z)
    vs = solve_tri(trained.model.chol_a, ks.T, trans=True)
    cov = kss - matmul(vs.T, vs)
    if predictive:
        cov = cov + trained.model.sigma2 * torch.eye(
            cov.shape[0], dtype=cov.dtype, device=cov.device)
    return cov


def loo_posterior(trained: ExactTrained):
    """Per-point LOO predictive (mu_i, var_i) from one factorization
    (Sundararajan & Keerthi 2001)."""
    c = rows_sqr_norm(inv_tri_upper(trained.model.chol_a))  # diag(A^-1)
    var = 1.0 / c
    return trained.y - trained.alpha * var, var


def loo_log_likelihood(trained: ExactTrained) -> torch.Tensor:
    """sum_i log N(y_i | mu_-i, var_-i), GPML eq. 5.11."""
    mu, var = loo_posterior(trained)
    resid = trained.y - mu
    return -0.5 * torch.sum(torch.log(var) + resid * resid / var + LOG_2PI)


def loo_objective_exact(kernel, X, y, sigma2, *,
                        jitter: float | None = 0.0) -> torch.Tensor:
    """Differentiable LOO pseudo-likelihood for hyperparameter training."""
    return loo_log_likelihood(
        exact_trained(calc_exact(kernel, X, sigma2, jitter=jitter), y))


def fit_exact(kernel0, X, y, sigma2_0, *, objective: str = "evidence",
              jitter: float | None = 0.0, learn_sigma2: bool = True,
              max_iter: int = 100, step: float = 0.1, tol: float = 0.1,
              epsabs: float = 0.1):
    """Hyperparameter training over the exact objective ("evidence" or
    "loo", mean-scaled) with the packed device L-BFGS and
    ``make_pack(..., learn_inducing=False)``.  ``kernel0`` is the starting
    kernel (JAX's ``family, params0``).  Returns (trained, kernel,
    sigma2)."""
    from ..optim.lbfgs_device import fit_packed_objective, value_and_grad
    from ..optim.pack import make_pack

    obj = {"evidence": log_evidence_exact, "loo": loo_objective_exact}[objective]
    pack = make_pack(kernel0, X[:1], sigma2_0, learn_sigma2=learn_sigma2,
                     learn_inducing=False)
    n = X.shape[0]

    def neg(x, X, y):
        kernel, _, sigma2 = pack.unpack(x)
        return -obj(kernel, X, y, sigma2, jitter=jitter) / n

    st = fit_packed_objective(value_and_grad(neg), pack, (X, y), step=step,
                              tol=tol, epsabs=epsabs, max_iter=max_iter)
    kernel, _, sigma2 = pack.unpack(st.x)
    with torch.no_grad():
        trained = exact_trained(calc_exact(kernel, X, sigma2, jitter=jitter),
                                y)
    return trained, kernel, sigma2
