"""FITC / FIC engine, standard and variational (Titsias-style): the
counterpart of ``gpr_tpu/models/fitc.py``.

The inducing state serves the streaming path; the dense engine below
materializes Knm (n x m) and is the small-n path (the f64 polish takes it
whenever the rows fit one block).  Math, as in the JAX package:

    U  = chol(Km + jitter I)          (upper, Km = K(Z, Z))
    V  = Knm U^-1                     r = kn_diag - rowsq(V)
    s  = r + sigma2,  is = 1/s
    R  = upper factor with R'R = B = Km + jitter I + Knm' diag(is) Knm
    l1 = -1/2 (log|B| - log|Km| + sum log s + n log 2pi)
         (variational adds -1/2 sum(is r))
    t  = R^-T Knm' (is y),  l2 = -1/2 (|sqrt(is) y|^2 - |t|^2)
    coeffs = R^-1 t

Gradients are autograd's, as the JAX package uses AD.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import config
from ..kernels.base import sqdist
from ..numerics.linalg import (
    cholesky_upper,
    log_det_tri,
    matmul,
    qr_r_positive,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class InducingState:
    """Precomputed inducing-point quantities."""

    z: torch.Tensor  # (m, dz) inducing representation
    km: torch.Tensor  # (m, m) K(Z, Z), no jitter
    chol_km: torch.Tensor  # upper U: Km + jitter I = U'U
    log_det_km: torch.Tensor  # log|Km + jitter I|


@dataclasses.dataclass(frozen=True)
class ModelState:
    """Everything the evidence and predictors need."""

    inducing: InducingState
    sigma2: torch.Tensor
    kn_diag: torch.Tensor  # (n,)
    knm: torch.Tensor  # (n, m)
    v: torch.Tensor  # (n, m) = Knm U^-1
    r: torch.Tensor  # (n,)  FITC diag correction
    is_: torch.Tensor  # (n,)  1 / (r + sigma2)
    sqrt_is: torch.Tensor  # (n,)
    r_mat: torch.Tensor  # (m, m) upper, R'R = B
    l1: torch.Tensor  # scalar


@dataclasses.dataclass(frozen=True)
class TrainedState:
    """Model conditioned on targets."""

    model: ModelState
    y: torch.Tensor  # (n,)
    coeffs: torch.Tensor  # (m,)
    l2: torch.Tensor
    l: torch.Tensor  # total log evidence l1 + l2


def choose_n_first_inputs(kernel, X: torch.Tensor,
                          n_inducing: int) -> torch.Tensor:
    """First-n selection (fitc_gp.ml:66-72)."""
    return kernel.inducing_from_inputs(X[:n_inducing])


def _draw_rows(generator, n: int, k: int, device) -> torch.Tensor:
    """k distinct row indices of n, uniformly: the head of a permutation
    drawn on ``device`` (whose generator ``generator`` must be)."""
    return torch.randperm(n, generator=generator, device=device)[:k]


def choose_n_random_inputs(generator, kernel, X: torch.Tensor,
                           n_inducing: int) -> torch.Tensor:
    """Uniform random subset without replacement (the reference's
    Fisher-Yates draw, fitc_gp.ml:74-89), drawn on X's device."""
    idx = _draw_rows(generator, X.shape[0], n_inducing, X.device)
    return kernel.inducing_from_inputs(X[idx])


def _lloyd(X: torch.Tensor, c: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd iterations from centroids ``c``: assignment by the
    sqdist argmin, sums by a one-hot GEMM (no scatter); an empty cluster
    keeps its centroid."""
    m = c.shape[0]
    for _ in range(iters):
        assign = torch.argmin(sqdist(X, c), dim=1)
        onehot = torch.nn.functional.one_hot(assign, m).to(X.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = matmul(onehot.mT, X)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1.0)[:, None], c)
    return c


def choose_kmeans_inputs(generator, kernel, X: torch.Tensor,
                         n_inducing: int, *, iters: int = 10,
                         subsample: int | None = 100_000) -> torch.Tensor:
    """k-means inducing initialization (an extension; the reference only
    draws a random subset): Lloyd iterations from ``n_inducing`` random
    rows, on a random subsample of ``subsample`` rows where n exceeds it.
    Returns the kernel's inducing representation of the centroids."""
    n = X.shape[0]
    if subsample is not None and n > subsample:
        X = X[_draw_rows(generator, n, subsample, X.device)]
        n = subsample
    c0 = X[_draw_rows(generator, n, n_inducing, X.device)]
    return kernel.inducing_from_inputs(_lloyd(X, c0, iters))


def calc_inducing(kernel, z: torch.Tensor,
                  jitter: float | None = None) -> InducingState:
    """K(Z, Z), its jittered Cholesky and log-det."""
    km = kernel.k_upper(z)
    chol_km = cholesky_upper(km, jitter)
    return InducingState(
        z=z, km=km, chol_km=chol_km, log_det_km=log_det_tri(chol_km)
    )


def _resolve_factorization(factorization: str | None, n: int, m: int) -> str:
    f = factorization or config.factorization
    if f == "auto":
        # the tall QR costs about twice the Gram's flops: keep it for small
        # problems, where its stability is free
        f = "qr" if n * m <= (1 << 24) else "chol"
    if f not in ("qr", "chol"):
        raise ValueError(f"unknown factorization {f!r}; valid: qr, chol, auto")
    return f


def _calc_r_factor(inducing, knm, v, sqrt_is, factorization):
    """Upper R with R'R = B = (Km + jitter I) + Knm' diag(is) Knm.

    "qr" factors the stacked [diag(sqrt is) Knm; U] (the reference's
    Foster-2009 path, B never formed); "chol" factors the whitened
    I + (V sqrt(is))'(V sqrt(is)), whose eigenvalues are >= 1, and
    de-whitens R = R~ U.  Both give the R with a positive diagonal.
    """
    if factorization == "qr":
        a1 = knm * sqrt_is[:, None]
        return qr_r_positive(torch.cat([a1, inducing.chol_km], dim=0))
    a = v * sqrt_is[:, None]
    m = v.shape[1]
    bt = torch.eye(m, dtype=v.dtype, device=v.device) + matmul(a.mT, a)
    r_tilde = cholesky_upper(bt, jitter=0.0)
    return matmul(r_tilde, inducing.chol_km)


def calc_model(kernel, X, z, sigma2, *, variational: bool = False,
               factorization: str | None = None, jitter: float | None = None,
               inducing: InducingState | None = None, kn_diag=None,
               knm=None) -> ModelState:
    """Full model precomputation.  ``variational=True`` applies the Titsias
    correction to l1.  Precomputed pieces can be passed to avoid
    recomputation (then ``kernel``, ``X`` and ``z`` may be None)."""
    if inducing is None:
        inducing = calc_inducing(kernel, z, jitter)
    if kn_diag is None:
        kn_diag = kernel.k_diag(X)
    if knm is None:
        knm = kernel.k_cross(X, inducing.z)
    n, m = knm.shape

    v = solve_tri_right(knm, inducing.chol_km)  # Knm U^-1
    r = kn_diag - rows_sqr_norm(v)
    s = r + sigma2
    is_ = 1.0 / s
    sqrt_is = torch.sqrt(is_)

    fact = _resolve_factorization(factorization, n, m)
    r_mat = _calc_r_factor(inducing, knm, v, sqrt_is, fact)

    log_det_b = log_det_tri(r_mat)
    log_det_s = torch.sum(torch.log(s))
    l1 = -0.5 * (log_det_b - inducing.log_det_km + log_det_s + n * LOG_2PI)
    if variational:
        l1 = l1 - 0.5 * torch.dot(is_, r)

    return ModelState(
        inducing=inducing,
        sigma2=torch.as_tensor(sigma2, dtype=knm.dtype, device=knm.device),
        kn_diag=kn_diag, knm=knm, v=v, r=r, is_=is_, sqrt_is=sqrt_is,
        r_mat=r_mat, l1=l1,
    )


def update_sigma2(model: ModelState, sigma2, *, variational: bool = False,
                  factorization: str | None = None) -> ModelState:
    """Re-derive s, is, R and l1 for a new noise level, reusing kn_diag,
    Knm and the inducing state."""
    return calc_model(
        None, None, None, sigma2, variational=variational,
        factorization=factorization, inducing=model.inducing,
        kn_diag=model.kn_diag, knm=model.knm,
    )


def calc_trained(model: ModelState, y) -> TrainedState:
    """Condition on targets: t = R^-T Knm' (is y), which equals Q1' y_ of the
    reference's QR formulation, so no orthogonal factor is needed."""
    y_ = y * model.sqrt_is
    u = matmul(model.knm.mT, model.is_ * y)  # (m,)
    t = solve_tri(model.r_mat, u, trans=True)  # R^-T u
    # quad >= 0 mathematically; clamp the f32 cancellation overshoot that
    # would otherwise inflate the evidence
    l2 = -0.5 * torch.clamp(torch.dot(y_, y_) - torch.dot(t, t), min=0.0)
    coeffs = solve_tri(model.r_mat, t)  # R^-1 t
    return TrainedState(model=model, y=y, coeffs=coeffs, l2=l2,
                        l=model.l1 + l2)


def calc_means(trained) -> torch.Tensor:
    """Posterior means at the training inputs: a streaming trained state
    carries them; the dense state multiplies Knm on demand."""
    means = getattr(trained, "means", None)
    if means is not None:
        return means
    return matmul(trained.model.knm, trained.coeffs)


def co_variance_coeffs(model: ModelState):
    """The (chol_km, r_mat) pair persisted for later variance prediction."""
    return model.inducing.chol_km, model.r_mat


def log_evidence(kernel, z, sigma2, X, y, *, variational: bool = False,
                 factorization: str | None = None,
                 jitter: float | None = None) -> torch.Tensor:
    """Scalar log marginal evidence l = l1 + l2, differentiable in the
    kernel's hypers, ``z`` and ``sigma2``."""
    model = calc_model(kernel, X, z, sigma2, variational=variational,
                       factorization=factorization, jitter=jitter)
    return calc_trained(model, y).l
