"""Posterior prediction: means, variances, covariances.  The counterpart of
``gpr_tpu/models/predict.py`` (fitc_gp.ml:377-624).

The predictor state is the reference's: means need (Z, coeffs),
(co)variances (Z, chol_km, r_mat).  Both predictors read only those fields,
so they take the dense states of ``models/fitc.py`` and the streaming
``StreamingTrained`` / ``StreamingModelLite`` alike.  The JAX package's two
documented corrections of the reference carry over:
``covariances_fitc_model_inputs`` and ``covariances_fic_model_inputs`` use
the unscaled Knm B^-1 Kmn (so their diagonals equal the variances), and
``covariances_fic`` forms diag(Qt) with the chol_km solve.
"""

from __future__ import annotations

import dataclasses

import torch

from ..numerics.linalg import matmul, rows_sqr_norm, solve_tri_right


@dataclasses.dataclass(frozen=True)
class MeanPredictor:
    """(inducing, coeffs): fitc_gp.ml:377-395."""

    z: torch.Tensor  # (m, dz)
    coeffs: torch.Tensor  # (m,)


@dataclasses.dataclass(frozen=True)
class CoVariancePredictor:
    """(inducing, chol_km, r_mat): fitc_gp.ml:430-448."""

    z: torch.Tensor
    chol_km: torch.Tensor  # upper U
    r_mat: torch.Tensor  # upper R


def mean_predictor(trained) -> MeanPredictor:
    return MeanPredictor(z=trained.model.inducing.z, coeffs=trained.coeffs)


def co_variance_predictor(model) -> CoVariancePredictor:
    return CoVariancePredictor(
        z=model.inducing.z, chol_km=model.inducing.chol_km, r_mat=model.r_mat
    )


# -- means ------------------------------------------------------------------


def predict_mean_one(kernel, mp: MeanPredictor, x) -> torch.Tensor:
    """Single-point mean (fitc_gp.ml:398-411): k_m . coeffs."""
    return torch.dot(kernel.k_cross(x[None, :], mp.z)[0], mp.coeffs)


def predict_means(kernel, mp: MeanPredictor, X) -> torch.Tensor:
    """Batch means = Ktm coeffs (fitc_gp.ml:415-427), one product."""
    return matmul(kernel.k_cross(X, mp.z), mp.coeffs)


# -- variances --------------------------------------------------------------


def predict_variances(kernel, cvp: CoVariancePredictor, X, sigma2, *,
                      predictive=True) -> torch.Tensor:
    """Marginal posterior variances at new inputs (fitc_gp.ml:498-529):
    kt_diag - rowsq(Ktm U^-1) + rowsq(Ktm R^-1) (+ sigma2 if predictive)."""
    ktm = kernel.k_cross(X, cvp.z)
    v = solve_tri_right(ktm, cvp.chol_km)
    w = solve_tri_right(ktm, cvp.r_mat)
    out = kernel.k_diag(X) - rows_sqr_norm(v) + rows_sqr_norm(w)
    return out + sigma2 if predictive else out


def predict_variance_one(kernel, cvp: CoVariancePredictor, x, sigma2, *,
                         predictive=True) -> torch.Tensor:
    """Single-point variance (fitc_gp.ml:451-483)."""
    return predict_variances(kernel, cvp, x[None, :], sigma2,
                             predictive=predictive)[0]


def variances_model_inputs(model, *, predictive=True) -> torch.Tensor:
    """Variances at the training inputs of a dense model, reusing r and Knm
    (fitc_gp.ml:489-496): r + rowsq(Knm R^-1)."""
    w = solve_tri_right(model.knm, model.r_mat)
    out = model.r + rows_sqr_norm(w)
    return out + model.sigma2 if predictive else out


# -- covariances ------------------------------------------------------------


def _finalize_cov(cov, sigma2, predictive):
    if predictive:
        n = cov.shape[0]
        cov = cov + sigma2 * torch.eye(n, dtype=cov.dtype, device=cov.device)
    return cov


def covariances_fitc(kernel, cvp: CoVariancePredictor, X, sigma2, *,
                     predictive=True) -> torch.Tensor:
    """Full posterior covariance, FITC flavor (fitc_gp.ml:580-593): exact
    prior Kt - Ktm Km^-1 Kmt + Ktm B^-1 Kmt."""
    kt = kernel.k_upper_inputs(X)
    ktm = kernel.k_cross(X, cvp.z)
    v = solve_tri_right(ktm, cvp.chol_km)
    w = solve_tri_right(ktm, cvp.r_mat)
    cov = kt - matmul(v, v.mT) + matmul(w, w.mT)
    return _finalize_cov(cov, sigma2, predictive)


def covariances_fitc_model_inputs(model, kernel, X, *,
                                  predictive=True) -> torch.Tensor:
    """FITC covariances at the training inputs of a dense model, reusing V
    and R (fitc_gp.ml:569-578, with the scaling correction):
    Kt - V V' + (Knm R^-1)(Knm R^-1)'."""
    kt = kernel.k_upper_inputs(X)
    w = solve_tri_right(model.knm, model.r_mat)
    cov = kt - matmul(model.v, model.v.mT) + matmul(w, w.mT)
    return _finalize_cov(cov, model.sigma2, predictive)


def covariances_fic(kernel, cvp: CoVariancePredictor, X, sigma2, *,
                    predictive=True) -> torch.Tensor:
    """Full posterior covariance, FIC flavor (fitc_gp.ml:597-623): low-rank
    Ktm B^-1 Kmt plus diag(kt_diag - diag(Qt))."""
    ktm = kernel.k_cross(X, cvp.z)
    v = solve_tri_right(ktm, cvp.chol_km)
    r_t = kernel.k_diag(X) - rows_sqr_norm(v)
    w = solve_tri_right(ktm, cvp.r_mat)
    cov = matmul(w, w.mT) + torch.diag(r_t)
    return _finalize_cov(cov, sigma2, predictive)


def covariances_fic_model_inputs(model, *, predictive=True) -> torch.Tensor:
    """FIC covariances at the training inputs of a dense model
    (fitc_gp.ml:608-613, with the scaling correction): diag(r) + Knm B^-1
    Kmn."""
    w = solve_tri_right(model.knm, model.r_mat)
    cov = matmul(w, w.mT) + torch.diag(model.r)
    return _finalize_cov(cov, model.sigma2, predictive)
