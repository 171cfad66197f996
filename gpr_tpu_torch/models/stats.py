"""Regression-quality statistics: the counterpart of
``gpr_tpu/models/stats.py`` (fitc_gp.ml:305-375), the nine metrics the
reference reports during training, with its conventions:

  * target_variance is the *uncentered* second moment |y|^2 / n (:319);
  * msll = prior_l - l / n with prior_l = -1/2 log(2 pi tv) - 1/2
    (:329-334), the mean standardized log loss against the trivial
    Gaussian fit.

Every metric takes a dense ``TrainedState`` or a ``StreamingTrained``: the
means at the training inputs come from ``calc_means``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .fitc import calc_means


@dataclasses.dataclass(frozen=True)
class Stats:
    n_samples: int
    target_variance: torch.Tensor
    sse: torch.Tensor
    mse: torch.Tensor
    rmse: torch.Tensor
    smse: torch.Tensor
    msll: torch.Tensor
    mad: torch.Tensor
    maxad: torch.Tensor


def calc_n_samples(trained) -> int:
    """fitc_gp.ml:318."""
    return trained.y.shape[0]


def calc_target_variance(trained) -> torch.Tensor:
    """Uncentered second moment |y|^2/n (fitc_gp.ml:319)."""
    y = trained.y
    return torch.dot(y, y) / y.shape[0]


def calc_sse(trained) -> torch.Tensor:
    """fitc_gp.ml:321-323."""
    resid = trained.y - calc_means(trained)
    return torch.dot(resid, resid)


def calc_mse(trained) -> torch.Tensor:
    return calc_sse(trained) / calc_n_samples(trained)


def calc_rmse(trained) -> torch.Tensor:
    return torch.sqrt(calc_mse(trained))


def calc_smse(trained) -> torch.Tensor:
    """fitc_gp.ml:327."""
    return calc_mse(trained) / calc_target_variance(trained)


def calc_msll(trained) -> torch.Tensor:
    """Mean standardized log loss vs the trivial Gaussian
    (fitc_gp.ml:329-334)."""
    tv = calc_target_variance(trained)
    prior_l = -0.5 * torch.log(2.0 * math.pi * tv) - 0.5
    return prior_l - trained.l / calc_n_samples(trained)


def calc_mad(trained) -> torch.Tensor:
    """fitc_gp.ml:336-344."""
    return torch.mean(torch.abs(trained.y - calc_means(trained)))


def calc_maxad(trained) -> torch.Tensor:
    """fitc_gp.ml:346-352."""
    return torch.max(torch.abs(trained.y - calc_means(trained)))


def calc_stats(trained) -> Stats:
    """All nine metrics from one pass over the residuals."""
    y = trained.y
    n = y.shape[0]
    resid = y - calc_means(trained)
    target_variance = torch.dot(y, y) / n
    sse = torch.dot(resid, resid)
    mse = sse / n
    prior_l = -0.5 * torch.log(2.0 * math.pi * target_variance) - 0.5
    ad = torch.abs(resid)
    return Stats(
        n_samples=n,
        target_variance=target_variance,
        sse=sse,
        mse=mse,
        rmse=torch.sqrt(mse),
        smse=mse / target_variance,
        msll=prior_l - trained.l / n,
        mad=torch.mean(ad),
        maxad=torch.max(ad),
    )


@dataclasses.dataclass(frozen=True)
class ClassifyStats:
    """Classification-quality statistics (the JAX package's metric set; the
    reference is regression-only).  ``msll`` is the mean log loss relative
    to the trivial base-rate predictor: negative means the model beats
    it."""

    n_samples: int
    base_rate: torch.Tensor  # fraction of positive labels
    error_rate: torch.Tensor  # misclassification at threshold 1/2
    log_loss: torch.Tensor  # mean negative log likelihood, nats
    msll: torch.Tensor  # log_loss - base-rate log loss
    brier: torch.Tensor  # mean squared probability error
    auc: torch.Tensor  # rank AUC (ties broken by sort order)


def calc_classify_stats(y, prob) -> ClassifyStats:
    """``y`` in {-1, +1} (or {0, 1}), ``prob`` = P(y = +1) per point."""
    y01 = torch.where(y > 0, 1.0, 0.0).to(prob.dtype)
    n = y01.shape[0]
    p = torch.clamp(prob, 1e-12, 1.0 - 1e-12)
    base = torch.mean(y01)
    base_c = torch.clamp(base, 1e-12, 1.0 - 1e-12)
    log_loss = -torch.mean(y01 * torch.log(p) + (1.0 - y01) * torch.log1p(-p))
    prior_ll = -(base_c * torch.log(base_c)
                 + (1.0 - base_c) * torch.log1p(-base_c))
    # rank AUC: P(score_pos > score_neg) via the rank-sum identity
    order = torch.argsort(prob, stable=True)
    ranks = torch.zeros_like(p).scatter(
        0, order, torch.arange(1, n + 1, dtype=p.dtype, device=p.device))
    n_pos = torch.sum(y01)
    n_neg = n - n_pos
    auc = ((torch.sum(ranks * y01) - n_pos * (n_pos + 1.0) / 2.0)
           / torch.clamp(n_pos * n_neg, min=1.0))
    return ClassifyStats(
        n_samples=n,
        base_rate=base,
        error_rate=torch.mean(((prob > 0.5) != (y01 > 0.5)).to(p.dtype)),
        log_loss=log_loss,
        msll=log_loss - prior_ll,
        brier=torch.mean((p - y01) ** 2),
        auc=auc,
    )
