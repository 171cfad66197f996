"""Posterior sampling: the counterpart of ``gpr_tpu/models/sample.py``
(fitc_gp.ml:628-695).

Each drawing function takes a ``torch.Generator`` first, where the JAX
package takes a key; the generator must live on the device of the
tensors it draws for.  The draws are therefore not the JAX package's:
what carries over is the math (the covariance factor, the FIC
decomposition) and hence the moments.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import config
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Single-point marginal sampler (fitc_gp.ml:628-648)."""

    mean: torch.Tensor
    stddev: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CovSampler:
    """Correlated posterior sampler (fitc_gp.ml:652-671)."""

    means: torch.Tensor  # (t,)
    cov_chol: torch.Tensor  # upper U with Sigma (+ jitter) = U'U


def sampler(mean, variance, sigma2, *, predictive=True) -> Sampler:
    used = variance + sigma2 if predictive else variance
    return Sampler(mean=torch.as_tensor(mean),
                   stddev=torch.sqrt(torch.as_tensor(used)))


def sample(generator, s: Sampler, n: int | None = None) -> torch.Tensor:
    """One draw (a scalar) or ``n`` draws of the marginal."""
    shape = () if n is None else (n,)
    eps = torch.randn(shape, generator=generator, dtype=s.mean.dtype,
                      device=s.mean.device)
    return s.mean + s.stddev * eps


def cov_sampler(means, covariances, sigma2=None, *, predictive=True,
                jitter: float | None = None) -> CovSampler:
    """Jittered Cholesky of the posterior covariance (fitc_gp.ml:661-671);
    ``predictive=True`` adds sigma2 to the diagonal first.  The jitter
    defaults to ``config.cholesky_jitter``."""
    cov = covariances
    if predictive:
        if sigma2 is None:
            raise ValueError("predictive sampling requires sigma2")
        t = cov.shape[0]
        cov = cov + sigma2 * torch.eye(t, dtype=cov.dtype, device=cov.device)
    if jitter is None:
        jitter = config.cholesky_jitter
    return CovSampler(means=means, cov_chol=cholesky_upper(cov, jitter))


def cov_sample(generator, cs: CovSampler,
               n: int | None = None) -> torch.Tensor:
    """``n`` joint draws, means + U' eps with eps ~ N(0, I)
    (fitc_gp.ml:673-694): (t,) if n is None else (t, n)."""
    t = cs.means.shape[0]
    shape = (t,) if n is None else (t, n)
    eps = torch.randn(shape, generator=generator, dtype=cs.cov_chol.dtype,
                      device=cs.cov_chol.device)
    correlated = matmul(cs.cov_chol.mT, eps)
    return correlated + (cs.means if n is None else cs.means[:, None])


def sample_fic_blocked(generator, kernel, cvp, X, sigma2, n_samples: int, *,
                       predictive: bool = True, block_size: int = 8192):
    """Exact joint FIC posterior samples at O(t m) a draw.

    The FIC posterior covariance is low rank plus diagonal, Sigma = W W' +
    diag(r_t) with W = Ktm R^-1 and r_t = kt_diag - rowsq(Ktm U^-1) (+
    sigma2 if predictive), so mean + W eps_m + sqrt(r_t) eps_t with eps ~
    N(0, I) is exact without the t x t covariance.  eps_m is drawn once
    for all points, then eps_t block by block.  Returns (t, n_samples);
    the means are NOT added (compose with ``predict_means``)."""
    t, m = X.shape[0], cvp.z.shape[0]
    kw = {"generator": generator, "dtype": X.dtype, "device": X.device}
    eps_m = torch.randn(m, n_samples, **kw)
    u_inv = inv_tri_upper(cvp.chol_km)
    r_inv = inv_tri_upper(cvp.r_mat)
    out = torch.empty(t, n_samples, dtype=X.dtype, device=X.device)
    for i in range(0, t, block_size):
        x_b = X[i:i + block_size]
        ktm = kernel.k_cross(x_b, cvp.z)
        r_t = kernel.k_diag(x_b) - rows_sqr_norm(matmul(ktm, u_inv))
        if predictive:
            r_t = r_t + sigma2
        r_t = torch.clamp(r_t, min=0.0)
        eps_t = torch.randn(x_b.shape[0], n_samples, **kw)
        out[i:i + block_size] = (matmul(matmul(ktm, r_inv), eps_m)
                                 + torch.sqrt(r_t)[:, None] * eps_t)
    return out
