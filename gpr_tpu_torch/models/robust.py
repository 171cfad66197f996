"""Robust GP regression: Student-t observation noise by variational EM.
The counterpart of ``gpr_tpu/models/robust.py``.

The scale-mixture representation

  y_i | f_i, lam_i ~ N(f_i, sigma2 / lam_i),   lam_i ~ Gamma(nu/2, nu/2)

with a mean-field posterior q(f) q(lam):

  E-step   lam_hat_i = E[lam_i] = (nu+1) / (nu + ((y_i-mu_i)^2+v_i)/sigma2)
  q(f)     the exact FITC posterior under per-row noise sigma2 / lam_hat
  M-step   hypers and sigma2 maximize the heteroskedastic Gaussian evidence
           with noise sigma2 / lam_hat (the rest of the bound is constant
           in them once q(lam) is frozen)

so every step is the existing engine: the E-step one posterior pass, the
M-step the packed L-BFGS objective with (X, y, lam) as data.  Trained
lam_hat_i << 1 flags row i as an outlier.  ``t_elbo`` is the full
mean-field bound (it rises across E-steps at fixed hypers; it also scores
nu).  ``block_size`` streams both steps on the per-row sigma2 path of
``models/streaming.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..numerics.linalg import (
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
    solve_tri_right,
)
from .fitc import calc_means, calc_model, calc_trained, log_evidence


@torch.no_grad()
def _t_moments_blocked(kernel, z, sigma2, X, y, lam, block_size, jitter):
    """The closed forms of ``t_posterior_moments`` with Knm never
    materialized: one ``streaming_coeffs`` pass on the per-row noise for
    the m-space factors, then a blocked pass giving each row's (mu, var).
    Memory O(n + block m)."""
    from .streaming import streaming_coeffs

    noise = sigma2 / lam
    inducing, r_mat, coeffs = streaming_coeffs(
        kernel, z, noise, X, y, block_size=block_size, jitter=jitter)
    u_inv = inv_tri_upper(inducing.chol_km)
    r_inv = inv_tri_upper(r_mat)
    mu = torch.empty_like(y)
    var = torch.empty_like(y)
    for i in range(0, X.shape[0], block_size):
        x_b, y_b, nz_b = (t[i:i + block_size] for t in (X, y, noise))
        knm = kernel.k_cross(x_b, inducing.z)
        v = matmul(knm, u_inv)
        r = kernel.k_diag(x_b) - rows_sqr_norm(v)
        is_ = 1.0 / (r + nz_b)
        alpha = is_ * (y_b - matmul(knm, coeffs))
        mu[i:i + block_size] = y_b - nz_b * alpha
        w2 = rows_sqr_norm(matmul(knm, r_inv))
        s_inv_diag = is_ * (1.0 - is_ * w2)
        var[i:i + block_size] = torch.clamp(
            nz_b * (1.0 - nz_b * s_inv_diag), min=1e-12)
    return mu, var, (inducing, r_mat, coeffs)


def t_posterior_moments(kernel, z, sigma2, X, y, lam, *,
                        variational: bool = False,
                        jitter: float | None = None,
                        block_size: int | None = None):
    """(mu, var_latent, trained): the exact posterior of f at the training
    rows under the prior K = Q + diag(r) and noise Lam = sigma2 / lam
    (not the engine's train-input predictor, which drops diag(r)'s cross
    terms).  With S = K + Lam and R'R = B:

      alpha = S^-1 y = is (y - Knm coeffs),   mu = y - Lam alpha,
      var_i = Lam_i (1 - Lam_i (S^-1)_ii),
      (S^-1)_ii = is_i (1 - is_i w2_i),       w2 = rowsq(Knm R^-1).

    ``block_size`` streams the same formulas; the third return is then the
    (inducing, r_mat, coeffs) triple instead of a TrainedState."""
    if block_size is not None:
        return _t_moments_blocked(kernel, z, sigma2, X, y, lam, block_size,
                                  jitter)
    noise = sigma2 / lam
    model = calc_model(kernel, X, z, noise, variational=variational,
                       jitter=jitter)
    trained = calc_trained(model, y)
    alpha = model.is_ * (y - calc_means(trained))  # S^-1 y
    mu = y - noise * alpha
    w2 = rows_sqr_norm(solve_tri_right(model.knm, model.r_mat))
    s_inv_diag = model.is_ * (1.0 - model.is_ * w2)
    var = torch.clamp(noise * (1.0 - noise * s_inv_diag), min=1e-12)
    return mu, var, trained


def t_lambda_update(y, mu, var, sigma2, nu):
    """E-step: lam_hat = E_q[lam] given the current q(f) moments."""
    e2 = torch.square(y - mu) + var
    return (nu + 1.0) / (nu + e2 / sigma2)


def t_elbo(kernel, z, sigma2, X, y, lam_pair, *, variational: bool = False,
           jitter: float | None = None):
    """Mean-field ELBO for q(lam) = Gamma(a, b), ``lam_pair = (a, b)``
    (lam_hat = a / b), collapsed over q(f):

      ELBO = log Z_gauss(noise = sigma2 / lam_hat)
             + 0.5 sum(E[log lam] - log lam_hat)
             - KL(Gamma(a, b) || Gamma(nu/2, nu/2)),

    returned as a function of nu: ``t_elbo(...)(nu)``."""
    a, b = lam_pair
    lam_hat = a / b
    lz = log_evidence(kernel, z, sigma2 / lam_hat, X, y,
                      variational=variational, jitter=jitter)
    digamma_a = torch.special.digamma(a)
    corr = 0.5 * torch.sum(digamma_a - torch.log(b) - torch.log(lam_hat))

    def of_nu(nu):
        a0 = b0 = torch.as_tensor(nu / 2.0, dtype=a.dtype, device=a.device)
        kl = torch.sum(
            (a - a0) * digamma_a - torch.lgamma(a) + torch.lgamma(a0)
            + a0 * (torch.log(b) - torch.log(b0)) + lam_hat * (b0 - b))
        return lz + corr - kl

    return of_nu


def t_em_sweeps(kernel, z, sigma2, X, y, *, nu: float = 4.0,
                sweeps: int = 10, variational: bool = False,
                jitter: float | None = None,
                block_size: int | None = None):
    """Fixed-hyper mean-field EM: alternate the exact q(f) and q(lam)
    updates ``sweeps`` times from lam = 1.  Returns (lam_hat, (a, b))."""
    lam = torch.ones_like(y, dtype=X.dtype)
    a = torch.full_like(lam, (nu + 1.0) / 2.0)
    b = None
    for _ in range(sweeps):
        mu, var, _ = t_posterior_moments(
            kernel, z, sigma2, X, y, lam, variational=variational,
            jitter=jitter, block_size=block_size)
        b = (nu + (torch.square(y - mu) + var) / sigma2) / 2.0
        lam = a / b
    return lam, (a, b)


@torch.no_grad()
def t_select_nu(kernel, z, sigma2, X, y, *,
                nu_grid=(2.5, 3.0, 4.0, 6.0, 10.0, 20.0, 50.0),
                sweeps: int = 10, variational: bool = False,
                jitter: float | None = None):
    """Degrees of freedom by the mean-field ELBO at fixed hypers: the EM
    sweeps per candidate nu, each converged q(lam) scored by its own bound.
    Returns (best_nu, {nu: elbo})."""
    scores = {}
    for nu in nu_grid:
        _, pair = t_em_sweeps(kernel, z, sigma2, X, y, nu=float(nu),
                              sweeps=sweeps, variational=variational,
                              jitter=jitter)
        scores[float(nu)] = float(t_elbo(
            kernel, z, sigma2, X, y, pair, variational=variational,
            jitter=jitter)(float(nu)))
    return max(scores, key=scores.get), scores


def fit_t(X, y, pack, *, nu: float = 4.0, n_em: int = 6, e_sweeps: int = 3,
          m_step_iters: int = 25, variational: bool = False,
          jitter: float | None = None, normalize: bool = True, mesh=None,
          block_size: int | None = None, **fit_kwargs):
    """Robust training: packed L-BFGS M-steps (the heteroskedastic evidence
    with the current weights) alternating with mean-field E-steps.  The
    JAX ``fit_t(family, ...)`` minus ``family``: the pack's kernel class is
    it.  ``pack`` must learn sigma2 (the t scale).  ``block_size`` streams
    both steps.  ``mesh`` (JAX's data-parallel path) is not ported.
    Returns (kernel, z, sigma2, lam_hat, state)."""
    if not pack.learn_sigma2:
        raise ValueError(
            "fit_t learns the t scale through the pack's sigma2 slot: "
            "build the pack with learn_sigma2=True"
        )
    if mesh is not None:
        raise NotImplementedError(
            "fit_t(mesh=...) is not ported to gpr_tpu_torch yet (ROADMAP.md, "
            "queue 1 item 13)")
    from ..optim.lbfgs_device import fit_packed_objective, value_and_grad
    from .streaming import streaming_log_evidence

    scale = 1.0 / X.shape[0] if normalize else 1.0

    def neg(x, X, y, lam):
        kernel, z, sigma2 = pack.unpack(x)
        if block_size is not None:
            return -scale * streaming_log_evidence(
                kernel, z, sigma2 / lam, X, y, variational=variational,
                jitter=jitter, block_size=block_size)
        return -scale * log_evidence(kernel, z, sigma2 / lam, X, y,
                                     variational=variational, jitter=jitter)

    fg = value_and_grad(neg)
    lam = torch.ones_like(y, dtype=X.dtype)
    cur, st = pack, None
    for _ in range(n_em):
        st = fit_packed_objective(fg, cur, (X, y, lam),
                                  max_iter=m_step_iters, **fit_kwargs)
        kernel, z, sigma2 = pack.unpack(st.x)
        with torch.no_grad():
            for _ in range(e_sweeps):
                mu, var, _ = t_posterior_moments(
                    kernel, z, sigma2, X, y, lam, variational=variational,
                    jitter=jitter, block_size=block_size)
                lam = t_lambda_update(y, mu, var, sigma2, nu)
        cur = dataclasses.replace(cur, x0=st.x)  # warm-start the next M-step
    kernel, z, sigma2 = pack.unpack(st.x)
    return kernel, z, sigma2, lam, st


def t_predict(kernel, z, sigma2, X, y, lam, Xstar, *, nu: float = 4.0,
              variational: bool = False, jitter: float | None = None):
    """(mean, latent_var, noise_var) at Xstar from the converged robust
    posterior; noise_var is the Student-t noise variance sigma2 nu/(nu-2)
    (inf for nu <= 2)."""
    from .predict import (
        CoVariancePredictor,
        MeanPredictor,
        predict_means,
        predict_variances,
    )

    model = calc_model(kernel, X, z, sigma2 / lam, variational=variational,
                       jitter=jitter)
    trained = calc_trained(model, y)
    z = model.inducing.z
    mu = predict_means(kernel, MeanPredictor(z=z, coeffs=trained.coeffs),
                       Xstar)
    cvp = CoVariancePredictor(z=z, chol_km=model.inducing.chol_km,
                              r_mat=model.r_mat)
    var = predict_variances(kernel, cvp, Xstar, 0.0, predictive=False)
    sigma2 = torch.as_tensor(sigma2, dtype=mu.dtype, device=mu.device)
    noise_var = (sigma2 * nu / max(nu - 2.0, 1e-12) if nu > 2.0
                 else torch.full_like(sigma2, float("inf")))
    return mu, var, noise_var
