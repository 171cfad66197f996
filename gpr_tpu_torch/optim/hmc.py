"""Fully Bayesian hyperparameters: HMC over the (sparse-GP) evidence.  The
counterpart of ``gpr_tpu/optim/hmc.py``.

The reference is pure maximum likelihood (lib/fitc_gp.ml:1532-1671).  This
module samples the hyper POSTERIOR instead: p(theta | X, y) ~ exp(L(theta))
p(theta), with L the log evidence the optimizers use and p(theta) any
``optim.priors`` log density.  Predictions then mix over the draws
(:func:`predict_hmc_mixture`), which widens intervals where the evidence
surface is flat.

One transition is ``n_leapfrog`` evidence gradients.  Adaptation follows
Hoffman & Gelman (2014) dual averaging toward a target acceptance rate,
with a Stan-style regularized diagonal mass estimated from first-phase
warmup draws.  Nonfinite proposals are rejected (divergence guard), never
propagated.  The potential is any ``x -> (U, dU)`` pair, so
``make_objective``'s output plugs in directly, dense or streaming
(``block_size=``).

Where the JAX package runs the sampler as one jitted graph with the chains
under ``vmap``, this is a host loop of transitions that runs its chains
one after another, each from its own ``torch.Generator`` (seeded from the
caller's): the momentum and accept draws are not JAX's.  The accept
decision and the ``where``-gated state stay on the device; the host reads
nothing between transitions.  ``hmc``'s ``data=`` is kept
(``u_and_grad(x, *data)``) though a closure serves as well here.

The accept energy: the JAX package measured on the TPU that the MH accept
at |L| >~ 1e5 pinned near 0.5 under f32 GEMM rounding, and evaluates the
accept statistic alone at higher precision (``energy_fn``,
:func:`make_accept_energy`).  Leapfrog is reversible and volume-preserving
for any force field, so accepting with the accurate potential keeps the
chain exactly invariant for it.  On the H100 the same holds when the
forces run in TF32 (``config.matmul_precision = "high"``, bench.py's
session) and the accept energy in full f32 (PERF.md, PR 16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HMCResult:
    """Posterior draws plus the diagnostics needed to trust them."""

    samples: torch.Tensor  # (n_chains, n_samples, d) post-warmup draws
    potential: torch.Tensor  # (n_chains, n_samples) U = -log posterior
    accept_rate: torch.Tensor  # (n_chains,) mean MH accept prob, sampling
    step_size: torch.Tensor  # (n_chains,) adapted leapfrog step
    inv_mass: torch.Tensor  # (n_chains, d) adapted diagonal inverse mass
    rhat: np.ndarray  # (d,) split-chain R-hat
    ess: np.ndarray  # (d,) bulk effective sample size

    @property
    def flat(self) -> torch.Tensor:
        """All chains pooled: (n_chains * n_samples, d)."""
        return self.samples.reshape(-1, self.samples.shape[-1])


def _leapfrog(u_and_grad, x, p, grad, eps, inv_mass, n_steps):
    """n_steps of leapfrog; returns (x', p', U', dU')."""
    u = None
    half, step = 0.5 * eps, eps * inv_mass  # (JAX's products, hoisted)
    for _ in range(n_steps):
        p_half = p - half * grad
        x = x + step * p_half
        u, grad = u_and_grad(x)
        p = p_half - half * grad
    return x, p, u, grad


def _transition(u_and_grad, state, normal, uniform, log_eps, inv_mass,
                n_leapfrog, energy_fn=None):
    """One HMC proposal and MH accept.  state = (x, U, dU); ``normal`` (d,)
    standard-normal and ``uniform`` a U(0, 1) scalar are this transition's
    draws: the momentum is normal / sqrt(inv_mass) (M = 1/inv_mass).

    Returns (state', accept_prob).  Nonfinite proposal energies get accept
    probability 0 (divergence guard) and the where-gated state update never
    takes them.  ``energy_fn`` (x -> U), when given, re-evaluates the
    PROPOSAL's potential for the MH accept (and the carried U is kept at
    that precision).
    """
    x, u, grad = state
    eps = torch.exp(log_eps)
    p = normal / torch.sqrt(inv_mass)
    h0 = u + 0.5 * torch.sum(inv_mass * p * p)
    x_new, p_new, u_new, grad_new = _leapfrog(
        u_and_grad, x, p, grad, eps, inv_mass, n_leapfrog)
    if energy_fn is not None:
        u_new = energy_fn(x_new)
    h1 = u_new + 0.5 * torch.sum(inv_mass * p_new * p_new)
    # gate on the full energy DIFFERENCE: a nonfinite h0 (a poisoned state
    # that slipped past the init guard) must give alpha = 0, not NaN, or
    # the dual-averaging state is NaN for the rest of the run
    dh = h0 - h1
    log_alpha = torch.where(torch.isfinite(dh), torch.clamp(dh, max=0.0),
                            -math.inf)
    alpha = torch.exp(log_alpha)
    accept = torch.log(uniform) < log_alpha
    new_state = (torch.where(accept, x_new, x), torch.where(accept, u_new, u),
                 torch.where(accept, grad_new, grad))
    return new_state, alpha


def _dual_avg_init(log_eps0):
    """(t, h_bar, log_eps, log_eps_bar, mu), tensors like ``log_eps0``."""
    zero = torch.zeros_like(log_eps0)
    return (zero, zero, log_eps0, zero, log_eps0 + math.log(10.0))


def _dual_avg_update(da, alpha, target):
    """Hoffman & Gelman (2014) eq. 6 constants."""
    t, h_bar, _, log_eps_bar, mu = da
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target - alpha) / (t + t0)
    log_eps = mu - torch.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return (t, h_bar, log_eps, log_eps_bar, mu)


def _mass(cnt, m2):
    """Stan-style regularized diagonal inverse mass from Welford's sums:
    the sample variance shrunk toward 1e-3 so a short warmup cannot zero a
    scale."""
    var = m2 / torch.clamp(cnt - 1.0, min=1.0)
    inv_mass = (cnt / (cnt + 5.0)) * var + (5.0 / (cnt + 5.0)) * 1e-3
    return torch.where(torch.isfinite(inv_mass) & (inv_mass > 0), inv_mass,
                       1.0)


def hmc(u_and_grad: Callable[..., tuple[Any, Any]], x0,
        generator: torch.Generator | None = None, *, data: tuple = (),
        n_samples: int = 500, n_warmup: int = 500, n_leapfrog: int = 24,
        n_chains: int = 4, init_step: float = 0.1,
        target_accept: float = 0.8, chain_jitter: float = 0.5,
        energy_fn: Callable | None = None) -> HMCResult:
    """Sample exp(-U) with adaptive HMC.  ``u_and_grad(x, *data) -> (U,
    dU)`` is the negative log posterior over the packed vector and its
    gradient (tensors on x0's device); ``make_objective``'s output works:

        neg_l_and_grad, _ = make_objective(X, y, pack, log_prior=lp)
        res = hmc(neg_l_and_grad, pack.x0, torch.Generator().manual_seed(0))

    ``energy_fn(x, *data) -> U``, when given, supplies the potential of the
    MH accept statistic (and the recorded draws' potential), while
    ``u_and_grad`` keeps supplying the leapfrog forces.

    Chains start at ``x0`` plus N(0, chain_jitter^2) offsets (drawn from
    ``generator``, default ``torch.Generator(x0.device).manual_seed(0)``)
    and run one after another, each from a generator seeded by a draw of
    ``generator``.  A chain whose jittered start has a nonfinite potential
    or gradient is shrunk toward ``x0`` (offset halved, up to 30 times)
    before sampling.  Diagnostics (R-hat, ESS) are computed on the host.
    """
    x0 = torch.as_tensor(x0)
    if x0.ndim != 1:
        raise ValueError("hmc expects a flat (packed) vector x0")
    dev, dtype = x0.device, x0.dtype
    d = x0.shape[0]
    n_w1 = max(n_warmup // 2, 1)
    n_w2 = max(n_warmup - n_w1, 1)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    x_init = x0[None, :] + chain_jitter * torch.randn(
        (n_chains, d), generator=generator, device=dev, dtype=dtype)
    seeds = torch.randint(0, 2 ** 62, (n_chains,), generator=generator,
                          device=dev).tolist()
    log_eps0 = torch.as_tensor(np.log(init_step), dtype=dtype, device=dev)

    def ug(x):
        return u_and_grad(x, *data)

    efn = None if energy_fn is None else (lambda x: energy_fn(x, *data))
    chains = [_run_chain(ug, efn, x0, x_init[c],
                         torch.Generator(dev).manual_seed(seeds[c]),
                         log_eps0, n_w1, n_w2, n_samples, n_leapfrog,
                         float(target_accept))
              for c in range(n_chains)]
    samples, potential, accept_rate, step_size, inv_mass = (
        torch.stack(parts) for parts in zip(*chains))
    samples_h = samples.detach().cpu().numpy()
    return HMCResult(samples=samples, potential=potential,
                     accept_rate=accept_rate, step_size=step_size,
                     inv_mass=inv_mass, rhat=split_rhat(samples_h),
                     ess=bulk_ess(samples_h))


def _run_chain(ug, efn, x0, xc, gen, log_eps0, n_w1, n_w2, n_samples,
               n_leapfrog, target_accept):
    """One chain: the shrink-toward-x0 restart, two warmup phases and the
    sampling phase; (draws, potentials, mean accept, step, inverse mass)."""
    d, dtype, dev = xc.shape[0], xc.dtype, xc.device
    u0, g0 = ug(xc)
    # a jittered start with nonfinite potential or gradient would freeze
    # the chain (alpha = 0 forever): halve its offset from x0 until finite
    for _ in range(30):
        if bool(torch.isfinite(u0) & torch.all(torch.isfinite(g0))):
            break
        xc = x0 + 0.5 * (xc - x0)
        u0, g0 = ug(xc)
    if efn is not None:
        # the carried state potential lives at the accept precision
        u0 = efn(xc)
    state = (xc, u0, g0)

    def draws():
        return (torch.randn((d,), generator=gen, device=dev, dtype=dtype),
                torch.rand((), generator=gen, device=dev, dtype=dtype))

    # warmup phase 1: adapt the step under unit mass; Welford-accumulate the
    # position moments for the mass estimate
    unit_mass = torch.ones((d,), dtype=dtype, device=dev)
    da = _dual_avg_init(log_eps0)
    cnt = torch.zeros((), dtype=dtype, device=dev)
    mean = torch.zeros((d,), dtype=dtype, device=dev)
    m2 = torch.zeros((d,), dtype=dtype, device=dev)
    for _ in range(n_w1):
        state, alpha = _transition(ug, state, *draws(), da[2], unit_mass,
                                   n_leapfrog, efn)
        da = _dual_avg_update(da, alpha, target_accept)
        cnt = cnt + 1.0
        delta = state[0] - mean
        mean = mean + delta / cnt
        m2 = m2 + delta * (state[0] - mean)
    inv_mass = _mass(cnt, m2)

    # warmup phase 2: re-adapt the step under the new metric (dual
    # averaging restarted from the phase-1 smoothed step)
    da2 = _dual_avg_init(da[3])
    for _ in range(n_w2):
        state, alpha = _transition(ug, state, *draws(), da2[2], inv_mass,
                                   n_leapfrog, efn)
        da2 = _dual_avg_update(da2, alpha, target_accept)
    log_eps = da2[3]

    # sampling: fixed kernel, collect draws
    xs, us, alphas = [], [], []
    for _ in range(n_samples):
        state, alpha = _transition(ug, state, *draws(), log_eps, inv_mass,
                                   n_leapfrog, efn)
        xs.append(state[0])
        us.append(state[1])
        alphas.append(alpha)
    return (torch.stack(xs), torch.stack(us), torch.mean(torch.stack(alphas)),
            torch.exp(log_eps), inv_mass)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-chain potential scale reduction (Gelman et al., BDA3 eq. 11.4).
    samples: (n_chains, n_samples, d) -> (d,).  Values near 1 indicate the
    chains agree; > ~1.05 means run longer."""
    c, s, d = samples.shape
    half = s // 2
    if half < 2:
        return np.full((d,), np.nan)
    split = samples[:, : 2 * half].reshape(c * 2, half, d).astype(np.float64)
    means = split.mean(axis=1)  # (2c, d)
    w = split.var(axis=1, ddof=1).mean(axis=0)  # (d,)
    b = half * means.var(axis=0, ddof=1)  # (d,)
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / w)


def bulk_ess(samples: np.ndarray) -> np.ndarray:
    """Effective sample size via Geyer's initial monotone positive sequence
    on the chain-averaged autocorrelation (the rank-normalization refinement
    is skipped; this is the classic estimator)."""
    c, s, d = samples.shape
    if s < 4:
        return np.full((d,), np.nan)
    x = samples.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    # FFT autocovariance per chain/coordinate.
    nfft = int(2 ** np.ceil(np.log2(2 * s)))
    f = np.fft.rfft(x, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :s].real / s
    var0 = acov[:, 0].mean(axis=0)  # (d,)
    rho = acov.mean(axis=0) / np.where(var0 > 0, var0, 1.0)  # (s, d)
    ess = np.empty(d)
    for j in range(d):
        # Sum paired autocorrelations while the pairs stay positive and
        # monotonically decreasing (Geyer 1992).
        pair_sum = rho[0:-1:2, j] + rho[1::2, j]
        pos = np.minimum.accumulate(np.maximum(pair_sum, 0.0))
        k = np.argmax(pos <= 0.0) if np.any(pos <= 0.0) else pos.shape[0]
        tau = max(2.0 * np.sum(pos[:k]) - 1.0, 1.0 / s)
        # Antithetic/noise-dominated chains can push tau below 1; cap the
        # estimate at the draw count so diagnostics never report more
        # effective samples than actual ones.
        ess[j] = min(c * s / tau, float(c * s))
    return ess


def make_accept_energy(X, targets, pack, *, precision: str = "highest",
                       log_prior=None, variational: bool = False,
                       block_size: int | None = None):
    """A value-only potential ``(x, X, targets) -> U`` for :func:`hmc`'s
    ``energy_fn``: the negative log posterior of ``make_objective`` with
    its products at ``precision`` (``config.matmul_precision``, set for
    this evaluation alone), while the leapfrog forces keep the session's.
    The JAX package's form minus ``family`` (the pack's kernel class is
    it)."""
    from ..config import config
    from .train import make_objective

    energy, _ = make_objective(X, targets, pack, variational=variational,
                               block_size=block_size, log_prior=log_prior,
                               value_only=True)

    def wrapped(x, *_data):
        old = config.matmul_precision
        config.matmul_precision = precision
        try:
            return energy(x)
        finally:
            config.matmul_precision = old

    return wrapped


def sample_posterior(X, targets, pack,
                     generator: torch.Generator | None = None, *,
                     log_prior=None, variational: bool = False,
                     block_size: int | None = None,
                     accept_precision: str | None = "highest",
                     **hmc_kwargs) -> HMCResult:
    """HMC over the GP hyper posterior: builds the library objective
    (un-normalized: scaling the potential would temper the posterior) and
    samples it.  ``block_size=`` streams the evidence (on SE-iso in f32,
    through the statistics kernels), so the posterior of a dataset past the
    card's memory is samplable.

    ``accept_precision`` (default "highest") evaluates the MH accept
    statistic at that precision (:func:`make_accept_energy`) while the
    leapfrog forces stay at the session's: with TF32 forces
    (``config.matmul_precision = "high"``) an accept on the forces' own
    potential lets dual averaging shrink the step to nothing (PERF.md, PR
    16).  None uses the forces' potential.  The JAX package's signature
    minus ``family``."""
    from .train import make_objective

    neg_l_and_grad, _ = make_objective(
        X, targets, pack, variational=variational, block_size=block_size,
        log_prior=log_prior)
    energy_fn = None
    if accept_precision is not None:
        energy_fn = make_accept_energy(
            X, targets, pack, precision=accept_precision,
            log_prior=log_prior, variational=variational,
            block_size=block_size)
    return hmc(neg_l_and_grad, pack.x0, generator, energy_fn=energy_fn,
               **hmc_kwargs)


@torch.no_grad()
def predict_hmc_mixture(pack, samples, X, targets, x_test, *,
                        variational: bool = False, thin: int = 1,
                        predictive: bool = True):
    """Posterior-predictive moments mixed over hyper draws.

    For each (thinned) draw theta_s, condition the model and read the
    predictive mean/variance; the mixture is exact in its first two moments
    (law of total variance):

        mean = E_s[mu_s]
        var  = E_s[var_s + mu_s^2] - mean^2

    A host loop over draws, so test-set memory stays one draw wide at any
    sample count.  Returns (mean, var), each (n_test,).  The JAX package's
    signature minus ``family`` (the pack's kernel class is it).
    """
    from ..models.fitc import calc_model, calc_trained
    from ..models.predict import (
        co_variance_predictor,
        mean_predictor,
        predict_means,
        predict_variances,
    )

    samples = torch.as_tensor(samples)
    if samples.ndim == 3:
        samples = samples.reshape(-1, samples.shape[-1])
    samples = samples[::thin]
    sum_mu = sum_m2 = 0.0
    for xvec in samples:
        kernel, z, sigma2 = pack.unpack(xvec)
        model = calc_model(kernel, X, z, sigma2, variational=variational)
        mu = predict_means(kernel, mean_predictor(calc_trained(model,
                                                               targets)),
                           x_test)
        var = predict_variances(kernel, co_variance_predictor(model), x_test,
                                sigma2, predictive=predictive)
        sum_mu = sum_mu + mu
        sum_m2 = sum_m2 + var + mu * mu
    mean = sum_mu / samples.shape[0]
    return mean, sum_m2 / samples.shape[0] - mean * mean
