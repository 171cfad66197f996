"""The port's dense serving == gpr_tpu's, in f64 on the CPU.

Every predict and covariance function and the nine statistics (dense and
streaming trained states) at 1e-10, ``cov_sampler``'s factor at 1e-10 and
the classification statistics.  The draws themselves come from a
``torch.Generator``, which cannot replay a JAX key: ``sample``,
``cov_sample`` and ``sample_fic_blocked`` are held to their moments
instead, each within 5 standard errors of its estimate.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.models import predict as jpredict
from gpr_tpu.models import streaming as jstreaming
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.models import (
    calc_classify_stats,
    calc_model,
    calc_trained,
    co_variance_predictor,
    cov_sample,
    cov_sampler,
    covariances_fic,
    covariances_fitc,
    mean_predictor,
    predict_means,
    predict_variances,
    sample,
    sample_fic_blocked,
    sampler,
    streaming_trained,
)
from gpr_tpu_torch.models import predict, stats

# the package re-exports functions named like these modules
jsample = importlib.import_module("gpr_tpu.models.sample")
jstats = importlib.import_module("gpr_tpu.models.stats")

F64 = torch.float64
PARAMS = {"log_ell": 0.2, "log_sf2": 0.1}
SIGMA2 = 0.3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.fixture(autouse=True)
def _serving():
    """Serving needs no gradient (the kernel's hypers are parameters)."""
    with torch.no_grad():
        yield


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _problem(n=150, d=2, m=8, t=40, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.2 * rng.standard_normal(n)
    Z = rng.standard_normal((m, d))
    Xt = 1.5 * rng.standard_normal((t, d))
    return X, y, Z, Xt


def _models(X, y, Z):
    """(JAX params, JAX trained, port kernel, port trained), dense."""
    jp = JSeIso.Params(**{k: jnp.asarray(v) for k, v in PARAMS.items()})
    jtrained = jfitc.calc_trained(
        jfitc.calc_model(JSeIso, jp, jnp.asarray(X), jnp.asarray(Z), SIGMA2),
        jnp.asarray(y))
    kernel, z, s2 = from_jax_params(PARAMS, Z, SIGMA2, device="cpu",
                                    dtype=F64)
    trained = calc_trained(calc_model(kernel, _t(X), z, s2), _t(y))
    return jp, jtrained, kernel, trained


@pytest.mark.parametrize("predictive", [True, False])
def test_predict_and_covariances_match_jax(predictive):
    X, y, Z, Xt = _problem()
    jp, jtr, kernel, tr = _models(X, y, Z)
    jXt, tXt = jnp.asarray(Xt), _t(Xt)
    jmp, mp = jpredict.mean_predictor(jtr), mean_predictor(tr)
    jcvp, cvp = jpredict.co_variance_predictor(jtr.model), \
        co_variance_predictor(tr.model)
    for field in ("z", "coeffs"):
        _close(getattr(mp, field), getattr(jmp, field))
    for field in ("z", "chol_km", "r_mat"):
        _close(getattr(cvp, field), getattr(jcvp, field))
    _close(predict_means(kernel, mp, tXt),
           jpredict.predict_means(JSeIso, jp, jmp, jXt))
    _close(predict.predict_mean_one(kernel, mp, tXt[3]),
           jpredict.predict_mean_one(JSeIso, jp, jmp, jXt[3]))
    kw = dict(predictive=predictive)
    var = predict_variances(kernel, cvp, tXt, SIGMA2, **kw)
    _close(var, jpredict.predict_variances(JSeIso, jp, jcvp, jXt, SIGMA2,
                                           **kw))
    _close(predict.predict_variance_one(kernel, cvp, tXt[3], SIGMA2, **kw),
           jpredict.predict_variance_one(JSeIso, jp, jcvp, jXt[3], SIGMA2,
                                         **kw))
    _close(predict.variances_model_inputs(tr.model, **kw),
           jpredict.variances_model_inputs(jtr.model, **kw))
    for name in ("covariances_fitc", "covariances_fic"):
        cov = getattr(predict, name)(kernel, cvp, tXt, SIGMA2, **kw)
        _close(cov, getattr(jpredict, name)(JSeIso, jp, jcvp, jXt, SIGMA2,
                                            **kw))
        _close(torch.diagonal(cov), var)
    _close(predict.covariances_fitc_model_inputs(tr.model, kernel, _t(X),
                                                 **kw),
           jpredict.covariances_fitc_model_inputs(jtr.model, JSeIso, jp,
                                                  jnp.asarray(X), **kw))
    _close(predict.covariances_fic_model_inputs(tr.model, **kw),
           jpredict.covariances_fic_model_inputs(jtr.model, **kw))


STAT_FNS = ("calc_target_variance", "calc_sse", "calc_mse", "calc_rmse",
            "calc_smse", "calc_msll", "calc_mad", "calc_maxad")


@pytest.mark.parametrize("engine", ["dense", "streaming"])
def test_stats_match_jax(engine):
    """The nine metrics of calc_stats and each calc_* alone, on a dense and
    a streaming trained state; the streaming predictors too."""
    X, y, Z, Xt = _problem()
    jp, jtr, kernel, tr = _models(X, y, Z)
    if engine == "streaming":
        jtr = jstreaming.streaming_trained(
            JSeIso, jp, jnp.asarray(Z), SIGMA2, jnp.asarray(X),
            jnp.asarray(y), block_size=64)
        tr = streaming_trained(kernel, _t(Z), SIGMA2, _t(X), _t(y),
                               block_size=64)
        jmp, mp = jpredict.mean_predictor(jtr), mean_predictor(tr)
        jcvp = jpredict.co_variance_predictor(jtr.model)
        cvp = co_variance_predictor(tr.model)
        _close(predict_means(kernel, mp, _t(Xt)),
               jpredict.predict_means(JSeIso, jp, jmp, jnp.asarray(Xt)))
        _close(predict_variances(kernel, cvp, _t(Xt), SIGMA2),
               jpredict.predict_variances(JSeIso, jp, jcvp, jnp.asarray(Xt),
                                          SIGMA2))
    got, want = stats.calc_stats(tr), jstats.calc_stats(jtr)
    assert got.n_samples == want.n_samples == stats.calc_n_samples(tr)
    for field in ("target_variance", "sse", "mse", "rmse", "smse", "msll",
                  "mad", "maxad"):
        _close(getattr(got, field), getattr(want, field))
    for name in STAT_FNS:
        _close(getattr(stats, name)(tr), getattr(jstats, name)(jtr))


def test_classify_stats_match_jax():
    rng = np.random.default_rng(2)
    y = np.where(rng.random(60) < 0.4, 1.0, -1.0)
    prob = np.round(rng.random(60), 1)  # ties, broken by sort order
    prob[:3] = (0.0, 1.0, 0.5)
    got = calc_classify_stats(_t(y), _t(prob))
    want = jstats.calc_classify_stats(jnp.asarray(y), jnp.asarray(prob))
    assert got.n_samples == want.n_samples
    for field in ("base_rate", "error_rate", "log_loss", "msll", "brier",
                  "auc"):
        _close(getattr(got, field), getattr(want, field))


def test_cov_sampler_factor_matches_jax():
    X, y, Z, Xt = _problem()
    jp, jtr, kernel, tr = _models(X, y, Z)
    cvp = co_variance_predictor(tr.model)
    jcvp = jpredict.co_variance_predictor(jtr.model)
    cov = covariances_fitc(kernel, cvp, _t(Xt), SIGMA2, predictive=False)
    jcov = jpredict.covariances_fitc(JSeIso, jp, jcvp, jnp.asarray(Xt),
                                     SIGMA2, predictive=False)
    means = predict_means(kernel, mean_predictor(tr), _t(Xt))
    for kw in (dict(sigma2=SIGMA2), dict(predictive=False, jitter=1e-4)):
        got = cov_sampler(means, cov, **kw)
        want = jsample.cov_sampler(jnp.asarray(means.numpy()), jcov, **kw)
        _close(got.cov_chol, want.cov_chol)
        _close(got.means, want.means)
    with pytest.raises(ValueError, match="sigma2"):
        cov_sampler(means, cov)
    s, js = sampler(means[:3], cov.diagonal()[:3], SIGMA2), jsample.sampler(
        jnp.asarray(means[:3].numpy()), jnp.asarray(cov.diagonal()[:3]
                                                    .numpy()), SIGMA2)
    _close(s.stddev, js.stddev)


def _within(emp, want, stderr, k=5.0):
    """|emp - want| <= k standard errors, entrywise."""
    excess = (torch.abs(emp - want) - k * stderr).max()
    assert float(excess) <= 0.0, float(excess)


def test_sample_moments():
    gen = torch.Generator().manual_seed(7)
    n = 40_000
    s = sampler(_t(1.5), _t(0.2), 0.05)
    draws = sample(gen, s, n)
    assert draws.shape == (n,) and sample(gen, s).shape == ()
    sd = float(s.stddev)
    _within(draws.mean(), _t(1.5), sd / n ** 0.5)
    _within(draws.var(), _t(sd * sd), sd * sd * (2.0 / n) ** 0.5)


def _cov_stderr(cov, n):
    """Standard error of the empirical covariance of n Gaussian draws:
    sqrt((C_ii C_jj + C_ij^2) / n)."""
    d = torch.diagonal(cov)
    return torch.sqrt((d[:, None] * d[None, :] + cov * cov) / n)


def test_cov_sample_moments():
    X, y, Z, Xt = _problem(t=6)
    _, _, kernel, tr = _models(X, y, Z)
    cvp = co_variance_predictor(tr.model)
    cov = covariances_fitc(kernel, cvp, _t(Xt), SIGMA2)
    means = predict_means(kernel, mean_predictor(tr), _t(Xt))
    cs = cov_sampler(means, cov, predictive=False)
    gen = torch.Generator().manual_seed(8)
    n = 40_000
    draws = cov_sample(gen, cs, n)
    assert draws.shape == (6, n) and cov_sample(gen, cs).shape == (6,)
    _within(draws.mean(1), means, torch.sqrt(torch.diagonal(cov) / n))
    _within(torch.cov(draws), cov, _cov_stderr(cov, n))


@pytest.mark.parametrize("predictive", [True, False])
def test_sample_fic_blocked_moments(predictive):
    """Ragged blocks (7 rows of 30): the draws' covariance is the FIC
    posterior covariance, their mean zero."""
    X, y, Z, Xt = _problem(t=30)
    _, _, kernel, tr = _models(X, y, Z)
    cvp = co_variance_predictor(tr.model)
    cov = covariances_fic(kernel, cvp, _t(Xt), SIGMA2, predictive=predictive)
    gen = torch.Generator().manual_seed(9)
    n = 20_000
    draws = sample_fic_blocked(gen, kernel, cvp, _t(Xt), SIGMA2, n,
                               predictive=predictive, block_size=7)
    assert draws.shape == (30, n)
    _within(draws.mean(1), torch.zeros(30, dtype=F64),
            torch.sqrt(torch.diagonal(cov) / n))
    _within(torch.cov(draws), cov, _cov_stderr(cov, n))
