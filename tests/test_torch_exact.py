"""The port's exact dense GP (models/exact.py) == gpr_tpu's, in f64 on the CPU.

The same numpy draw goes through ``gpr_tpu.models.exact`` and the port: the
evidence and the LOO objective with their gradients (the kernel's hypers,
sigma2) at rtol 1e-10, for SE-iso and se_fat (whose data-side gram differs
from its inducing one); the factor, alpha, the means, variances and
covariances at new points and the LOO posterior; ``fit_exact``'s iterates
and its trained state, for either objective.  The JAX tests' identities
hold in the port: on their toy the variational FITC evidence lies below
the exact one, approaching it as m grows to n, and the closed-form LOO
equals refits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import exact as jexact
from gpr_tpu_torch.kernels import SeFat, SeIso
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import exact as texact
from gpr_tpu_torch.models import fitc as tfitc
from torch_ext import F64, close, t

SIGMA2 = 0.05


def _data(n=40, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    return X, y


def _models(name, d=2):
    """(JAX family, params, port kernel) at the same hypers."""
    if name == "se_iso":
        return (jk.SeIso, jk.SeIso.Params(log_ell=jnp.asarray(0.3),
                                          log_sf2=jnp.asarray(0.2)),
                SeIso(0.3, 0.2, device="cpu", dtype=F64))
    tproj = np.random.default_rng(5).uniform(-1, 1, (d, 2)) / d
    return (jk.SeFat, jk.SeFat.Params(d=2, log_sf2=jnp.asarray(0.2),
                                      tproj=jnp.asarray(tproj),
                                      log_hetero_skedasticity=None,
                                      log_multiscales_m05=None),
            SeFat(2, 0.2, tproj=tproj, device="cpu", dtype=F64))


@pytest.mark.parametrize("objective", ["evidence", "loo"])
@pytest.mark.parametrize("name", ["se_iso", "se_fat"])
def test_objectives_and_grads_match_jax(name, objective):
    X, y = _data()
    fam, jp, k = _models(name)
    jobj = {"evidence": jexact.log_evidence_exact,
            "loo": jexact.loo_objective_exact}[objective]
    tobj = {"evidence": texact.log_evidence_exact,
            "loo": texact.loo_objective_exact}[objective]
    jval, (jgp, jgs) = jax.value_and_grad(
        lambda p, s2: jobj(fam, p, jnp.asarray(X), jnp.asarray(y), s2),
        argnums=(0, 1))(jp, jnp.asarray(SIGMA2))
    s2 = t(SIGMA2).requires_grad_(True)
    val = tobj(k, t(X), t(y), s2)
    names, hypers = hyper_leaves(k)
    grads = torch.autograd.grad(val, (*hypers, s2))
    close(val, jval, name="value")
    for field, g in zip(names, grads):
        close(g, getattr(jgp, field), name=field)
    close(grads[-1], jgs, name="sigma2")


def test_posterior_matches_jax():
    X, y = _data(n=35)
    fam, jp, k = _models("se_iso")
    jtr = jexact.exact_trained(jexact.calc_exact(fam, jp, jnp.asarray(X),
                                                 SIGMA2), jnp.asarray(y))
    tr = texact.exact_trained(texact.calc_exact(k, t(X), SIGMA2), t(y))
    for field in ("alpha", "l"):
        close(getattr(tr, field), getattr(jtr, field), name=field)
    close(tr.model.chol_a, jtr.model.chol_a, name="chol_a")
    Xs = np.linspace(-2, 2, 9)[:, None].repeat(2, axis=1)
    jXs = jnp.asarray(Xs)
    close(texact.predict_means_exact(k, tr, t(Xs)),
          jexact.predict_means_exact(fam, jp, jtr, jXs), name="means")
    for predictive in (False, True):
        close(texact.predict_variances_exact(k, tr, t(Xs),
                                             predictive=predictive),
              jexact.predict_variances_exact(fam, jp, jtr, jXs,
                                             predictive=predictive),
              rtol=1e-9, name="variances")
        close(texact.covariances_exact(k, tr, t(Xs), predictive=predictive),
              jexact.covariances_exact(fam, jp, jtr, jXs,
                                       predictive=predictive),
              rtol=1e-9, name="covariances")
    for got, want in zip(texact.loo_posterior(tr), jexact.loo_posterior(jtr)):
        close(got, want, name="loo_posterior")
    close(texact.loo_log_likelihood(tr), jexact.loo_log_likelihood(jtr))


def test_variational_fitc_bounds_exact():
    """JAX's test identity, on its well-specified toy: the variational
    FITC evidence lies below the exact one and rises to it as m grows to n
    (Z = X).  It is not a bound in general: the reference's variational
    flavor keeps FITC's diagonal in its noise."""
    X, y = _data(n=30)
    k = SeIso(0.3, 0.2, device="cpu", dtype=F64)
    exact = float(texact.log_evidence_exact(k, t(X), t(y), SIGMA2).detach())
    bounds = [float(tfitc.log_evidence(k, t(X[:m]), SIGMA2, t(X), t(y),
                                       variational=True,
                                       jitter=1e-10).detach())
              for m in (4, 8, 16, 30)]
    assert all(b <= exact + 1e-6 for b in bounds)
    assert bounds == sorted(bounds)
    np.testing.assert_allclose(bounds[-1], exact, atol=1e-4)


def test_loo_matches_refits():
    X, y = _data(n=25)
    k = SeIso(0.3, 0.2, device="cpu", dtype=F64)
    tr = texact.exact_trained(texact.calc_exact(k, t(X), SIGMA2), t(y))
    mu, var = texact.loo_posterior(tr)
    for i in (0, 7, 24):
        keep = np.arange(25) != i
        tr_i = texact.exact_trained(texact.calc_exact(k, t(X[keep]), SIGMA2),
                                    t(y[keep]))
        close(mu[i], texact.predict_means_exact(k, tr_i, t(X[i:i + 1]))[0],
              rtol=1e-8)
        close(var[i], texact.predict_variances_exact(k, tr_i, t(X[i:i + 1]))
              [0], rtol=1e-8)


@pytest.mark.parametrize("objective", ["evidence", "loo"])
def test_fit_exact_matches_jax(objective):
    X, y = _data(n=60)
    fam, jp, k = _models("se_iso")
    jtr, jparams, js2 = jexact.fit_exact(fam, jp, jnp.asarray(X),
                                         jnp.asarray(y), 1.0,
                                         objective=objective, max_iter=8)
    tr, kernel, s2 = texact.fit_exact(k, t(X), t(y), 1.0,
                                      objective=objective, max_iter=8)
    close(s2, js2, rtol=1e-8, name="sigma2")
    for field, v in zip(*hyper_leaves(kernel)):
        close(v, getattr(jparams, field), rtol=1e-8, name=field)
    close(tr.alpha, jtr.alpha, rtol=1e-7, name="alpha")
    close(tr.l, jtr.l, rtol=1e-8, name="l")
