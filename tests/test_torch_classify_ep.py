"""The port's EP classifier (models/classify_ep.py) == gpr_tpu's, in f64 on
the CPU.

The binary labels of ``torch_laplace.setup``'s draw go through
``gpr_tpu.models.classify_ep`` and the port at rtol 1e-10: the damped
sweeps' sites and their trace; the evidence and its gradients (kernel
hypers, z) for both ``grad_impl`` routes; the evidence at given sites with
masked rows (which contribute exactly nothing); ``ep_predict`` and
``ep_posterior_state`` (whose state serves ``ep_predict``'s latent moments
through the standard predictors); ``fit_classify_ep``'s iterates for 3
iterations.  The JAX references are computed once for the module.
"""

import jax.numpy as jnp
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import classify as jc
from gpr_tpu.models import classify_ep as je
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.models import classify as tc
from gpr_tpu_torch.models import classify_ep as te
from gpr_tpu_torch.models.predict import (
    CoVariancePredictor,
    MeanPredictor,
    predict_means,
    predict_variances,
)
from gpr_tpu_torch.optim import make_pack
from torch_ext import close, t
from torch_laplace import (  # noqa: F401  (one_torch_thread: autouse)
    JP,
    assert_same,
    jax_value_and_grad,
    kernel,
    one_torch_thread,
    setup,
    torch_value_and_grad,
)

D = setup()
X, Z, Y, MASK = D["X"], D["Z"], D["classify"], D["mask"]
J = jnp.asarray
SWEEPS = 40  # the sites converge to rounding at this size


@pytest.fixture(scope="module")
def jref():
    """Every JAX reference of the module, computed once."""
    out = {}
    for gi in ("stationary", "unroll"):
        out[gi] = jax_value_and_grad(lambda p, z, gi=gi: je.ep_log_evidence(
            jk.SeIso, p, z, J(X), J(Y), n_sweeps=SWEEPS, grad_impl=gi), Z)
    _, v, d = jc._fitc_prior(jk.SeIso, JP, J(Z), J(X))
    out["sweeps"] = je.ep_sweeps(v, d, J(Y), J(MASK), n_sweeps=SWEEPS,
                                 trace=True)
    out["masked"] = je.ep_log_evidence_from_sites(v, d, J(Y), J(MASK),
                                                  *out["sweeps"][:2])
    out["predict"] = je.ep_predict(jk.SeIso, JP, J(Z), J(X), J(Y),
                                   J(D["Xs"]), n_sweeps=SWEEPS)
    out["state"] = je.ep_posterior_state(jk.SeIso, JP, J(Z), J(X), J(Y),
                                         n_sweeps=SWEEPS)
    jpack = jmake_pack(jk.SeIso, JP, J(Z), 1.0, learn_sigma2=False)
    out["fit"] = je.fit_classify_ep(jk.SeIso, J(X), J(Y), jpack, max_iter=3,
                                    n_sweeps=SWEEPS)[-1]
    return out


@torch.no_grad()
def _prior():
    return tc._fitc_prior(kernel(), t(Z), t(X))


def test_sweeps_match_jax(jref):
    """Masked rows keep (0, 0) sites; the deltas shrink."""
    _, v, d = _prior()
    got = te.ep_sweeps(v, d, t(Y), t(MASK), n_sweeps=SWEEPS, trace=True)
    for name, g, w in zip(("ttau", "tnu", "deltas"), got, jref["sweeps"]):
        close(g, w, name=name)
    assert bool((got[0][MASK == 0] == 0).all())
    assert float(got[2][-1]) < 1e-8 * float(got[2][0])


def test_masked_evidence_matches_jax(jref):
    """At the masked sites, the evidence of all rows equals JAX's and the
    evidence of the live rows alone."""
    _, v, d = _prior()
    mask = t(MASK)
    ttau, tnu = te.ep_sweeps(v, d, t(Y), mask, n_sweeps=SWEEPS)
    got = te.ep_log_evidence_from_sites(v, d, t(Y), mask, ttau, tnu)
    close(got, jref["masked"], name="masked")
    live = MASK > 0
    ones = torch.ones(int(live.sum()), dtype=v.dtype)
    alone = te.ep_log_evidence_from_sites(v[live], d[live], t(Y[live]), ones,
                                          ttau[live], tnu[live])
    close(alone, jref["masked"], name="live rows alone")


@pytest.mark.parametrize("grad_impl", ["stationary", "unroll"])
def test_evidence_matches_jax(grad_impl, jref):
    got = torch_value_and_grad(lambda k, z: te.ep_log_evidence(
        k, z, t(X), t(Y), n_sweeps=SWEEPS, grad_impl=grad_impl), Z)
    assert_same(got, jref[grad_impl])


def test_predict_matches_jax(jref):
    got = te.ep_predict(kernel(), t(Z), t(X), t(Y), t(D["Xs"]),
                        n_sweeps=SWEEPS)
    for name, g, w in zip(("prob", "mu", "var"), got, jref["predict"]):
        close(g, w, name=name)
    assert bool(((got[0] > 0) & (got[0] < 1)).all())


def test_posterior_state_matches_jax(jref):
    """(coeffs, R) equal JAX's; through the standard predictors (coeffs,
    r_mat = R U) they give ``ep_predict``'s latent mean and variance."""
    k = kernel()
    inducing, coeffs, r = te.ep_posterior_state(k, t(Z), t(X), t(Y),
                                                n_sweeps=SWEEPS)
    close(coeffs, jref["state"][1], name="coeffs")
    close(r, jref["state"][2], name="r")
    xs = t(D["Xs"])
    mu = predict_means(k, MeanPredictor(z=inducing.z, coeffs=coeffs), xs)
    var = predict_variances(k, CoVariancePredictor(
        z=inducing.z, chol_km=inducing.chol_km,
        r_mat=r @ inducing.chol_km), xs, 0.0, predictive=False)
    close(mu, jref["predict"][1], name="served mu")
    close(var, jref["predict"][2], rtol=1e-9, name="served var")


def test_fit_classify_ep_matches_jax(jref):
    pack = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    _, _, st = te.fit_classify_ep(t(X), t(Y), pack, max_iter=3,
                                  n_sweeps=SWEEPS)
    jst = jref["fit"]
    close(st.x, jst.x, rtol=1e-8, name="x")
    close(st.f, jst.f, rtol=1e-8, name="f")
    assert (int(st.n_iter), int(st.n_evals)) == (int(jst.n_iter),
                                                 int(jst.n_evals))


def test_fit_classify_ep_refuses():
    with pytest.raises(ValueError, match="learn_sigma2=False"):
        te.fit_classify_ep(t(X), t(Y), make_pack(kernel(), t(Z), 1.0))
    pack = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        te.fit_classify_ep(t(X), t(Y), pack, mesh=object())
    with pytest.raises(ValueError, match="grad_impl"):
        te.ep_log_evidence(kernel(), t(Z), t(X), t(Y), grad_impl="ift")


def test_unroll_first_sweep_gradient_finite():
    """All sites start at 0, where sqrt(q)'s cotangent is infinite: the
    double where keeps the unrolled gradient finite from one sweep on."""
    _, grads = torch_value_and_grad(lambda k, z: te.ep_log_evidence(
        k, z, t(X), t(Y), n_sweeps=1, grad_impl="unroll"), Z)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
