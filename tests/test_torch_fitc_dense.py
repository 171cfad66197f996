"""The port's dense FITC engine and its linear algebra == gpr_tpu's, in f64.

``calc_model`` / ``calc_trained`` / ``log_evidence`` against
``gpr_tpu.models.fitc`` at n = 200, m = 12, d = 3: the value and the
gradients over (log_ell, log_sf2, Z, sigma2) at rtol 1e-10, for both
factorizations and with the variational correction on and off; and the
dense value against the port's streaming value on the same data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.numerics import linalg as jla
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models import fitc
from gpr_tpu_torch.models.streaming import streaming_log_evidence
from gpr_tpu_torch.numerics import linalg as tla

F64 = torch.float64
LOG_ELL, LOG_SF2, SIGMA2 = 0.3, 0.2, 0.25


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _data(rng, n=200, d=3, m=12):
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    Z = rng.standard_normal((m, d))
    return X, y, Z


def _upper(rng, m=7):
    a = rng.standard_normal((m, m))
    return np.triu(a) + m * np.eye(m)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("lower", [False, True])
def test_solve_tri_right_matches_jax(rng, trans, lower):
    tri = _upper(rng)
    tri = tri.T if lower else tri
    b = rng.standard_normal((5, 7))
    want = jla.solve_tri_right(jnp.asarray(b), jnp.asarray(tri), trans=trans,
                               lower=lower)
    _close(tla.solve_tri_right(_t(b), _t(tri), trans=trans, lower=lower),
           want, rtol=1e-12)


def test_ichol_syrk_qr_match_jax(rng):
    u = _upper(rng)
    _close(tla.ichol(_t(u)), jla.ichol(jnp.asarray(u)), rtol=1e-12)
    a = rng.standard_normal((20, 6))
    _close(tla.syrk(_t(a)), jla.syrk(jnp.asarray(a)), rtol=1e-12)
    r = tla.qr_r_positive(_t(a))
    assert bool((torch.diagonal(r) > 0).all())
    _close(r, jla.qr_r_positive(jnp.asarray(a)), rtol=1e-12)
    _close(r.T @ r, a.T @ a, rtol=1e-12)


def _jax_value_and_grads(X, y, Z, variational, factorization):
    def f(le, ls, z, s2):
        p = JSeIso.Params(log_ell=le, log_sf2=ls)
        return jfitc.log_evidence(JSeIso, p, z, s2, jnp.asarray(X),
                                  jnp.asarray(y), variational=variational,
                                  factorization=factorization)

    args = (jnp.asarray(LOG_ELL), jnp.asarray(LOG_SF2), jnp.asarray(Z),
            jnp.asarray(SIGMA2))
    return jax.value_and_grad(f, argnums=(0, 1, 2, 3))(*args)


def _torch_leaves(Z):
    kernel = SeIso(LOG_ELL, LOG_SF2, device="cpu", dtype=F64)
    z = _t(Z).requires_grad_(True)
    s2 = _t(SIGMA2).requires_grad_(True)
    return kernel, z, s2


@pytest.mark.parametrize("factorization", ["qr", "chol"])
@pytest.mark.parametrize("variational", [False, True])
def test_log_evidence_and_grads_match_jax(rng, factorization, variational):
    X, y, Z = _data(rng)
    want, jgrads = _jax_value_and_grads(X, y, Z, variational, factorization)
    kernel, z, s2 = _torch_leaves(Z)
    l = fitc.log_evidence(kernel, z, s2, _t(X), _t(y),
                          variational=variational,
                          factorization=factorization)
    l.backward()
    _close(l, want)
    for got, w in zip((kernel.log_ell.grad, kernel.log_sf2.grad, z.grad,
                       s2.grad), jgrads):
        _close(got, w)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_model_and_trained_state_match_jax(rng, factorization):
    """Every field of ModelState / TrainedState, calc_means and
    update_sigma2."""
    X, y, Z = _data(rng)
    p = JSeIso.Params(log_ell=jnp.asarray(LOG_ELL),
                      log_sf2=jnp.asarray(LOG_SF2))
    jm = jfitc.calc_model(JSeIso, p, jnp.asarray(X), jnp.asarray(Z),
                          jnp.asarray(SIGMA2), variational=True,
                          factorization=factorization)
    jt = jfitc.calc_trained(jm, jnp.asarray(y))
    kernel = SeIso(LOG_ELL, LOG_SF2, device="cpu", dtype=F64)
    with torch.no_grad():
        m = fitc.calc_model(kernel, _t(X), _t(Z), _t(SIGMA2),
                            variational=True, factorization=factorization)
        t = fitc.calc_trained(m, _t(y))
        for name in ("kn_diag", "knm", "v", "r", "is_", "sqrt_is", "r_mat",
                     "l1", "sigma2"):
            _close(getattr(m, name), getattr(jm, name))
        for name in ("coeffs", "l2", "l"):
            _close(getattr(t, name), getattr(jt, name))
        _close(fitc.calc_means(t), jfitc.calc_means(jt))
        for got, want in zip(fitc.co_variance_coeffs(m),
                             jfitc.co_variance_coeffs(jm)):
            _close(got, want)
        m2 = fitc.update_sigma2(m, _t(0.5), factorization=factorization)
        jm2 = jfitc.update_sigma2(jm, jnp.asarray(0.5),
                                  factorization=factorization)
        _close(m2.l1, jm2.l1)
        _close(m2.r_mat, jm2.r_mat)


def test_auto_factorization_picks_qr_for_small_problems():
    assert fitc._resolve_factorization(None, 200, 12) == "qr"
    assert fitc._resolve_factorization(None, 1 << 20, 300) == "chol"
    assert fitc._resolve_factorization("chol", 200, 12) == "chol"
    with pytest.raises(ValueError, match="factorization"):
        fitc._resolve_factorization("lu", 200, 12)


@pytest.mark.parametrize("variational", [False, True])
def test_dense_value_equals_streaming_value(rng, variational):
    """n <= block: one streaming tile and the dense engine are the same
    math, to rounding."""
    X, y, Z = _data(rng)
    kernel, z, s2 = _torch_leaves(Z)
    with torch.no_grad():
        dense = fitc.log_evidence(kernel, z, s2, _t(X), _t(y),
                                  variational=variational,
                                  factorization="chol")
        stream = streaming_log_evidence(kernel, z, s2, _t(X), _t(y),
                                        variational=variational,
                                        block_size=256)
    _close(dense, float(stream))


def test_se_iso_defaults_to_the_card():
    """The port's entry points run on the card unless asked for the CPU: a
    kernel built without a device goes there, and with no GPU that raises
    rather than falling back."""
    import inspect

    assert inspect.signature(SeIso).parameters["device"].default == "cuda"
    assert SeIso(0.1, device="meta").log_ell.device.type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            SeIso(0.1)
