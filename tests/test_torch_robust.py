"""The port's Student-t robust regression (models/robust.py) == gpr_tpu's, in
f64 on the CPU.

The same numpy draw, with outliers, goes through ``gpr_tpu.models.robust``
and the port: the exact heteroskedastic posterior moments (dense and
streamed) at rtol 1e-10, the ELBO and its terms at several nu, the EM
sweeps' weights, ``t_select_nu``'s scores, ``t_predict``, and ``fit_t``'s
iterates (dense and streamed on the per-row sigma2 path) with the M-step's
evidence gradients (kernel hypers, z, sigma2).  The JAX tests' identity
holds in the port: the ELBO rises across E-steps.  ``fit_t(mesh=...)``
refuses, naming its ROADMAP.md item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import robust as jrobust
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import fitc as tfitc
from gpr_tpu_torch.models import robust as trobust
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.optim import make_pack
from torch_ext import F64, close, t
from torch_spmd import check_mesh_fit

JP = jk.SeIso.Params(log_ell=jnp.asarray(0.2), log_sf2=jnp.asarray(0.3))


def _kernel():
    return SeIso(0.2, 0.3, device="cpu", dtype=F64)


def _setup(n=41, m=6, seed=0, outliers=True):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    Z = rng.standard_normal((m, 2))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    if outliers:
        y[[3, 17, 25]] += [6.0, -7.0, 9.0]
    lam = rng.uniform(0.2, 2.0, n)
    return X, Z, y, lam


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("block_size", [None, 7])
def test_posterior_moments_match_jax(block_size):
    X, Z, y, lam = _setup()
    jmu, jvar, _ = jrobust.t_posterior_moments(
        jk.SeIso, JP, *_j(Z), 0.3, *_j(X, y, lam), block_size=block_size)
    mu, var, _ = trobust.t_posterior_moments(
        _kernel(), t(Z), 0.3, t(X), t(y), t(lam), block_size=block_size)
    close(mu, jmu, name="mu")
    close(var, jvar, name="var")


def test_em_and_elbo_match_jax_and_rise():
    """The weights after each number of sweeps, and the ELBO of each at two
    nu: equal to JAX's and rising across E-steps."""
    X, Z, y, _ = _setup()
    k, sigma2 = _kernel(), 0.2
    vals = []
    for sweeps in (1, 2, 4, 8):
        jlam, jpair = jrobust.t_em_sweeps(jk.SeIso, JP, *_j(Z), sigma2,
                                          *_j(X, y), nu=4.0, sweeps=sweeps)
        lam, pair = trobust.t_em_sweeps(k, t(Z), sigma2, t(X), t(y), nu=4.0,
                                        sweeps=sweeps)
        close(lam, jlam, name="lam")
        elbo = trobust.t_elbo(k, t(Z), sigma2, t(X), t(y), pair)
        jelbo = jrobust.t_elbo(jk.SeIso, JP, *_j(Z), sigma2, *_j(X, y),
                               jpair)
        for nu in (4.0, 10.0):
            close(elbo(nu), jelbo(nu), name=f"elbo nu={nu}")
        vals.append(float(elbo(4.0).detach()))
    assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:])), vals
    lam = lam.detach()
    assert max(lam[[3, 17, 25]]) < 0.1 < float(torch.median(lam))


def test_lambda_update_and_select_nu_match_jax():
    X, Z, y, lam = _setup(outliers=False)
    k = _kernel()
    mu, var, _ = trobust.t_posterior_moments(k, t(Z), 0.2, t(X), t(y),
                                             t(lam))
    close(trobust.t_lambda_update(t(y), mu, var, 0.2, 4.0),
          jrobust.t_lambda_update(*_j(y, mu.detach(), var.detach()), 0.2,
                                  4.0))
    grid = (3.0, 10.0)
    best, scores = trobust.t_select_nu(k, t(Z), 0.2, t(X), t(y),
                                       nu_grid=grid, sweeps=3)
    jbest, jscores = jrobust.t_select_nu(jk.SeIso, JP, *_j(Z), 0.2,
                                         *_j(X, y), nu_grid=grid, sweeps=3)
    assert best == jbest
    for nu in grid:
        close(t(scores[nu]), jscores[nu], name=f"nu={nu}")


def test_predict_matches_jax():
    X, Z, y, lam = _setup()
    Xs = np.random.default_rng(1).standard_normal((9, 2))
    got = trobust.t_predict(_kernel(), t(Z), 0.3, t(X), t(y), t(lam), t(Xs),
                            nu=4.0)
    want = jrobust.t_predict(jk.SeIso, JP, *_j(Z), 0.3, *_j(X, y, lam, Xs),
                             nu=4.0)
    for g, w, name in zip(got, want, ("mean", "latent_var", "noise_var")):
        close(g, w, name=name)


@pytest.mark.parametrize("block_size", [None, 16])
def test_fit_t_matches_jax(block_size):
    X, Z, y, _ = _setup(n=60)
    pack = make_pack(_kernel(), t(Z), 0.4)
    jpack = jmake_pack(jk.SeIso, JP, jnp.asarray(Z), 0.4)
    *_, jlam, jst = jrobust.fit_t(jk.SeIso, *_j(X, y), jpack, nu=4.0,
                                  n_em=2, m_step_iters=3,
                                  block_size=block_size)
    kernel, z, s2, lam, st = trobust.fit_t(t(X), t(y), pack, nu=4.0, n_em=2,
                                           m_step_iters=3,
                                           block_size=block_size)
    close(st.x, jst.x, rtol=1e-8, name="x")
    close(lam, jlam, rtol=1e-8, name="lam")
    assert (st.n_iter, st.n_evals) == (int(jst.n_iter), int(jst.n_evals))


@pytest.mark.parametrize("block_size", [None, 16])
def test_m_step_gradients_match_jax(block_size):
    """The M-step's objective, the evidence with noise sigma2 / lam, and its
    gradient groups (dense, or streamed on the per-row path)."""
    X, Z, y, lam = _setup()

    def jf(p, z, s2):
        noise = s2 / jnp.asarray(lam)
        if block_size is None:
            from gpr_tpu.models.fitc import log_evidence
            return log_evidence(jk.SeIso, p, z, noise, *_j(X, y))
        from gpr_tpu.models.streaming import streaming_log_evidence
        return streaming_log_evidence(jk.SeIso, p, z, noise, *_j(X, y),
                                      block_size=block_size)

    jval, (jgp, jgz, jgs) = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        JP, jnp.asarray(Z), jnp.asarray(0.3))
    k = _kernel()
    z, s2 = t(Z).requires_grad_(True), t(0.3).requires_grad_(True)
    noise = s2 / t(lam)
    val = (tfitc.log_evidence(k, z, noise, t(X), t(y)) if block_size is None
           else tst.streaming_log_evidence(k, z, noise, t(X), t(y),
                                           block_size=block_size))
    names, hypers = hyper_leaves(k)
    grads = torch.autograd.grad(val, (*hypers, z, s2))
    close(val, jval, name="value")
    for field, g in zip(names, grads):
        close(g, getattr(jgp, field), name=field)
    close(grads[-2], jgz, name="z")
    close(grads[-1], jgs, name="sigma2")


def test_fit_t_refuses_mesh():
    X, Z, y, _ = _setup()
    # mesh= runs the data-parallel fit: P = 2 matches one device
    check_mesh_fit("robust", t(X), t(y), t(Z), n_em=2, m_step_iters=2)
    with pytest.raises(ValueError, match="learn_sigma2=True"):
        trobust.fit_t(t(X), t(y), make_pack(_kernel(), t(Z), 0.4,
                                            learn_sigma2=False))
