"""The port's SGD/SMD ascent and inducing choosers == gpr_tpu's, in f64 on
the CPU.

SGD and SMD steps, the exact Hessian-vector product (SMD's default double
backward against ``jax.jvp``, 1e-8; in float32 it stays float32) and
``train_sgd`` / ``train_smd`` (evidence at 1e-10, hypers at 1e-8).  The
inducing points lie off the data rows: where one coincides with a row,
sqdist's clamp at 0 sits on its kink, and the two frameworks' second
derivatives there differ (JAX's ``maximum`` splits the tie,
``torch.clamp`` passes it), while the first derivatives vanish alike.  The choosers: first-n equality, the random
subset's properties, and ``_lloyd`` from the start rows that JAX's key
picks, recomputed here, against JAX's k-means.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.optim import sgd_smd as jsgd
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models import (
    choose_kmeans_inputs,
    choose_n_first_inputs,
    choose_n_random_inputs,
)
from gpr_tpu_torch.models.fitc import _lloyd
from gpr_tpu_torch.optim.sgd_smd import _exact_hvp
from gpr_tpu_torch.optim import (
    sgd_create,
    sgd_step,
    smd_create,
    smd_step,
    train_sgd,
    train_smd,
)

# the packages re-export functions named like these modules
jtrain = importlib.import_module("gpr_tpu.optim.train")
ttrain = importlib.import_module("gpr_tpu_torch.optim.train")

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-10):
    got = got.detach() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _gp(n=120, d=2, m=6, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.15 * rng.standard_normal(n)
    Z = X[:m] + 0.3 * rng.standard_normal((m, d))
    return X, y, Z


def _model_kw(Z, le=0.2):
    jp = JSeIso.Params(log_ell=jnp.asarray(le), log_sf2=jnp.asarray(0.0))
    return (dict(kernel_params=jp, inducing=jnp.asarray(Z), sigma2=0.5),
            dict(kernel_params=SeIso(le, 0.0, device="cpu", dtype=F64),
                 inducing=_t(Z), sigma2=0.5))


def _setups(factorization=None):
    """(JAX, port) ``_ascent_setup`` results on one problem."""
    X, y, Z = _gp()
    jkw, tkw = _model_kw(Z)
    common = (None, True, None, (), True, factorization)
    jset = jtrain._ascent_setup(JSeIso, jnp.asarray(X), jnp.asarray(y),
                                jkw["kernel_params"], jkw["sigma2"],
                                jkw["inducing"], *common, None)
    tset = ttrain._ascent_setup(SeIso, _t(X), _t(y), tkw["kernel_params"],
                                tkw["sigma2"], tkw["inducing"], *common, None)
    return jset, tset


@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_hvp_matches_jax_jvp(factorization):
    (jpack, jgrad, jvalue, _), (pack, grad_fn, value_fn, _) = _setups(
        factorization)
    _close(grad_fn(pack.x0), jgrad(jpack.x0))
    _close(value_fn(pack.x0), jvalue(jpack.x0))
    v = np.random.default_rng(1).standard_normal(pack.n_hypers)
    jhv = jax.jvp(jgrad, (jpack.x0,), (jnp.asarray(v),))[1]
    _close(_exact_hvp(grad_fn, pack.x0, _t(v)), jhv, rtol=1e-8)
    X, y, Z = (torch.tensor(a, dtype=torch.float32) for a in _gp())
    pack32, grad32, _, _ = ttrain._ascent_setup(
        SeIso, X, y, SeIso(0.2, 0.0, device="cpu", dtype=torch.float32), 0.5,
        Z, None, True, None, (), True, factorization, None)
    hv32 = _exact_hvp(grad32, pack32.x0, pack32.x0)
    assert hv32.dtype == torch.float32
    _close(hv32, jax.jvp(jgrad, (jpack.x0,), (jpack.x0,))[1], rtol=1e-3)


def test_sgd_and_smd_steps_match_jax():
    """Three steps of each from the same start: x, gradient, rates."""
    (jpack, jgrad, _, _), (pack, grad_fn, _, _) = _setups()
    jst, st = jsgd.sgd_create(jgrad, jpack.x0, tau=50.0, eta0=2e-3), \
        sgd_create(grad_fn, pack.x0, tau=50.0, eta0=2e-3)
    for _ in range(3):
        jst, st = jsgd.sgd_step(jgrad, jst), sgd_step(grad_fn, st)
        _close(st.x, jst.x)
        _close(st.grad, jst.grad)
        assert (st.eta, st.step) == pytest.approx((jst.eta, jst.step),
                                                  rel=1e-15)
    _close(st.gradient_norm, jst.gradient_norm)
    jst, st = jsgd.smd_create(jgrad, jpack.x0), smd_create(grad_fn, pack.x0)
    for _ in range(3):
        jst, st = jsgd.smd_step(jgrad, jst), smd_step(grad_fn, st)
        for field in ("x", "grad", "eta", "nu"):
            _close(getattr(st, field), getattr(jst, field), rtol=1e-8)
    for bad in (dict(lambda_=1.5), dict(mu=-1.0), dict(eta0=0.0)):
        with pytest.raises(ValueError):
            smd_create(grad_fn, pack.x0, **bad)
    with pytest.raises(ValueError):
        sgd_create(grad_fn, pack.x0, tau=0.0)


@pytest.mark.parametrize("trainer", ["sgd", "smd"])
def test_train_ascent_matches_jax(trainer):
    """Six ascent steps: the same reported best states and final model."""
    X, y, Z = _gp()
    jkw, tkw = _model_kw(Z)
    fns = {"sgd": (jtrain.train_sgd, train_sgd),
           "smd": (jtrain.train_smd, train_smd)}[trainer]
    extra = dict(eta0=2e-3, max_iter=6, epsabs=1e-9, variational=True)
    reports = {"jax": [], "torch": []}
    want = fns[0](JSeIso, jnp.asarray(X), jnp.asarray(y),
                  report=lambda s: reports["jax"].append(np.asarray(s.x)),
                  **jkw, **extra)
    got = fns[1](SeIso, _t(X), _t(y),
                 report=lambda s: reports["torch"].append(s.x.numpy()),
                 **tkw, **extra)
    assert len(reports["torch"]) == len(reports["jax"]) >= 2
    for a, b in zip(reports["torch"], reports["jax"]):
        _close(a, b, rtol=1e-8)
    _close(got.l, want.l)
    for a, b in ((got.kernel_params.log_ell, want.kernel_params.log_ell),
                 (got.kernel_params.log_sf2, want.kernel_params.log_sf2),
                 (got.inducing, want.inducing), (got.sigma2, want.sigma2)):
        _close(a, b, rtol=1e-8)
    with pytest.raises(TypeError, match="unexpected"):
        fns[1](SeIso, _t(X), _t(y), max_iter=1, key=None)


def test_choose_first_and_random_inputs():
    X, _, _ = _gp(n=50)
    kernel = SeIso(device="cpu", dtype=F64)
    jp = JSeIso.default_params(jnp.asarray(X), 7)
    _close(choose_n_first_inputs(kernel, _t(X), 7),
           jfitc.choose_n_first_inputs(JSeIso, jp, jnp.asarray(X), 7))
    z = choose_n_random_inputs(torch.Generator().manual_seed(3), kernel,
                               _t(X), 7)
    again = choose_n_random_inputs(torch.Generator().manual_seed(3), kernel,
                                   _t(X), 7)
    assert torch.equal(z, again) and z.shape == (7, 2)
    rows = {tuple(r) for r in X.tolist()}
    assert {tuple(r) for r in z.tolist()} <= rows
    assert len({tuple(r) for r in z.tolist()}) == 7
    every = choose_n_random_inputs(torch.Generator().manual_seed(4), kernel,
                                   _t(X), 50)
    assert {tuple(r) for r in every.tolist()} == rows


@pytest.mark.parametrize("subsample", [None, 80])
def test_lloyd_matches_jax_kmeans(subsample):
    """JAX's k-means from its key; the port's Lloyd loop from the same
    start rows, which the key's draws give."""
    rng = np.random.default_rng(9)
    centers = np.array([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0]])
    X = np.concatenate([c + 0.5 * rng.standard_normal((40, 2))
                        for c in centers])
    key = jax.random.PRNGKey(5)
    jp = JSeIso.default_params(jnp.asarray(X), 5)
    want = jfitc.choose_kmeans_inputs(key, JSeIso, jp, jnp.asarray(X), 5,
                                      iters=6, subsample=subsample)
    Xs, k = jnp.asarray(X), key
    if subsample is not None:
        k, sub = jax.random.split(k)
        Xs = Xs[jax.random.choice(sub, X.shape[0], (subsample,),
                                  replace=False)]
    k_init, _ = jax.random.split(k)
    idx0 = jax.random.choice(k_init, Xs.shape[0], (5,), replace=False)
    c0 = np.asarray(Xs)[np.asarray(idx0)]
    _close(_lloyd(_t(np.asarray(Xs)), _t(c0), 6), want)


def test_kmeans_chooser_properties():
    """Finite centroids inside the data's box, on the subsample path too;
    an empty cluster keeps its centroid."""
    X, _, _ = _gp(n=300)
    kernel = SeIso(device="cpu", dtype=F64)
    for subsample in (None, 100):
        c = choose_kmeans_inputs(torch.Generator().manual_seed(2), kernel,
                                 _t(X), 8, iters=4, subsample=subsample)
        assert c.shape == (8, 2) and bool(torch.isfinite(c).all())
        assert bool((c.min(0).values >= _t(X).min(0).values).all())
    c0 = _t(np.vstack([X[:3], [[50.0, 50.0]]]))
    c = _lloyd(_t(X), c0, 3)
    assert c[3].tolist() == [50.0, 50.0]
