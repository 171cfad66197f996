"""The port's hyper packing and L-BFGS == gpr_tpu's, in f64 on the CPU.

``make_pack`` gives the JAX vector and its gradient; ``minimize_lbfgs_device``
and ``fit`` walk the JAX iterates: the same iteration and evaluation counts
and final x within 1e-8 relative.  Each objective is written with the same
operations in both frameworks, so the two runs differ only by rounding
(1e-13 class for the streaming evidence): a line-search branch that a
rounding flips would show as a count mismatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models.streaming import streaming_log_evidence as j_evidence
from gpr_tpu.optim import lbfgs_device as jlb
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu.optim import priors as jpriors
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.models.streaming import streaming_log_evidence
from gpr_tpu_torch.optim import (
    field_priors,
    fit,
    make_pack,
    minimize_lbfgs_device,
    normal,
    soft_box,
)

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _gp(rng, n=200, d=2, m=6):
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    return X, y, X[:m].copy()


def _packs(Z, le=0.0, **kw):
    jp = JSeIso.Params(log_ell=jnp.asarray(le), log_sf2=jnp.asarray(0.0))
    jpack = j_make_pack(JSeIso, jp, jnp.asarray(Z), 1.0, **kw)
    kernel, z, _ = from_jax_params({"log_ell": le, "log_sf2": 0.0}, Z, 1.0,
                                   device="cpu", dtype=F64)
    return jpack, make_pack(kernel, z, 1.0, **kw)


PACK_OPTIONS = [{}, {"learn_sigma2": False}, {"fixed": ("log_sf2",)},
                {"learn_inducing": False}]


@pytest.mark.parametrize("kw", PACK_OPTIONS, ids=str)
def test_pack_layout_and_gradient_match_jax(rng, kw):
    X, y, Z = _gp(rng)
    jpack, pack = _packs(Z, le=0.3, **kw)
    np.testing.assert_array_equal(pack.x0.numpy(), np.asarray(jpack.x0))
    assert pack.n_hypers == jpack.n_hypers
    assert (pack.learn_sigma2, pack.learn_inducing, pack.fixed) == (
        jpack.learn_sigma2, jpack.learn_inducing, jpack.fixed)

    x = pack.x0 + 0.01 * _t(rng.standard_normal(pack.n_hypers))
    kernel, z, s2 = pack.unpack(x)
    jparams, jz, js2 = jpack.unpack(jnp.asarray(x.numpy()))
    for got, want in ((kernel.log_ell, jparams.log_ell),
                      (kernel.log_sf2, jparams.log_sf2), (z, jz), (s2, js2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def jf(xv):
        p, zz, s = jpack.unpack(xv)
        return j_evidence(JSeIso, p, zz, s, jnp.asarray(X), jnp.asarray(y),
                          block_size=64)

    jg = jax.grad(jf)(jnp.asarray(x.numpy()))
    x.requires_grad_(True)
    streaming_log_evidence(*pack.unpack(x), _t(X), _t(y),
                           block_size=64).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jg)).max())


def test_pack_rejects_unknown_field(rng):
    _, _, Z = _gp(rng)
    kernel, z, _ = from_jax_params({"log_ell": 0.0, "log_sf2": 0.0}, Z, 1.0,
                                   device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="log_sigma"):
        make_pack(kernel, z, 1.0, fixed=("log_sigma",))


def _rosenbrock(lib):
    def fg(x):
        r = x[1] - x[0] * x[0]
        f = 100.0 * r * r + (1.0 - x[0]) * (1.0 - x[0])
        g = lib.stack([-400.0 * x[0] * r - 2.0 * (1.0 - x[0]), 200.0 * r])
        return f, g

    return fg


def _quadratic(lib, a, b):
    # the minimum A^-1 b is away from 0, so "1e-8 relative" is a real bound
    def fg(x):
        ax = a @ x
        return 0.5 * lib.dot(x, ax) - lib.dot(b, x), ax - b

    return fg


def _same_run(st, jst):
    assert st.n_iter == int(jst.n_iter)
    assert st.n_evals == int(jst.n_evals)
    assert st.failed == bool(jst.failed)
    want = np.asarray(jst.x)
    np.testing.assert_allclose(st.x.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("problem", ["rosenbrock", "quadratic"])
def test_minimize_matches_jax_iterates(problem):
    if problem == "rosenbrock":
        fgs = _rosenbrock(torch), _rosenbrock(jnp)
        x0, kw = [-1.2, 1.0], dict(epsabs=1e-7, max_iter=200)
    else:
        m = np.random.default_rng(0).standard_normal((6, 6))
        a, b = m @ m.T + 0.1 * np.eye(6), np.arange(1.0, 7.0)
        fgs = (_quadratic(torch, _t(a), _t(b)),
               _quadratic(jnp, jnp.asarray(a), jnp.asarray(b)))
        x0, kw = [1.0] * 6, dict(epsabs=1e-9, max_iter=100)
    jst = jlb.minimize_lbfgs_device(fgs[1], jnp.asarray(x0), **kw)
    st = minimize_lbfgs_device(fgs[0], _t(x0), **kw)
    _same_run(st, jst)
    assert st.n_iter > 5 and st.n_evals >= st.n_iter


def test_minimize_chunks_walk_one_trajectory():
    """init_state + dispatch_iters resume the whole curvature history."""
    a = _t([1.0, 4.0, 25.0, 100.0])
    b = _t([1.0, -2.0, 0.5, 3.0])

    def fg(x):
        return 0.5 * torch.dot(x, a * x) - torch.dot(b, x), a * x - b

    x0 = _t([2.0, -1.0, 1.5, -0.5])
    full = minimize_lbfgs_device(fg, x0, epsabs=1e-10, max_iter=40)
    st = minimize_lbfgs_device(fg, x0, epsabs=1e-10, max_iter=40,
                               dispatch_iters=7)
    while (st.n_iter < 40 and not st.failed
           and float(torch.linalg.norm(st.g)) >= 1e-10):
        st = minimize_lbfgs_device(fg, x0, epsabs=1e-10, max_iter=40,
                                   dispatch_iters=7, init_state=st)
    assert st.n_iter == full.n_iter and st.n_evals == full.n_evals
    torch.testing.assert_close(st.x, full.x, rtol=0, atol=0)


def test_line_search_survives_nan_region():
    """f is NaN for x <= 0: the search must shrink and still converge."""

    def fg(x):
        if float(x[0]) <= 0:
            return torch.tensor(float("nan"), dtype=F64), x * float("nan")
        lx = torch.log(x[0])
        return lx * lx, (2 * lx / x[0])[None]

    st = minimize_lbfgs_device(fg, _t([4.0]), epsabs=1e-6, max_iter=60,
                               max_ls_evals=25)
    np.testing.assert_allclose(st.x.numpy(), [1.0], atol=1e-4)


PRIORS = {
    "none": (None, None),
    "field_priors": (
        jpriors.field_priors({"log_ell": jpriors.normal(0.5, 0.3)},
                             sigma2_prior=jpriors.soft_box(0.01, 0.5)),
        field_priors({"log_ell": normal(0.5, 0.3)},
                     sigma2_prior=soft_box(0.01, 0.5)),
    ),
}


@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_fit_matches_jax_iterates(rng, prior):
    """fit on a small streaming GP (variational, chunked, with and without
    a prior): the JAX run's counts and final x."""
    X, y, Z = _gp(rng)
    jpack, pack = _packs(Z)
    jprior, tprior = PRIORS[prior]
    kw = dict(variational=True, streaming_block_size=64, epsabs=1e-3,
              max_iter=25, dispatch_iters=10)
    *_, jst = jlb.fit(JSeIso, jnp.asarray(X), jnp.asarray(y), jpack,
                      log_prior=jprior, **kw)
    calls = []
    kernel, z, s2, st = fit(_t(X), _t(y), pack, log_prior=tprior,
                            state_callback=calls.append, **kw)
    _same_run(st, jst)
    assert len(calls) >= 2  # more than one chunk ran
    assert float(st.f) < float(calls[0].f) or st.n_iter <= 10
    rebuilt = pack.unpack(st.x)
    assert float(kernel.log_ell) == float(rebuilt[0].log_ell)
    assert torch.equal(z, rebuilt[1]) and float(s2) == float(rebuilt[2])


def test_fit_refuses_unported_objectives(rng):
    """objective="loo" (models/loo.py) needs the dense engine: with
    streaming_block_size it is refused, as in the JAX package.  Without
    it the dense engine trains on either objective, and an unknown
    objective is an error."""
    X, y, Z = _gp(rng, n=50)
    _, pack = _packs(Z)
    with pytest.raises(ValueError, match="loo"):
        fit(_t(X), _t(y), pack, streaming_block_size=64, objective="loo")
    with pytest.raises(ValueError, match="unknown objective"):
        fit(_t(X), _t(y), pack, objective="nll")
    for objective in ("evidence", "loo"):
        *_, st = fit(_t(X), _t(y), pack, max_iter=3, objective=objective)
        assert st.n_iter == 3 and bool(torch.isfinite(st.f))


def test_fit_resumes_from_state(rng):
    """init_state continues a run: 6 + 6 iterations == 12 in one go."""
    X, y, Z = _gp(rng)
    _, pack = _packs(Z)
    kw = dict(streaming_block_size=64, epsabs=1e-8)
    *_, whole = fit(_t(X), _t(y), pack, max_iter=12, **kw)
    *_, half = fit(_t(X), _t(y), pack, max_iter=6, **kw)
    *_, rest = fit(_t(X), _t(y), pack, max_iter=12, init_state=half, **kw)
    assert rest.n_iter == whole.n_iter == 12
    torch.testing.assert_close(rest.x, whole.x, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="history"):
        fit(_t(X), _t(y), pack, max_iter=12, init_state=half, history=5,
            **kw)

