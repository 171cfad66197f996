"""bench.py's training leg in the port == gpr_tpu's, in f64 on the CPU.

The host ``minimize_lbfgs``, ``make_objective`` (dense and streaming) and
``fit_restarts`` (plain, dense, with ``probe_subsample``, with
``rescore_f64``) walk the JAX package's iterates: the same iteration and
evaluation counts, every phase counter, the same winner, objectives at
1e-10 and x at 1e-8.  The JAX rescoring runs in a child process, the
port's in process.  The polish is tested in tests/test_torch_polish.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.optim import lbfgs as jlbfgs
from gpr_tpu.optim import lbfgs_device as jlb
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu.optim import priors as jpriors
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.optim import (
    default_n_inducing,
    default_sigma2,
    field_priors,
    fit_restarts,
    make_objective,
    make_pack,
    minimize_lbfgs,
    normal,
)

# the packages re-export functions named like these modules
jtrain = importlib.import_module("gpr_tpu.optim.train")
tpolish = importlib.import_module("gpr_tpu_torch.optim.polish")

F64 = torch.float64
LADDER = (-0.8, 0.0, 0.8)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _gp(n=512, d=2, m=8, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X @ (np.arange(d) * 0.3 + 0.7)) + 0.2 * rng.standard_normal(n)
    return X, y, X[:m].copy()


def _packs(Z, le=0.0, dtype=F64, **kw):
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    jp = JSeIso.Params(log_ell=jnp.asarray(le, jdt),
                       log_sf2=jnp.asarray(0.0, jdt))
    jpack = j_make_pack(JSeIso, jp, jnp.asarray(Z, jdt), 1.0, **kw)
    kernel, z, _ = from_jax_params({"log_ell": le, "log_sf2": 0.0}, Z, 1.0,
                                   device="cpu", dtype=dtype)
    return jpack, make_pack(kernel, z, 1.0, **kw)


def _close(got, want, rtol=1e-10, scale=1e-300):
    """rtol relative to the larger of the entries and ``scale``: a mean NLL
    near 0 is a difference of O(1) terms per row, so it takes scale 1."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), scale))


def _counted(fg):
    evals = [0]

    def f(xv):
        evals[0] += 1
        return fg(xv)

    return f, evals


def test_defaults_match_jax(rng):
    y = rng.standard_normal(37)
    assert default_sigma2(_t(y)) == pytest.approx(jtrain.default_sigma2(y),
                                                  rel=1e-14)
    for n in (3, 50, 12_345, 10**6):
        assert default_n_inducing(n) == jtrain.default_n_inducing(n)


ENGINES = {"dense": None, "streaming": 128}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("normalize", [False, True])
def test_make_objective_matches_jax(engine, normalize):
    X, y, Z = _gp(n=300)
    jpack, pack = _packs(Z, le=0.2)
    kw = dict(variational=True, normalize=normalize,
              block_size=ENGINES[engine])
    jfg, jtrained = jtrain.make_objective(JSeIso, jnp.asarray(X),
                                          jnp.asarray(y), jpack, **kw)
    fg, trained_of = make_objective(_t(X), _t(y), pack, **kw)
    x = pack.x0 + 0.05 * _t(np.random.default_rng(1).standard_normal(
        pack.n_hypers))
    jf, jg = jfg(jnp.asarray(x.numpy()))
    f, g = fg(x)
    _close(f, jf)
    _close(g, jg)
    _close(trained_of(x).coeffs, jtrained(jnp.asarray(x.numpy())).coeffs)
    value, _ = make_objective(_t(X), _t(y), pack, value_only=True, **kw)
    _close(value(x), jf)


def test_make_objective_prior_matches_jax():
    X, y, Z = _gp(n=300)
    jpack, pack = _packs(Z, le=0.2)
    jprior = jpriors.field_priors({"log_ell": jpriors.normal(0.5, 0.3)})
    tprior = field_priors({"log_ell": normal(0.5, 0.3)})
    jfg, _ = jtrain.make_objective(JSeIso, jnp.asarray(X), jnp.asarray(y),
                                   jpack, log_prior=jprior)
    fg, _ = make_objective(_t(X), _t(y), pack, log_prior=tprior)
    jf, jg = jfg(jpack.x0)
    f, g = fg(pack.x0)
    _close(f, jf)
    _close(g, jg)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_host_minimize_lbfgs_matches_jax(engine):
    """The host L-BFGS on the evidence: the same iterates and counts.  The
    inducing points stay fixed: their flat directions would let rounding
    steer x apart at the same objective."""
    X, y, Z = _gp(n=300)
    jpack, pack = _packs(Z, le=0.2, learn_inducing=False)
    kw = dict(variational=True, normalize=True, block_size=ENGINES[engine])
    jfg, _ = jtrain.make_objective(JSeIso, jnp.asarray(X), jnp.asarray(y),
                                   jpack, **kw)
    fg, _ = make_objective(_t(X), _t(y), pack, **kw)

    def j_np(xv):
        f, g = jfg(jnp.asarray(xv))
        return float(f), np.asarray(g, np.float64)

    def t_np(xv):
        f, g = fg(_t(xv))
        return float(f), g.numpy()

    j_np, jevals = _counted(j_np)
    t_np, tevals = _counted(t_np)
    lb = dict(epsabs=1e-7, max_iter=25)
    jres = jlbfgs.minimize_lbfgs(j_np, np.asarray(jpack.x0), **lb)
    res = minimize_lbfgs(t_np, pack.x0.numpy(), **lb)
    assert (res.n_iter, tevals[0], res.converged) == (
        jres.n_iter, jevals[0], jres.converged)
    assert res.n_iter >= 5
    _close(res.x, jres.x, rtol=1e-8)
    _close(res.f, jres.f)


def _ladder(Z, dtype=F64):
    xs = [_packs(Z, le=le, dtype=dtype) for le in LADDER]
    return [j.x0 for j, _ in xs], [t.x0 for _, t in xs]


def _same_restarts(got, want, rescored=False):
    *_, st, rep = got
    *_, jst, jrep = want
    _close(list(rep), list(jrep))
    assert (rep.probe_evals, rep.probe_iters, rep.cont_evals,
            rep.cont_iters) == (jrep.probe_evals, jrep.probe_iters,
                                jrep.cont_evals, jrep.cont_iters)
    assert (st.n_iter, st.n_evals, st.failed) == (
        int(jst.n_iter), int(jst.n_evals), bool(jst.failed))
    _close(st.x, jst.x, rtol=1e-8)
    _close(st.f, jst.f)
    if rescored:
        _close(rep.rescored_f64, jrep.rescored_f64)
    else:
        assert rep.rescored_f64 is None and jrep.rescored_f64 is None


RESTARTS = {
    "streaming": dict(streaming_block_size=128),
    "dense": dict(streaming_block_size=None),
    "probe_subsample": dict(streaming_block_size=128, probe_subsample=200,
                            probe_seed=3),
    "rescore_f64": dict(streaming_block_size=128, rescore_f64=300,
                        probe_seed=3),
}


@pytest.mark.parametrize("case", sorted(RESTARTS))
def test_fit_restarts_matches_jax(case):
    """A 3-start ladder, probe_iters=4, max_iter=10 on n=512, m=8: the same
    probe values, winner and counters as the JAX run."""
    X, y, Z = _gp()
    jpack, pack = _packs(Z)
    jx0s, x0s = _ladder(Z)
    kw = dict(probe_iters=4, variational=True, max_iter=10, epsabs=1e-6,
              **RESTARTS[case])
    want = jlb.fit_restarts(JSeIso, jnp.asarray(X), jnp.asarray(y), jpack,
                            jx0s, **kw)
    got = fit_restarts(_t(X), _t(y), pack, x0s, **kw)
    _same_restarts(got, want, rescored=case == "rescore_f64")
    rep = got[-1]
    assert rep.probe_iters == 4 * len(LADDER) and rep.cont_iters >= 1
    ranked = rep.rescored_f64 if case == "rescore_f64" else list(rep)
    assert ranked[rep.winner] == min(ranked)
    kernel, z, s2, st, _ = got
    rebuilt = pack.unpack(st.x)
    assert float(kernel.log_ell) == float(rebuilt[0].log_ell)
    assert torch.equal(z, rebuilt[1]) and float(s2) == float(rebuilt[2])


def test_fit_restarts_refusals():
    X, y, Z = _gp(n=64)
    _, pack = _packs(Z)
    with pytest.raises(ValueError, match="x0s is empty"):
        fit_restarts(_t(X), _t(y), pack, [], streaming_block_size=64)
    with pytest.raises(ValueError, match="rescore_f64"):
        fit_restarts(_t(X), _t(y), pack, [pack.x0], rescore_f64=32,
                     log_prior=field_priors({"log_ell": normal(0.0, 1.0)}))


def test_rescore_all_nonfinite_falls_back_to_raw_ranking(monkeypatch):
    X, y, Z = _gp(n=128)
    _, pack = _packs(Z)
    _, x0s = _ladder(Z)
    monkeypatch.setattr(tpolish, "evaluate_f64",
                        lambda *a, **k: [float("inf")] * len(x0s))
    kw = dict(probe_iters=2, max_iter=3, streaming_block_size=64)
    with pytest.warns(UserWarning, match="falling back"):
        *_, st, rep = fit_restarts(_t(X), _t(y), pack, x0s, rescore_f64=64,
                                   **kw)
    *_, st_raw, _ = fit_restarts(_t(X), _t(y), pack, x0s, **kw)
    torch.testing.assert_close(st.x, st_raw.x, rtol=0, atol=0)
    assert rep.rescored_f64 == [float("inf")] * len(x0s)
