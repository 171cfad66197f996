"""The port's f64 polish and rescoring == gpr_tpu's, in f64 on the CPU.

``polish`` (dense route n <= block, streaming route, row subsample) and
``evaluate_f64`` return the JAX package's report, values and x: counts
exactly, objectives at 1e-10, polished x at 1e-8 (one f32 rounding for an
f32 pack).  The JAX side runs in its child process, the port in process.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.optim import evaluate_f64, make_pack, polish

# gpr_tpu.optim re-exports a function named like the module
jpolish = importlib.import_module("gpr_tpu.optim.polish")

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _gp(n, d=2, m=8, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X @ (np.arange(d) * 0.3 + 0.7)) + 0.2 * rng.standard_normal(n)
    return X, y, X[:m].copy()


def _packs(Z, le, dtype=F64, **kw):
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


POLISH = {  # route: (rows, subsample, block_size, the pack's dtype)
    "dense": (300, None, 8192, F64),  # n <= block: the dense engine
    "dense_f32_pack": (300, None, 8192, torch.float32),  # bench's case
    "streaming": (300, None, 128, F64),
    "subsample": (500, 200, 128, F64),  # 200 rows > block 128: streaming
}


@pytest.mark.parametrize("route", sorted(POLISH))
def test_polish_matches_jax(route):
    """The f64 polish: the JAX child's report and x.  The returned x is in
    the pack's dtype: 1e-8 for an f64 pack, one rounding for an f32 one."""
    n, sub, block, dtype = POLISH[route]
    X, y, Z = _gp(n=n)
    if dtype == torch.float32:
        X, y, Z = (a.astype(np.float32) for a in (X, y, Z))
    jpack, pack = _packs(Z, le=0.2, dtype=dtype)
    x = np.asarray(jpack.x0, np.float64) + 0.05
    kw = dict(variational=True, subsample=sub, seed=2, max_iter=12,
              epsabs=1e-5, block_size=block)
    *_, jx, jrep = jpolish.polish(JSeIso, jnp.asarray(X), jnp.asarray(y),
                                  jpack, jnp.asarray(x), **kw)
    kernel, z, s2, xf, rep = polish(torch.as_tensor(X), torch.as_tensor(y),
                                    pack, torch.as_tensor(x), **kw)
    assert (rep.n_iter, rep.n_evals, rep.n_rows, rep.converged) == (
        jrep.n_iter, jrep.n_evals, jrep.n_rows, jrep.converged)
    _close(rep.f0, jrep.f0, scale=1.0)
    _close(rep.f, jrep.f, scale=1.0)
    # gradient norms are sums of cancelling terms: held at 1e-8
    _close(rep.gnorm0, jrep.gnorm0, rtol=1e-8)
    _close(rep.gnorm, jrep.gnorm, rtol=1e-6 if rep.converged else 1e-8)
    assert rep.gnorm < rep.gnorm0 and rep.f < rep.f0
    assert xf.dtype == dtype and float(s2) > 0
    _close(xf, jx, rtol=1e-8 if dtype == F64 else 2.0 ** -23)
    assert float(kernel.log_ell) == float(xf[1])


@pytest.mark.parametrize("route", ["dense", "streaming"])
def test_evaluate_f64_matches_jax(route):
    """Candidates from a non-default layout, on a shared subsample."""
    X, y, Z = _gp(n=400)
    jpack, pack = _packs(Z, le=0.2, learn_inducing=False, fixed=("log_sf2",))
    xs = [pack.x0, pack.x0 + 0.1, pack.x0 - 0.3]
    block = 8192 if route == "dense" else 64
    kw = dict(variational=True, subsample=250, seed=4, block_size=block)
    want = jpolish.evaluate_f64(JSeIso, jnp.asarray(X), jnp.asarray(y),
                                jpack, [jnp.asarray(x.numpy()) for x in xs],
                                **kw)
    got = evaluate_f64(_t(X), _t(y), pack, xs, **kw)
    _close(got, want)
    assert len(set(got)) == 3


def test_f64_paths_refuse_a_pack_they_cannot_rebuild():
    """A vector longer than the pack it names (as an extended pack's)
    raises RuntimeError naming n_hypers, from both entries."""
    import dataclasses

    X, y, Z = _gp(n=100)
    _, pack = _packs(Z, 0.0)
    k = pack.n_hypers
    wide = dataclasses.replace(
        pack, x0=torch.cat([pack.x0, torch.zeros(2, dtype=F64)]),
        n_hypers=k + 2, unpack=lambda x: pack.unpack(x[:k]))
    with pytest.raises(RuntimeError, match="n_hypers"):
        evaluate_f64(_t(X), _t(y), wide, [wide.x0], subsample=None)
    with pytest.raises(RuntimeError, match="n_hypers"):
        polish(_t(X), _t(y), wide, wide.x0, subsample=None)


def test_polish_timeout_raises():
    X, y, Z = _gp(n=100)
    _, pack = _packs(Z, 0.0)
    with pytest.raises(RuntimeError, match="timed out"):
        polish(_t(X), _t(y), pack, pack.x0, subsample=None, epsabs=1e-12,
               max_iter=50, timeout_s=0.0)
