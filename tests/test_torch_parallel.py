"""The port's data-parallel regression slice (``gpr_tpu_torch/parallel/
spmd.py``, ``sharded.py``, ``iter_sharded.py``) == gpr_tpu, on gloo CPU
ranks in f64.

One spawned world of three ranks (``torch_spmd.regression_ranks``) runs
every sharded function at P = 2 and P = 3 on 37 rows, which neither
divides, so the last rank's padding rows are masked.  Each value and every
gradient is held at rtol 1e-10 against the JAX package's single-device
function on the same draws and against the port's single-device function;
``sharded_log_evidence`` and ``sharded_log_evidence_tsqr`` also against
the JAX package's own sharded functions on a 4-device mesh.  The gradient
over the kernel's leaves, z and sigma2 must equal the single-device one
(a missing half of ``allsum``'s gradient rule shows as a factor of P);
``fit_sharded`` must end with x bit-equal on every rank and f within 1e-8
of the port's ``fit``; ``sharded_iter_solve`` must agree with the port's
``pcg`` and a dense solve within its tolerance; and a rank that raises
must make ``run_spmd`` raise, not hang.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
import gpr_tpu.parallel as jpar
from gpr_tpu.kernels.base import cross_inputs as jcross
from gpr_tpu.models import pitc as jpitc
from gpr_tpu.models import streaming as jst
from gpr_tpu.models import warped as jwarp
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.models import pitc as tpitc
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.models import warped as twarp
from gpr_tpu_torch.models.iterative import kernel_matvec, nystrom_precond, pcg
from gpr_tpu_torch.optim import fit, fit_restarts, make_pack
from gpr_tpu_torch.parallel import run_spmd
from torch_ext import close
from torch_laplace import one_torch_thread  # noqa: F401 (autouse)
import torch_spmd as ts

D = ts.regression_draws()
X, Y, Z = D["X"], D["y"], D["Z"]
S2 = D["sigma2"]
SIZES = ts.SIZES
JP = jk.SeIso.Params(log_ell=jnp.asarray(D["log_ell"]),
                     log_sf2=jnp.asarray(D["log_sf2"]))


@pytest.fixture(scope="module")
def ranks():
    """Every case's results at P = 2 and 3, from one spawned world."""
    return run_spmd(ts.regression_ranks, 3, D, platform="cpu")


def kernel():
    return ts.regression_kernel(D, "cpu")


def tpack():
    return make_pack(kernel(), ts.t(Z), S2)


def jpack():
    return jmake_pack(jk.SeIso, JP, jnp.asarray(Z), S2)


def torch_vg(fn, x0):
    x = x0.detach().clone().requires_grad_(True)
    val = fn(x)
    (g,) = torch.autograd.grad(val, x)
    return val.detach(), g


def jax_vg(fn, x0):
    val, g = jax.value_and_grad(fn)(x0)
    return float(val), np.asarray(g)


def assert_vg(got, want, rtol=1e-10, what=""):
    close(got[0], want[0], rtol, f"{what} value")
    close(got[1], want[1], rtol, f"{what} gradient")


@pytest.fixture(scope="module")
def refs():
    """Single-device references in both packages, computed once."""
    tp, jpk = tpack(), jpack()
    out = {}
    for var in (False, True):
        def t_ev(x, var=var):
            k, z, s2 = tp.unpack(x)
            return tst.streaming_log_evidence(k, z, s2, ts.t(X), ts.t(Y),
                                              variational=var, block_size=8)

        def j_ev(x, var=var):
            p, z, s2 = jpk.unpack(x)
            return jst.streaming_log_evidence(
                jk.SeIso, p, z, s2, jnp.asarray(X), jnp.asarray(Y),
                variational=var, block_size=8)

        out[f"torch/{var}"] = torch_vg(t_ev, tp.x0)
        out[f"jax/{var}"] = jax_vg(j_ev, jpk.x0)

    pw, unpack_w = twarp.make_warped_pack(
        tp, twarp.default_warp_params(2, device="cpu", dtype=ts.F64))
    jpw, junpack_w = jwarp.make_warped_pack(
        jpk, jwarp.default_warp_params(2))
    shift = np.sin(np.arange(pw.x0.shape[0])) * 0.05

    def t_w(x):
        k, z, s2, wp = unpack_w(x)
        return twarp.warped_log_evidence(k, wp, z, s2, ts.t(X), ts.t(Y),
                                         block_size=8)

    def j_w(x):
        p, z, s2, wp = junpack_w(x)
        return jwarp.warped_log_evidence(jk.SeIso, p, wp, z, s2,
                                         jnp.asarray(X), jnp.asarray(Y),
                                         block_size=8)

    out["torch/warped"] = torch_vg(t_w, pw.x0 + ts.t(shift))
    out["jax/warped"] = jax_vg(j_w, jpw.x0 + jnp.asarray(shift))

    def t_p(x):
        k, z, s2 = tp.unpack(x)
        return tpitc.pitc_log_evidence(k, z, s2, ts.t(X[:36]),
                                       ts.t(Y[:36]), block_size=6)

    def j_p(x):
        p, z, s2 = jpk.unpack(x)
        return jpitc.pitc_log_evidence(jk.SeIso, p, z, s2,
                                       jnp.asarray(X[:36]),
                                       jnp.asarray(Y[:36]), block_size=6)

    out["torch/pitc"] = torch_vg(t_p, tp.x0)
    out["jax/pitc"] = jax_vg(j_p, jpk.x0)
    return out


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's own sharded value and gradient on a 4-device
    mesh: the Gram and the TSQR evidence (variational=False)."""
    mesh = jpar.make_mesh(4)
    Xs, ys, ms = jpar.shard_batch(mesh, jnp.asarray(X), jnp.asarray(Y))
    jpk = jpack()
    out = {}
    for name, fn, kw in (("evidence", jpar.sharded_log_evidence,
                          {"block_size": 8}),
                         ("tsqr", jpar.sharded_log_evidence_tsqr, {})):
        def f(x, fn=fn, kw=kw):
            p, z, s2 = jpk.unpack(x)
            return fn(jk.SeIso, mesh, p, z, s2, Xs, ys, ms, **kw)

        val, g = jax.jit(jax.value_and_grad(f))(jpk.x0)
        out[name] = (float(val), np.asarray(g))
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("route", ["evidence", "tsqr"])
@pytest.mark.parametrize("variational", [False, True])
def test_sharded_evidence(ranks, refs, size, route, variational):
    got = ranks[size][f"{route}/{variational}"]
    assert_vg(got, refs[f"jax/{variational}"], what="vs JAX")
    assert_vg(got, refs[f"torch/{variational}"], what="vs the port")


@pytest.mark.parametrize("size", SIZES)
def test_make_sharded_objective(ranks, refs, size):
    """The training step on the whole data is the negative evidence."""
    val, g = ranks[size]["objective"]
    for side in ("jax", "torch"):
        assert_vg((-val, -g), refs[f"{side}/False"], what=f"vs {side}")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("route", ["evidence", "tsqr"])
def test_against_jax_sharded(ranks, jax_sharded, size, route):
    assert_vg(ranks[size][f"{route}/False"], jax_sharded[route])


@pytest.mark.parametrize("size", SIZES)
def test_gradient_is_not_p_times(ranks, size):
    """Over the kernel's leaves, z and sigma2: the gradient of the
    replicated evidence equals the single-device one, not P times its
    replicated part."""
    k = kernel()
    z = ts.t(Z).requires_grad_(True)
    s2 = torch.tensor(S2, dtype=ts.F64, requires_grad=True)
    val = tst.streaming_log_evidence(k, z, s2, ts.t(X), ts.t(Y),
                                     block_size=8)
    want = torch.autograd.grad(val, (k.log_ell, k.log_sf2, z, s2))
    got_val, got = ranks[size]["trap"]
    close(got_val, val)
    for name, g, w in zip(("log_ell", "log_sf2", "z", "sigma2"), got, want):
        close(g, w, 1e-10, name)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("model", ["warped", "pitc"])
def test_sharded_families(ranks, refs, size, model):
    assert_vg(ranks[size][model], refs[f"jax/{model}"], what="vs JAX")
    assert_vg(ranks[size][model], refs[f"torch/{model}"], what="vs the port")


@pytest.mark.parametrize("size", SIZES)
def test_sharded_predictors(ranks, size):
    k = kernel()
    Xs = ts.t(D["Xs"])
    means = tst.predict_means_blocked(k, ts.t(Z), ts.t(D["coeffs"]), Xs)
    jmeans = jst.predict_means_blocked(jk.SeIso, JP, jnp.asarray(Z),
                                       jnp.asarray(D["coeffs"]),
                                       jnp.asarray(D["Xs"]))
    close(ranks[size]["means"], means)
    close(ranks[size]["means"], jmeans)
    m = tst.streaming_trained(k, ts.t(Z), S2, ts.t(X), ts.t(Y),
                              block_size=8).model
    var = tst.predict_variances_blocked(k, m.inducing.z, m.inducing.chol_km,
                                        m.r_mat, Xs, S2)
    close(ranks[size]["variances"], var)


@pytest.mark.parametrize("size", SIZES)
def test_fit_sharded_lock_step(ranks, size):
    x, f, n_iter, n_evals, equal = ranks[size]["fit"]
    assert equal, "x differs between ranks"
    *_, st = fit(ts.t(X), ts.t(Y), tpack(), streaming_block_size=8,
                 max_iter=3, epsabs=0.0)
    assert (n_iter, n_evals) == (st.n_iter, st.n_evals)
    close(f, st.f, 1e-8, "f")
    close(x, st.x, 1e-8, "x")


@pytest.mark.parametrize("size", SIZES)
def test_fit_restarts_sharded(ranks, size):
    tp = tpack()
    x0s = [tp.x0, tp.x0 + 0.1, tp.x0 - 0.05]
    *_, st, rep = fit_restarts(ts.t(X), ts.t(Y), tp, x0s, probe_iters=2,
                               max_iter=4, streaming_block_size=8,
                               epsabs=0.0)
    x, f, probes, winner, p_it, p_ev, c_it, c_ev = ranks[size]["restarts"]
    close(torch.tensor(probes, dtype=ts.F64), list(rep), 1e-8, "probes")
    assert (winner, p_it, p_ev, c_it, c_ev) == (
        rep.winner, rep.probe_iters, rep.probe_evals, rep.cont_iters,
        rep.cont_evals)
    close(f, st.f, 1e-8, "f")
    close(x, st.x, 1e-8, "x")


@pytest.mark.parametrize("size", SIZES)
def test_sharded_iter_solve(ranks, size):
    x, iters, relres = ranks[size]["iter"]
    assert iters > 0 and float(relres.max()) <= 1e-11
    k, Xt, B = kernel(), ts.t(X), ts.t(D["B"])
    want, _ = pcg(lambda v: kernel_matvec(k, Xt, v, S2, block_size=8), B,
                  precond=nystrom_precond(k, Xt, S2, Xt[:6]), tol=1e-11,
                  max_iter=100)
    close(x, want, 1e-8, "vs the port's pcg")
    kx = jcross(jk.SeIso, JP, jnp.asarray(X), jnp.asarray(X))
    dense = jnp.linalg.solve(kx + S2 * jnp.eye(X.shape[0]),
                             jnp.asarray(D["B"]))
    close(x, dense, 1e-8, "vs JAX's dense solve")


def test_a_failing_rank_does_not_hang():
    """Rank 1 raises while rank 0 waits in an all-reduce: run_spmd
    re-raises rank 1's exception well inside the group timeout."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 fails on purpose"):
        run_spmd(ts.raising_rank, 2, 1, platform="cpu", timeout=20.0)
    assert time.monotonic() - t0 < 60.0
