"""The port's 2-D (data x model) mesh (``gpr_tpu_torch/parallel/mesh2d.py``
over ``spmd.make_mesh_2d``) == gpr_tpu, on gloo CPU ranks in f64.

One spawned world of four ranks (``torch_spmd.mesh2d_ranks``) runs the 2x2
mesh and, through sub-meshes, 1x2 and 2x1, on 37 rows (which D = 2 does
not divide: the last data member's padding rows are masked).  Every mode
of ``sharded_log_evidence_2d`` (the replicated epilogue, the distributed
epilogue, the fully distributed inducing state with the raw and the
whitened factorization), variational on and off, gives the JAX package's
single-device ``streaming_log_evidence`` value at rtol 1e-10 and its
gradient over the packed hypers (kernel leaves, z, sigma2) at rtol 1e-7 /
atol 1e-10 (the JAX package's own tolerances); so do m = 13 at M = 2
under ``inducing="distributed"`` (identity padding) and se_fat with every
option on.  One JAX ``sharded_log_evidence_2d`` value (2x2, replicated,
on the run's virtual devices) is held too; its distributed modes compile
for half a minute each in JAX and are held against the single-device
reference only.  The f32 modes (whitened-direct, its distributed
epilogue, the whitened factorization) agree with the port's f64 within
5e-5 relative (gradients at ``test_f32_paths.py``'s bound).
``fully_distributed_predict`` gives JAX's dense means and variances at
1e-10; ``fit_sharded_2d`` ends with x bit-equal on the four
ranks and f within 1e-8 of the port's ``fit``; ``fit_restarts_sharded``
on 2x2 follows the port's ``fit_restarts``; the gradient over the kernel's
leaves is not D, M or D M times too large; m % M != 0 is refused with
JAX's message; and nothing falls back (a mesh larger than the world, no
card, a rank that raises).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import calc_model, calc_trained
from gpr_tpu.models import streaming as jst
from gpr_tpu.models.predict import (
    co_variance_predictor,
    mean_predictor,
    predict_means,
    predict_variances,
)
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu.parallel import mesh2d as jmesh2d
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.optim import fit, fit_restarts, make_pack
from gpr_tpu_torch.parallel import run_spmd
from torch_ext import close
from torch_laplace import one_torch_thread  # noqa: F401 (autouse)
import torch_spmd as ts

D = ts.mesh2d_draws()
X, Y = D["X"], D["y"]
S2 = D["sigma2"]
JP = jk.SeIso.Params(log_ell=jnp.asarray(D["log_ell"]),
                     log_sf2=jnp.asarray(D["log_sf2"]))


def _fat():
    """JAX se_fat defaults (every option on) at 8 inducing rows."""
    Xf = jnp.asarray(D["X_fat"])
    p = jk.SeFat.default_params(Xf, 8, key=jax.random.PRNGKey(3))
    z = jk.SeFat.inducing_from_inputs(p, Xf[:8])
    params = {"d": p.d, "log_sf2": np.asarray(p.log_sf2),
              "tproj": np.asarray(p.tproj),
              "log_hetero_skedasticity": np.asarray(
                  p.log_hetero_skedasticity),
              "log_multiscales_m05": np.asarray(p.log_multiscales_m05)}
    return p, z, {"params": params, "Z": np.asarray(z)}


FAT_P, FAT_Z, FAT = _fat()


@pytest.fixture(scope="module")
def ranks():
    """Every case's results on each mesh shape, from one spawned world."""
    return run_spmd(ts.mesh2d_ranks, 4, D, FAT, platform="cpu")


def jax_vg(family, p, Z, s2, X_, variational):
    """JAX's single-device streaming evidence and its packed gradient."""
    pk = jmake_pack(family, p, jnp.asarray(Z), s2)

    def f(x):
        pp, z, s = pk.unpack(x)
        return jst.streaming_log_evidence(family, pp, z, s, jnp.asarray(X_),
                                          jnp.asarray(Y),
                                          variational=variational,
                                          block_size=8)

    val, g = jax.value_and_grad(f)(pk.x0)
    return float(val), np.asarray(g)


@pytest.fixture(scope="module")
def refs():
    """The JAX package's single-device references, computed once."""
    out = {f"ev/{var}": jax_vg(jk.SeIso, JP, D["Z"], S2, X, var)
           for var in (False, True)}
    out["m13"] = jax_vg(jk.SeIso, JP, D["Z13"], S2, X, False)
    out["se_fat"] = jax_vg(jk.SeFat, FAT_P, FAT_Z, 0.5, D["X_fat"], True)
    for m in (8, 13):
        Z = jnp.asarray(D["Z"] if m == 8 else D["Z13"])
        model = calc_model(jk.SeIso, JP, jnp.asarray(X), Z, S2,
                           factorization="chol")
        trained = calc_trained(model, jnp.asarray(Y))
        Xs = jnp.asarray(D["Xs"])
        out[f"predict/{m}"] = (
            np.asarray(predict_means(jk.SeIso, JP, mean_predictor(trained),
                                     Xs)),
            np.asarray(predict_variances(jk.SeIso, JP,
                                         co_variance_predictor(model), Xs,
                                         S2, predictive=True)))
    return out


@pytest.fixture(scope="module")
def jax_2d():
    """The JAX package's own 2-D value on a 2x2 mesh (replicated modes)."""
    mesh = jmesh2d.make_mesh_2d(2, 2)
    Xp, yp, mask = (np.concatenate([X, np.zeros((1, X.shape[1]))]),
                    np.concatenate([Y, [0.0]]),
                    np.concatenate([np.ones(X.shape[0]), [0.0]]))
    return float(jmesh2d.sharded_log_evidence_2d(
        jk.SeIso, mesh, JP, jnp.asarray(D["Z"]), S2, jnp.asarray(Xp),
        jnp.asarray(yp), jnp.asarray(mask), block_size=8))


def assert_vg(got, want, what=""):
    close(got[0], want[0], 1e-10, f"{what} value")
    want_g = np.asarray(want[1])
    np.testing.assert_allclose(got[1].numpy(), want_g, rtol=1e-7,
                               atol=1e-10, err_msg=f"{what} gradient")


@pytest.mark.parametrize("mode", sorted(ts.MODES_2D))
@pytest.mark.parametrize("variational", [False, True])
def test_modes_2x2(ranks, refs, mode, variational):
    assert_vg(ranks[(2, 2)][f"ev/{mode}/{variational}"],
              refs[f"ev/{variational}"], mode)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("mode", sorted(ts.MODES_2D))
def test_modes_sub_meshes(ranks, refs, shape, mode):
    assert_vg(ranks[shape][f"ev/{mode}/False"], refs["ev/False"], mode)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
@pytest.mark.parametrize("mode", ["inducing-raw", "inducing-whitened"])
def test_inducing_padding(ranks, refs, shape, mode):
    """m = 13 at M = 2: identity padding changes neither value nor
    gradient."""
    assert_vg(ranks[shape][f"m13/{mode}"], refs["m13"], mode)


@pytest.mark.parametrize("mode", ["replicated", "inducing-raw"])
def test_se_fat(ranks, refs, mode):
    assert_vg(ranks[(2, 2)][f"se_fat/{mode}"], refs["se_fat"], mode)


def test_against_jax_2d(ranks, jax_2d):
    close(ranks[(2, 2)]["ev/replicated/False"][0], jax_2d, 1e-10)


@pytest.mark.parametrize("mode", ts.F32_MODES_2D)
def test_f32_modes(ranks, mode):
    """f32 (whitened-direct Gram, or the whitened factorization) against
    the port's f64: the value within 5e-5 relative, the JAX package's f32
    bound (``test_f32_paths.py:176-180``)."""
    val, g = ranks[(2, 2)][f"f32/{mode}"]
    assert val.dtype == torch.float32
    want_v, want_g = ranks[(2, 2)]["ev/replicated/True"]
    close(val, want_v, 5e-5, "value")
    # the gradient at test_f32_paths.py's bound (f32 raises the jitter to
    # 1e-5 of K(Z, Z)'s diagonal, f64 keeps 1e-6)
    np.testing.assert_allclose(g.double().numpy(), want_g.numpy(),
                               rtol=1e-2,
                               atol=5e-3 * float(want_g.abs().max()))


def test_gradient_is_not_mesh_times(ranks):
    """Over the kernel's leaves, z and sigma2 the 2x2 gradient equals the
    single-device one: a missing half of the gradient rule would make it
    2, 2 or 4 times its replicated part."""
    k = ts.regression_kernel(D, "cpu")
    z = ts.t(D["Z"]).requires_grad_(True)
    s2 = torch.tensor(S2, dtype=ts.F64, requires_grad=True)
    val = tst.streaming_log_evidence(k, z, s2, ts.t(X), ts.t(Y),
                                     block_size=8)
    want = torch.autograd.grad(val, (k.log_ell, k.log_sf2, z, s2))
    got_val, got = ranks[(2, 2)]["trap"]
    close(got_val, val)
    for name, g, w in zip(("log_ell", "log_sf2", "z", "sigma2"), got, want):
        close(g, w, 1e-10, name)


def test_refuses_indivisible_m(ranks):
    assert ranks[(2, 2)]["refusal"] == (
        "m (7) must be divisible by the model axis (2) for the "
        "replicated-inducing modes (inducing='distributed' pads "
        "automatically)")


@pytest.mark.parametrize("case", [((2, 2), 8), ((2, 2), 13), ((1, 2), 13)])
def test_fully_distributed_predict(ranks, refs, case):
    shape, m = case
    mu, var = ranks[shape][f"predict/{m}"]
    want_mu, want_var = refs[f"predict/{m}"]
    close(mu, want_mu, 1e-10, "means")
    close(var, want_var, 1e-10, "variances")


def test_no_fallback(ranks, monkeypatch):
    """A mesh larger than the world raises JAX's error; without a card and
    without GPR_TPU_PLATFORM=cpu, run_spmd raises rather than run on the
    CPU; a rank that raises makes the 2-D call raise, not hang."""
    assert ranks["too_big"] == "mesh 3x2 needs 6 devices, have 4"
    monkeypatch.delenv("GPR_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spmd(ts.raising_rank_2d, 4, 3, D)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 3 fails on purpose"):
        run_spmd(ts.raising_rank_2d, 4, 3, D, platform="cpu", timeout=20.0)
    assert time.monotonic() - t0 < 60.0


def tpack():
    return make_pack(ts.regression_kernel(D, "cpu"), ts.t(D["Z"]), S2)


def test_fit_sharded_2d(ranks):
    x, f, n_iter, n_evals, equal = ranks[(2, 2)]["fit"]
    assert equal, "x differs between the ranks"
    *_, st = fit(ts.t(X), ts.t(Y), tpack(), streaming_block_size=8,
                 max_iter=3, epsabs=0.0)
    assert (n_iter, n_evals) == (st.n_iter, st.n_evals)
    close(f, st.f, 1e-8, "f")
    close(x, st.x, 1e-8, "x")


def test_fit_restarts_sharded_2d(ranks):
    tp = tpack()
    x0s = [tp.x0, tp.x0 + 0.1, tp.x0 - 0.05]
    *_, st, rep = fit_restarts(ts.t(X), ts.t(Y), tp, x0s, probe_iters=2,
                               max_iter=4, streaming_block_size=8,
                               epsabs=0.0)
    x, f, probes, winner, p_it, p_ev, c_it, c_ev, equal = \
        ranks[(2, 2)]["restarts"]
    assert equal, "x differs between the ranks"
    close(torch.tensor(probes, dtype=ts.F64), list(rep), 1e-8, "probes")
    assert (winner, p_it, p_ev, c_it, c_ev) == (
        rep.winner, rep.probe_iters, rep.probe_evals, rep.cont_iters,
        rep.cont_evals)
    close(f, st.f, 1e-8, "f")
    close(x, st.x, 1e-8, "x")
