"""The port's host trainer and checkpoints == gpr_tpu's, in f64 on the CPU.

``train`` (dense and streaming) evaluates the same x sequence as the JAX
run (the same evaluation count, every x within 1e-8), reports the same
gradient norms and trained states, and lands on the same hypers (1e-8) and
evidence (1e-10); a Bailout or KeyboardInterrupt keeps the best model;
``resume`` reproduces the uninterrupted run, and a checkpoint written by
either package resumes in the other.  The inducing rows are given to both
packages: a JAX key cannot be replayed by a torch generator.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu import datasets as jdatasets
from gpr_tpu.io import resume as jresume
from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.optim import lbfgs_device as jlb
from gpr_tpu_torch import datasets
from gpr_tpu_torch.io import resume
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models import StreamingTrained, TrainedState
from gpr_tpu_torch.optim import (
    Bailout,
    default_n_inducing,
    default_sigma2,
    fit,
    make_pack,
    train,
)

# the packages re-export functions named like these modules
jtrain = importlib.import_module("gpr_tpu.optim.train")
ttrain = importlib.import_module("gpr_tpu_torch.optim.train")

F64 = torch.float64
ENGINES = {"dense": None, "streaming": 64}
LOG_ELL0 = -0.3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _data(n=200, m=6):
    X, y, _ = jdatasets.gen_data(3, n=n)
    return X, y, X[::n // m][:m].copy()


def _args(X, y, Z):
    """(JAX args, port args) of one train call: family, X, y and the start
    hypers and inducing rows."""
    jp = JSeIso.Params(log_ell=jnp.asarray(LOG_ELL0),
                       log_sf2=jnp.asarray(0.0))
    kernel = SeIso(LOG_ELL0, 0.0, device="cpu", dtype=F64)
    return ((JSeIso, jnp.asarray(X), jnp.asarray(y),
             dict(kernel_params=jp, inducing=jnp.asarray(Z))),
            (SeIso, _t(X), _t(y), dict(kernel_params=kernel,
                                       inducing=_t(Z))))


def _recording(module, monkeypatch):
    """Record every x that ``module.train``'s objective evaluates."""
    xs = []
    make = module.make_objective

    def make_recorded(*a, **kw):
        fg, trained_of = make(*a, **kw)

        def fg_recorded(x):
            xs.append(np.array(x, dtype=np.float64))
            return fg(x)

        return fg_recorded, trained_of

    monkeypatch.setattr(module, "make_objective", make_recorded)
    return xs


def _hypers(result):
    k = result.kernel_params
    return np.concatenate([
        np.atleast_1d(np.asarray(k.log_ell, np.float64)),
        np.atleast_1d(np.asarray(k.log_sf2, np.float64)),
        np.asarray(result.inducing, np.float64).ravel(),
        np.atleast_1d(np.asarray(result.sigma2, np.float64)),
    ])


def _same_result(got, want):
    """Evidence at 1e-10, hypers at 1e-8."""
    _close(got.l, want.l)
    _close(_hypers(got), _hypers(want), rtol=1e-8)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_train_matches_jax(engine, monkeypatch):
    """The default sigma2, 12 iterations: the same evaluated x sequence,
    gradient norms, reported trained states and final model."""
    X, y, Z = _data()
    (jf, jX, jy, jkw), (tf, tX, ty, tkw) = _args(X, y, Z)
    kw = dict(variational=True, max_iter=12, epsabs=1e-6,
              block_size=ENGINES[engine])
    jxs = _recording(jtrain, monkeypatch)
    txs = _recording(ttrain, monkeypatch)
    reports = {"jax": [], "torch": []}

    def reporters(side):
        def norm(iter, norm):
            reports[side].append((iter, "norm", norm))

        def trained(iter, trained):
            reports[side].append((iter, "l", float(trained.l)))

        return dict(report_gradient_norm=norm, report_trained_model=trained)

    want = jtrain.train(jf, jX, jy, **jkw, **kw, **reporters("jax"))
    got = train(tf, tX, ty, **tkw, **kw, **reporters("torch"))
    assert len(txs) == len(jxs) and len(jxs) >= 13
    for tx, jx in zip(txs, jxs):
        _close(tx, jx, rtol=1e-8)
    assert [r[:2] for r in reports["torch"]] == [r[:2] for r in
                                                 reports["jax"]]
    _close([r[2] for r in reports["torch"]], [r[2] for r in reports["jax"]],
           rtol=1e-8)
    _same_result(got, want)
    assert float(got.sigma2) != default_sigma2(ty)  # it was trained
    trained_type = TrainedState if engine == "dense" else StreamingTrained
    assert isinstance(got.trained, trained_type)
    assert got.model is got.trained.model and got.l is got.trained.l


@pytest.mark.parametrize("stop", [Bailout, KeyboardInterrupt],
                         ids=["Bailout", "KeyboardInterrupt"])
def test_interrupt_keeps_best_model(stop):
    """A callback that raises Bailout or KeyboardInterrupt at iteration 4
    returns the best model so far: the JAX run's stopped by its Bailout
    (a KeyboardInterrupt is not raised through JAX's frames: its garbage
    collector hook may report it as unraisable); any other exception
    propagates."""
    X, y, Z = _data()
    (jf, jX, jy, jkw), (tf, tX, ty, tkw) = _args(X, y, Z)

    def stopper(e):
        def norm(iter, norm):
            if iter >= 4:
                raise e
        return norm

    kw = dict(variational=True, max_iter=12, epsabs=1e-6)
    want = jtrain.train(jf, jX, jy,
                        report_gradient_norm=stopper(jtrain.Bailout), **jkw,
                        **kw)
    got = train(tf, tX, ty, report_gradient_norm=stopper(stop), **tkw, **kw)
    _same_result(got, want)
    start = train(tf, tX, ty, max_iter=0, **tkw)
    assert float(got.l) > float(start.l)
    with pytest.raises(ZeroDivisionError):
        train(tf, tX, ty, report_gradient_norm=stopper(ZeroDivisionError()),
              **tkw, **kw)


def test_defaults_and_refusals():
    """sigma2 defaults to the second moment, n_inducing to min(n/10,
    1000) distinct rows of X, the hypers to zero; bad sizes raise, and a
    NaN objective at the start raises."""
    X, y, _ = _data(n=60)
    tX, ty = _t(X), _t(y)
    gen = torch.Generator().manual_seed(5)
    kernel, sigma2, z = ttrain._prepare(SeIso, tX, ty, None, None, None,
                                        None, gen)
    _, jsigma2, jz = jtrain._prepare(JSeIso, jnp.asarray(X), jnp.asarray(y),
                                     None, None, None, None,
                                     jnp.asarray([0, 1], jnp.uint32))
    assert sigma2 == pytest.approx(float(jsigma2), rel=1e-14)
    assert tuple(z.shape) == tuple(jz.shape) == (default_n_inducing(60), 1)
    assert len(set(z.ravel().tolist())) == z.shape[0]
    assert set(z.ravel().tolist()) <= set(X.ravel().tolist())
    assert kernel.log_ell.item() == kernel.log_sf2.item() == 0.0
    assert kernel.log_ell.dtype == F64 and kernel.log_ell.device == tX.device
    result = train(SeIso, tX, ty, max_iter=2, generator=gen)
    assert tuple(result.inducing.shape) == (6, 1)
    assert result.kernel_params.log_ell.dtype == F64
    for bad in (dict(n_rand_inducing=61), dict(n_rand_inducing=0),
                dict(sigma2=-1.0)):
        with pytest.raises(ValueError):
            train(SeIso, tX, ty, max_iter=1, **bad)
    with pytest.raises(FloatingPointError, match="nan"):
        train(SeIso, tX, ty * float("nan"), max_iter=1, generator=gen)


def _bail_at(n):
    def norm(iter, norm):
        if iter >= n:
            raise Bailout
    return norm


def _jbail_at(n):
    def norm(iter, norm):
        if iter >= n:
            raise jtrain.Bailout
    return norm


RESUME_KW = dict(variational=True, max_iter=12, epsabs=1e-6)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_resume_reproduces_uninterrupted_run(engine, tmp_path):
    X, y, Z = _data()
    _, (tf, tX, ty, tkw) = _args(X, y, Z)
    kw = dict(RESUME_KW, block_size=ENGINES[engine], **tkw)
    full = train(tf, tX, ty, **kw)
    ckpt = str(tmp_path / "train.npz")
    partial = train(tf, tX, ty, checkpoint_path=ckpt,
                    report_gradient_norm=_bail_at(5), **kw)
    assert float(partial.l) < float(full.l)
    resumed = train(tf, tX, ty, checkpoint_path=ckpt, resume=True, **kw)
    np.testing.assert_array_equal(_hypers(resumed), _hypers(full))
    assert float(resumed.l) == float(full.l)


def test_resume_refuses_a_mismatched_setup(tmp_path):
    X, y, Z = _data()
    _, (tf, tX, ty, tkw) = _args(X, y, Z)
    ckpt = str(tmp_path / "train.npz")
    train(tf, tX, ty, checkpoint_path=ckpt, max_iter=3, **tkw)
    with pytest.raises(ValueError, match="same model/data setup"):
        train(tf, tX, ty, checkpoint_path=ckpt, resume=True,
              learn_sigma2=False, **tkw)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        train(tf, tX, ty, resume=True, **tkw)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    """Interrupted at iteration 5 in one package, resumed in the other: the
    uninterrupted run's final hypers within 1e-8."""
    X, y, Z = _data()
    (jf, jX, jy, jkw), (tf, tX, ty, tkw) = _args(X, y, Z)
    ckpt = str(tmp_path / "train.npz")
    want = jtrain.train(jf, jX, jy, **jkw, **RESUME_KW)
    if writer == "jax":
        jtrain.train(jf, jX, jy, checkpoint_path=ckpt,
                     report_gradient_norm=_jbail_at(5), **jkw, **RESUME_KW)
    else:
        train(tf, tX, ty, checkpoint_path=ckpt,
              report_gradient_norm=_bail_at(5), **tkw, **RESUME_KW)
    with np.load(ckpt) as z:
        # the Bailout came at the 4th step, before its checkpoint
        assert int(z["n_iter"]) == 3 and z["s_hist"].shape[0] == 3
    if writer == "jax":
        got = train(tf, tX, ty, checkpoint_path=ckpt, resume=True, **tkw,
                    **RESUME_KW)
    else:
        got = jtrain.train(jf, jX, jy, checkpoint_path=ckpt, resume=True,
                           **jkw, **RESUME_KW)
    _same_result(got, want)


def test_device_checkpoint_round_trip(tmp_path):
    """``fit``'s state through save/load_device_checkpoint and
    resume_minimize: 5 + 7 iterations == 12; the arrays have the JAX
    package's keys and dtypes, and a JAX state's arrays load."""
    X, y, Z = _data()
    pack = make_pack(SeIso(LOG_ELL0, 0.0, device="cpu", dtype=F64), _t(Z),
                     1.0)
    kw = dict(epsabs=1e-8, variational=True)
    *_, whole = fit(_t(X), _t(y), pack, max_iter=12, **kw)
    *_, half = fit(_t(X), _t(y), pack, max_iter=5, **kw)
    path = str(tmp_path / "device.npz")
    resume.save_device_checkpoint(path, half)
    restored = resume.load_device_checkpoint(path, device="cpu")
    torch.testing.assert_close(restored.s_hist, half.s_hist, rtol=0, atol=0)
    assert (restored.head, restored.n_iter, restored.n_evals) == (
        half.head, half.n_iter, half.n_evals)
    fg = ttrain.make_objective(_t(X), _t(y), pack, variational=True,
                               normalize=True, factorization="chol")[0]
    rest = resume.resume_minimize(fg, restored, max_iter=12, epsabs=1e-8)
    assert rest.n_iter == whole.n_iter == 12
    torch.testing.assert_close(rest.x, whole.x, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="history"):
        resume.resume_minimize(fg, restored, history=5)

    jst = jlb._fresh_state(jnp.asarray(half.x.numpy()), jnp.asarray(1.0),
                           jnp.asarray(half.g.numpy()), 10)
    jarrays = jresume.training_state_arrays(jst)
    arrays = resume.training_state_arrays(half)
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        assert arrays[k].dtype == jarrays[k].dtype, k
    back = resume.training_state_from_arrays(jarrays, device="cpu")
    torch.testing.assert_close(back.x, half.x, rtol=0, atol=0)
    assert (back.head, back.n_iter, back.failed) == (0, 0, False)


def test_trained_artifact_serves_in_jax(tmp_path):
    """A streaming ``train`` result through ``artifact_from_trained`` and
    ``save_model`` loads in the JAX package and predicts the port's
    means."""
    from gpr_tpu.io import load_model as j_load_model
    from gpr_tpu.models import predict as jpredict
    from gpr_tpu_torch.io import artifact_from_trained, save_model
    from gpr_tpu_torch.models import mean_predictor, predict_means

    X, y, Z = _data()
    _, (tf, tX, ty, tkw) = _args(X, y, Z)
    result = train(tf, tX, ty, max_iter=3, block_size=64, **tkw)
    path = str(tmp_path / "model.npz")
    save_model(path, artifact_from_trained(SeIso, result.trained,
                                           kernel_params=result.kernel_params,
                                           target_mean=0.25))
    art, _ = j_load_model(path)
    assert art.target_mean == 0.25 and art.sigma2 == float(result.sigma2)
    _close(art.r_mat, result.model.r_mat)
    Xq = np.linspace(-4.0, 4.0, 9)[:, None]
    jmeans = jpredict.predict_means(
        art.family, art.kernel_params,
        jpredict.MeanPredictor(z=jnp.asarray(art.inducing),
                               coeffs=jnp.asarray(art.coeffs)),
        jnp.asarray(Xq))
    with torch.no_grad():
        means = predict_means(result.kernel_params,
                              mean_predictor(result.trained), _t(Xq))
    _close(means, jmeans)


def test_gen_data_matches_jax():
    for seed, n in ((0, 1000), (3, 17)):
        for a, b in zip(datasets.gen_data(seed, n=n),
                        jdatasets.gen_data(seed, n=n)):
            np.testing.assert_array_equal(a, b)
    x = np.array([-2.0, 0.0, 1e-300, 4.5])
    np.testing.assert_array_equal(datasets.gen_data_fn(x),
                                  jdatasets.gen_data_fn(x))
