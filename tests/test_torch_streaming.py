"""The streaming serving slice of gpr_tpu_torch == gpr_tpu, end to end.

Evidence, coefficients, de-whitened R, training means and blocked
predictions through both packages in f64 on the CPU (the port's plain loop,
the JAX custom-VJP scan) at rtol 1e-10; weights carried across by
``gpr_tpu_torch.convert`` and by npz artifacts in both directions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.io import checkpoint as jckpt
from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models import streaming as jst
from gpr_tpu_torch.convert import from_jax_params, params_from_artifact
from gpr_tpu_torch.io import checkpoint as tckpt
from gpr_tpu_torch.models import streaming as tst

F64 = torch.float64
RTOL = 1e-10


def _problem(rng, n=300, d=3, m=8):
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.3 * rng.standard_normal(n)
    Z = rng.standard_normal((m, d))
    Xs = rng.standard_normal((50, d))
    jp = JSeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.1))
    return X, y, Z, Xs, jp, 0.4


def _np_params(jp):
    return {f.name: np.asarray(getattr(jp, f.name))
            for f in dataclasses.fields(jp)}


def _port(jp, Z, sigma2):
    return from_jax_params(_np_params(jp), Z, sigma2, device="cpu", dtype=F64)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("variational", [False, True])
@pytest.mark.parametrize("block_size", [64, 128])
def test_log_evidence(rng, variational, block_size):
    X, y, Z, _, jp, s2 = _problem(rng)
    want = jst.streaming_log_evidence(
        JSeIso, jp, jnp.asarray(Z), s2, jnp.asarray(X), jnp.asarray(y),
        variational=variational, block_size=block_size,
    )
    kernel, z, sigma2 = _port(jp, Z, s2)
    got = tst.streaming_log_evidence(kernel, z, sigma2, _t(X), _t(y),
                                     variational=variational,
                                     block_size=block_size)
    assert got.dtype == F64
    _close(got, want)


def test_log_evidence_gradients(rng):
    """The plain loop is differentiable by autograd, and its gradients are
    the JAX package's."""
    X, y, Z, _, jp, s2 = _problem(rng, n=200)

    def jobj(p, z, s):
        return jst.streaming_log_evidence(JSeIso, p, z, s, jnp.asarray(X),
                                          jnp.asarray(y), block_size=64)

    jg = jax.grad(jobj, argnums=(0, 1, 2))(jp, jnp.asarray(Z),
                                            jnp.asarray(s2))
    kernel, z, sigma2 = _port(jp, Z, s2)
    z.requires_grad_(True)
    sigma2.requires_grad_(True)
    tst.streaming_log_evidence(kernel, z, sigma2, _t(X), _t(y),
                               block_size=64).backward()
    _close(kernel.log_ell.grad, jg[0].log_ell)
    _close(kernel.log_sf2.grad, jg[0].log_sf2)
    _close(z.grad, jg[1])
    _close(sigma2.grad, jg[2])


@pytest.mark.parametrize("variational", [False, True])
@pytest.mark.parametrize("block_size", [64, 128])
def test_trained_and_predictions(rng, variational, block_size):
    X, y, Z, Xs, jp, s2 = _problem(rng)
    jX, jy, jz = jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z)
    jtr = jst.streaming_trained(JSeIso, jp, jz, s2, jX, jy,
                                variational=variational,
                                block_size=block_size)
    kernel, z, sigma2 = _port(jp, Z, s2)
    tr = tst.streaming_trained(kernel, z, sigma2, _t(X), _t(y),
                               variational=variational,
                               block_size=block_size)
    _close(tr.l, jtr.l)
    _close(tr.model.l1, jtr.model.l1)
    _close(tr.coeffs, jtr.coeffs)
    _close(tr.model.r_mat, jtr.model.r_mat)
    _close(tr.means, jtr.means)
    assert not tr.means.requires_grad  # a serving function: no graph

    _, r_mat, coeffs = tst.streaming_coeffs(kernel, z, sigma2, _t(X), _t(y),
                                            block_size=block_size)
    _, jr, jc = jst.streaming_coeffs(JSeIso, jp, jz, s2, jX, jy,
                                     block_size=block_size)
    _close(coeffs, jc)
    _close(r_mat, jr)

    _close(tst.predict_means_blocked(kernel, z, coeffs, _t(Xs),
                                     block_size=16),
           jst.predict_means_blocked(JSeIso, jp, jz, jc, jnp.asarray(Xs),
                                     block_size=16))
    chol = tr.model.inducing.chol_km
    for predictive in (False, True):
        _close(
            tst.predict_variances_blocked(kernel, z, chol, r_mat, _t(Xs),
                                          sigma2, predictive=predictive,
                                          block_size=16),
            jst.predict_variances_blocked(
                JSeIso, jp, jz, jtr.model.inducing.chol_km, jr,
                jnp.asarray(Xs), s2, predictive=predictive, block_size=16),
        )


def test_from_jax_params_round_trip(rng):
    _, _, Z, _, jp, s2 = _problem(rng)
    kernel, z, sigma2 = _port(jp, Z, s2)
    assert z.dtype == sigma2.dtype == kernel.log_ell.dtype == F64
    back = JSeIso.Params(
        log_ell=jnp.asarray(kernel.log_ell.item()),
        log_sf2=jnp.asarray(kernel.log_sf2.item()),
    )
    assert _np_params(back) == pytest.approx(_np_params(jp), rel=0, abs=0)
    np.testing.assert_array_equal(z.numpy(), Z)
    assert float(sigma2) == s2
    k32, z32, _ = from_jax_params(_np_params(jp), Z, s2, device="cpu",
                                  dtype=torch.float32)
    assert k32.log_ell.dtype == z32.dtype == torch.float32
    with pytest.raises(ValueError, match="se_iso"):
        from_jax_params({"log_ell": 0.0}, Z, s2, device="cpu", dtype=F64)


def _jax_artifact(rng):
    X, y, Z, Xs, jp, s2 = _problem(rng)
    jtr = jst.streaming_trained(JSeIso, jp, jnp.asarray(Z), s2,
                                jnp.asarray(X), jnp.asarray(y), block_size=64)
    art = jckpt.artifact_from_trained(JSeIso, jtr, kernel_params=jp,
                                      target_mean=0.25)
    return art, Xs


def _predict_port(art, Xs):
    kernel, z, sigma2 = params_from_artifact(art, device="cpu", dtype=F64)
    means = tst.predict_means_blocked(kernel, z, _t(art.coeffs), _t(Xs),
                                      block_size=16)
    var = tst.predict_variances_blocked(kernel, z, _t(art.chol_km),
                                        _t(art.r_mat), _t(Xs), sigma2,
                                        block_size=16)
    return means, var


def _predict_jax(art, Xs):
    args = (art.family, art.kernel_params, jnp.asarray(art.inducing))
    means = jst.predict_means_blocked(*args, jnp.asarray(art.coeffs),
                                      jnp.asarray(Xs), block_size=16)
    var = jst.predict_variances_blocked(
        *args, jnp.asarray(art.chol_km), jnp.asarray(art.r_mat),
        jnp.asarray(Xs), art.sigma2, block_size=16)
    return means, var


def test_checkpoint_jax_to_port(rng, tmp_path):
    art, Xs = _jax_artifact(rng)
    path = str(tmp_path / "m.npz")
    jckpt.save_model(path, art, extra_arrays={"note": np.arange(3)})
    tart, extra = tckpt.load_model(path)
    assert tart.family_name == "se_iso" and tart.target_mean == 0.25
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    for got, want in zip(_predict_port(tart, Xs), _predict_jax(art, Xs)):
        _close(got, want)


def test_checkpoint_port_to_jax(rng, tmp_path):
    art, Xs = _jax_artifact(rng)
    tart = tckpt.ModelArtifact(
        family_name="se_iso", kernel_params=_np_params(art.kernel_params),
        inducing=art.inducing, coeffs=art.coeffs, chol_km=art.chol_km,
        r_mat=art.r_mat, sigma2=art.sigma2, target_mean=art.target_mean,
        input_means=art.input_means, input_stddevs=art.input_stddevs,
    )
    path = str(tmp_path / "m.npz")
    tckpt.save_model(path, tart)
    jart, _ = jckpt.load_model(path)
    for got, want in zip(_predict_port(tart, Xs), _predict_jax(jart, Xs)):
        _close(got, want)
    bad = dataclasses.replace(tart, family_name="se_ard")
    with pytest.raises(NotImplementedError, match="se_ard"):
        tckpt.save_model(str(tmp_path / "bad.npz"), bad)
