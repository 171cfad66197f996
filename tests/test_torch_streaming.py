"""The streaming serving slice of gpr_tpu_torch == gpr_tpu, end to end.

Evidence, coefficients, de-whitened R, training means and blocked
predictions through both packages in f64 on the CPU (the port's plain loop,
the JAX custom-VJP scan) at rtol 1e-10; weights carried across by
``gpr_tpu_torch.convert`` and by npz artifacts in both directions; and the
default route's choice between the CUDA kernels and the plain loop, from
the kernels' geometry on a made-up device.
"""

import dataclasses
from types import SimpleNamespace

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
from gpr_tpu_torch.kernels import SeIso
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
    bad = dataclasses.replace(tart, family_name="sum(se_iso,bogus)")
    with pytest.raises(KeyError, match="unknown kernel family 'bogus'"):
        tckpt.save_model(str(tmp_path / "bad.npz"), bad)


# -- the default route (ops.fused_stats.default_route): kernel #1, and #3
# when a gradient will be taken, wherever they fit the device; a made-up
# H100-like property object
H100 = SimpleNamespace(multi_processor_count=132, L2_cache_size=50 * 2 ** 20,
                       shared_memory_per_block_optin=232_448)
#: the last m at which the shared memory of the backward kernel (with a
#: gradient) and of the forward kernel (without) fits an H100, by d: the
#: wide routes' 8-row tiles
LAST_M = {8: (2_880, 5_983), 20: (2_872, 5_975), 27: (2_872, 5_967),
          64: (2_856, 5_935)}


@pytest.mark.parametrize("d", sorted(LAST_M))
def test_default_route_domain(d):
    """f32 takes the kernels exactly where the forward geometry fits and,
    with a gradient, the backward's too: m = 400 and 1,000 at every d; f64
    never; a device with less shared memory gets a smaller domain."""
    from gpr_tpu_torch.ops import fused_stats as tops

    for m in range(1, 6_401):
        fwd = tops._geometry(1, m, d, 132).smem_bytes <= 232_448
        bwd = tops._bwd_geometry(1, m, d, 132).smem_bytes <= 232_448
        for grad, fits, last in ((True, fwd and bwd, LAST_M[d][0]),
                                 (False, fwd, LAST_M[d][1])):
            want = "fused_acc" if fits else "reference"
            assert tops.default_route(m, d, torch.float32, H100,
                                      grad=grad) == want, m
            assert fits == (m <= last), (m, grad)
        if m % 97 == 0:
            assert tops.default_route(m, d, F64, H100) == "reference"
    small = SimpleNamespace(**{**vars(H100),
                               "shared_memory_per_block_optin": 101_376})
    routes = [tops.default_route(m, d, torch.float32, small)
              for m in range(1, 601)]
    assert 0 < routes.count("fused_acc") < LAST_M[d][0]


class _FakeCuda(SimpleNamespace):
    """Stands in for an (n, d) CUDA tensor where only its metadata is
    read."""

    is_cuda = True
    device = "cuda:0"


@pytest.mark.parametrize("block_size", [1_000, 8_192], ids=["1000", "8192"])
def test_resolve_impl_default_route(monkeypatch, block_size):
    """With impl=None an SE-iso model on f32 CUDA tensors with a scalar
    sigma2 takes the kernels where default_route does, whatever the block
    (the kernels do not read it, and it is no input of the route): past
    the backward kernel's domain only without a gradient; every other
    case, and an explicit grad_impl='ad', takes the plain loop, and an
    explicit kernel impl is returned as asked."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda _: H100)
    kernel = SeIso(0.0, 0.0, device="cpu", dtype=F64)
    X = _FakeCuda(shape=(block_size + 7, 8), dtype=torch.float32)
    for m, want, serve in ((300, "fused_acc", "fused_acc"),
                           (337, "fused_acc", "fused_acc"),
                           (1_000, "fused_acc", "fused_acc"),
                           (4_000, "reference", "fused_acc"),
                           (7_000, "reference", "reference")):
        z = torch.zeros(m, 8)
        assert tst._resolve_impl(None, X, kernel, z=z) == want, m
        assert tst._resolve_impl(None, X, kernel, z=z, grad=False) == serve
        assert tst._resolve_impl(None, X, kernel, "ad", z=z) == "reference"
        assert tst._resolve_impl(None, X, kernel, z=z,
                                 per_row=True) == "reference"
        assert tst._resolve_impl("fused_acc", X, kernel, z=z) == "fused_acc"
    z = torch.zeros(300, 8)
    X64 = _FakeCuda(shape=(block_size, 8), dtype=F64)
    assert tst._resolve_impl(None, X64, kernel, z=z) == "reference"
    from gpr_tpu_torch.kernels import Matern52

    assert tst._resolve_impl(None, X, Matern52(device="cpu"),
                             z=z) == "reference"
    with pytest.raises(ValueError, match="per-row sigma2"):
        tst._resolve_impl("fused_acc", X, kernel, z=z, per_row=True)


def test_stream_stats_asks_for_the_backward_only_with_a_gradient(
        rng, monkeypatch):
    """stream_stats tells the route whether a gradient will be taken: under
    grad mode when the kernel's hypers, z, sigma2, X or y require one, and
    never under no_grad (the serving functions), so that serving needs only
    the forward kernel to fit."""
    asked = []
    resolve = tst._resolve_impl

    def spy(*args, **kw):
        asked.append(kw["grad"])
        return resolve(*args, **kw)

    monkeypatch.setattr(tst, "_resolve_impl", spy)
    X, y, Z = (torch.as_tensor(rng.standard_normal(s))
               for s in ((64, 3), (64,), (5, 3)))

    def stats(grad_of=(), hypers=True):
        kernel = SeIso(0.1, -0.2, device="cpu", dtype=F64)
        kernel.requires_grad_(hypers)
        z = Z.clone().requires_grad_("z" in grad_of)
        s2 = torch.tensor(0.3, dtype=F64, requires_grad="s2" in grad_of)
        inducing = tst.calc_inducing(kernel, z, None)
        return tst.stream_stats(kernel, inducing, s2, X, y, block_size=16)

    stats()
    with torch.no_grad():
        stats(("z", "s2"))
    stats(hypers=False)
    stats(("s2",), hypers=False)
    stats(("z",), hypers=False)
    assert asked == [True, False, False, True, True]
