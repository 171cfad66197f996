"""gpr_tpu_torch numerics, SE-iso kernel and inducing state == gpr_tpu.

Same inputs (numpy, from a seed) through both packages in f64; the math is
the same in the same order class, so the bar is rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.config import config as jconfig
from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.kernels.base import sqdist as j_sqdist
from gpr_tpu.models.fitc import calc_inducing as j_calc_inducing
from gpr_tpu.numerics import linalg as jla
from gpr_tpu_torch.config import config as tconfig
from gpr_tpu_torch.kernels import SeIso, resolve_family, sqdist
from gpr_tpu_torch.models.fitc import calc_inducing
from gpr_tpu_torch.numerics import linalg as tla

F64 = torch.float64
RTOL = 1e-12


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def _spd(rng, m, scale=1.0):
    a = rng.standard_normal((m, m))
    return scale * (a @ a.T / m + np.eye(m))


@pytest.mark.parametrize("impl", ["gemm", "direct"])
def test_sqdist(rng, impl, monkeypatch):
    monkeypatch.setattr(jconfig, "sqdist_impl", impl)
    monkeypatch.setattr(tconfig, "sqdist_impl", impl)
    a = rng.standard_normal((37, 3))
    b = np.concatenate([a[:5], rng.standard_normal((8, 3))])  # exact pairs
    out = sqdist(_t(a), _t(b))
    _close(out, j_sqdist(jnp.asarray(a), jnp.asarray(b)), atol=1e-14)
    assert float(out.min()) >= 0.0  # clamped at zero


@pytest.mark.parametrize("jitter", [None, 1e-3])
def test_cholesky_upper_f64(rng, jitter):
    a = _spd(rng, 9)
    u = tla.cholesky_upper(_t(a), jitter)
    _close(u, jla.cholesky_upper(jnp.asarray(a), jitter))
    assert torch.equal(u, torch.triu(u))


def test_cholesky_upper_f32_diag_scaled_jitter(rng):
    """In f32 the default jitter is raised to 1e-5 of the mean diagonal."""
    a = _spd(rng, 9, scale=50.0).astype(np.float32)
    u = tla.cholesky_upper(_t(a, torch.float32))
    _close(u, jla.cholesky_upper(jnp.asarray(a)), rtol=2e-5, atol=1e-5)
    u64 = u.double()
    added = torch.diagonal(u64.T @ u64 - _t(a)).mean()
    want = 1e-5 * float(np.abs(np.diag(a)).mean())
    assert want > 10 * jconfig.cholesky_jitter
    np.testing.assert_allclose(float(added), want, rtol=0.05)


def test_cholesky_upper_not_pd_is_nan():
    u = tla.cholesky_upper(-torch.eye(3, dtype=F64), jitter=0.0)
    assert torch.isnan(u).all()


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("vec", [False, True])
def test_solve_tri(rng, trans, lower, vec):
    u = np.triu(rng.standard_normal((7, 7))) + 4 * np.eye(7)
    tri = u.T if lower else u
    b = rng.standard_normal(7) if vec else rng.standard_normal((7, 3))
    out = tla.solve_tri(_t(tri), _t(b), trans=trans, lower=lower)
    assert out.shape == b.shape
    _close(out, jla.solve_tri(jnp.asarray(tri), jnp.asarray(b), trans=trans,
                              lower=lower))


def test_inv_tri_upper_and_log_det(rng):
    u = np.triu(rng.standard_normal((8, 8))) + 4 * np.eye(8)
    inv = tla.inv_tri_upper(_t(u))
    _close(inv, jla.inv_tri_upper(jnp.asarray(u)), atol=1e-15)
    assert torch.equal(inv, torch.triu(inv))  # exactly upper triangular
    _close(tla.log_det_tri(_t(u)), jla.log_det_tri(jnp.asarray(u)))
    a = rng.standard_normal((5, 4))
    _close(tla.rows_sqr_norm(_t(a)), jla.rows_sqr_norm(jnp.asarray(a)))


def test_matmul_precision_policy(monkeypatch):
    """The policy is written to PyTorch's TF32 switches on every product."""
    a = torch.eye(2, dtype=torch.float32)
    monkeypatch.setattr(tconfig, "matmul_precision", "high")
    tla.matmul(a, a)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(tconfig, "matmul_precision", "highest")
    tla.matmul(a, a)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(tconfig, "matmul_precision", "bogus")
    with pytest.raises(ValueError, match="precision"):
        tla.matmul(a, a)


def _params(log_ell=0.3, log_sf2=0.1):
    jp = JSeIso.Params(log_ell=jnp.asarray(log_ell), log_sf2=jnp.asarray(log_sf2))
    return jp, SeIso(log_ell, log_sf2, device="cpu", dtype=F64)


def test_se_iso_kernel(rng):
    jp, k = _params()
    X = rng.standard_normal((30, 3))
    Z = rng.standard_normal((8, 3))
    ku = k.k_upper(_t(Z))
    _close(ku, JSeIso.k_upper(jp, jnp.asarray(Z)))
    assert torch.equal(torch.diagonal(ku),
                       torch.full((8,), float(np.exp(0.1)), dtype=F64))
    _close(k.k_cross(_t(X), _t(Z)), JSeIso.k_cross(jp, jnp.asarray(X),
                                                    jnp.asarray(Z)))
    _close(k.k_diag(_t(X)), JSeIso.k_diag(jp, jnp.asarray(X)))
    assert k.name == "se_iso" == JSeIso.name
    assert {n for n, _ in k.named_parameters()} == {"log_ell", "log_sf2"}


def test_resolve_family():
    assert resolve_family("se_iso") is SeIso
    assert resolve_family("se_fat").name == "se_fat"
    with pytest.raises(KeyError, match="unknown kernel family"):
        resolve_family("sum(se_iso,bogus)")


@pytest.mark.parametrize("jitter", [None, 1e-6])
def test_calc_inducing(rng, jitter):
    jp, k = _params()
    Z = rng.standard_normal((12, 3))
    ti = calc_inducing(k, _t(Z), jitter)
    ji = j_calc_inducing(JSeIso, jp, jnp.asarray(Z), jitter)
    for name in ("z", "km", "chol_km", "log_det_km"):
        _close(getattr(ti, name), getattr(ji, name), atol=1e-14)
