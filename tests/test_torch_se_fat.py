"""The port's se_fat kernel family == gpr_tpu's, in f64 on the CPU.

Every method of ``SeFat`` against ``gpr_tpu.kernels.SeFat`` with each
combination of the three options (tproj, hetero noise, multiscales) on and
off at rtol 1e-12; the hand pullback ``k_cross_vjp`` against autograd and
against the JAX one; ``streaming_log_evidence`` (value and the gradient
with respect to every field that is on, z and sigma2) against
``jax.value_and_grad`` of the JAX package's at rtol 1e-10, for both
``grad_impl``s and variational on and off; the autograd fallback of the
streaming VJP for a family without a hand pullback; the packed vector
against JAX's ``make_pack``; and the refusal of a kernel impl.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeFat as JSeFat
from gpr_tpu.models import streaming as jst
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu_torch.kernels import SeFat, resolve_family
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.optim import make_pack

F64 = torch.float64
N, BIG_D, D, M = 200, 4, 3, 7
#: (tproj, hetero, multiscales) on or off
OPTIONS = list(itertools.product((False, True), repeat=3))
IDS = ["".join(c if on else "-" for c, on in zip("thm", o)) for o in OPTIONS]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


def _problem(opts, seed=0):
    """(X, y, Z, JAX params, port kernel) for the options ``opts``."""
    tproj_on, het_on, ms_on = opts
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, BIG_D))
    y = np.sin(X[:, 0] - X[:, 1]) + 0.2 * rng.standard_normal(N)
    d = D if tproj_on else BIG_D
    fields = {
        "log_sf2": np.asarray(0.2),
        "tproj": rng.standard_normal((BIG_D, d)) / 2 if tproj_on else None,
        "log_hetero_skedasticity": (rng.uniform(-4, -2, M) if het_on
                                    else None),
        "log_multiscales_m05": (rng.uniform(-1, 1, (M, d)) if ms_on
                                else None),
    }
    Z = rng.standard_normal((M, d))
    jp = JSeFat.Params(d=d, **{k: None if v is None else jnp.asarray(v)
                               for k, v in fields.items()})
    kernel = SeFat(d, **fields, device="cpu", dtype=F64)
    return X, y, Z, jp, kernel


@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
def test_methods_match_jax(opts):
    X, _, Z, jp, k = _problem(opts)
    X2 = X[:13] + 0.1
    tX, tZ, jX, jZ = _t(X), _t(Z), jnp.asarray(X), jnp.asarray(Z)
    cases = {
        "project": (k.project(tX), JSeFat.project(jp, jX)),
        "inducing_from_inputs": (k.inducing_from_inputs(tX[:5]),
                                 JSeFat.inducing_from_inputs(jp, jX[:5])),
        "k_upper": (k.k_upper(tZ), JSeFat.k_upper(jp, jZ)),
        "k_diag": (k.k_diag(tX), JSeFat.k_diag(jp, jX)),
        "k_cross": (k.k_cross(tX, tZ), JSeFat.k_cross(jp, jX, jZ)),
        "k_upper_inputs": (k.k_upper_inputs(tX[:30]),
                           JSeFat.k_upper_inputs(jp, jX[:30])),
        "k_cross_inputs": (k.k_cross_inputs(tX[:30], _t(X2)),
                           JSeFat.k_cross_inputs(jp, jX[:30],
                                                 jnp.asarray(X2))),
        "k_one": (k.k_one(tX[0]), JSeFat.k_one(jp, jX[0])),
    }
    for name, (got, want) in cases.items():
        assert tuple(got.shape) == tuple(np.shape(want)), name
        _close(got, want, 1e-12, name)
    assert k.name == JSeFat.name == "se_fat"
    assert resolve_family("se_fat") is SeFat


def test_default_params_layout():
    """The JAX package's layout and fixed values; the draws are the
    generator's own (a JAX key cannot be replayed)."""
    X = np.abs(np.random.default_rng(1).standard_normal((40, 12))) + 0.5
    jp = JSeFat.default_params(jnp.asarray(X), 5)
    gen = torch.Generator().manual_seed(0)
    k = SeFat.default_params(_t(X), 5, gen)
    again = SeFat.default_params(_t(X), 5, torch.Generator().manual_seed(0))
    assert k.d == jp.d == 10
    for name in SeFat.param_names:
        got = getattr(k, name)
        assert tuple(got.shape) == tuple(np.shape(getattr(jp, name))), name
        assert got.dtype == F64
        assert torch.equal(got, getattr(again, name)), name
    _close(k.log_hetero_skedasticity, jp.log_hetero_skedasticity, 0)
    _close(k.log_multiscales_m05, jp.log_multiscales_m05, 0)
    assert -1.0 <= float(k.log_sf2.detach()) <= 1.0
    # tproj row r is U(-1, 1) scaled by (n / D) / sum(X[:, r])
    bound = (40 / 12) / X.sum(0)
    assert np.all(np.abs(k.tproj.detach().numpy()) <= bound[:, None])


@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
def test_k_cross_vjp(opts):
    """The hand pullback == autograd of (k_cross, k_diag) == JAX's; the
    hetero noise's cotangent is zero, not absent."""
    X, _, Z, jp, k = _problem(opts)
    rng = np.random.default_rng(5)
    knm_bar, kd_bar = rng.standard_normal((N, M)), rng.standard_normal(N)
    tX, tZ = _t(X), _t(Z).requires_grad_(True)
    names, hypers = hyper_leaves(k)
    knm = k.k_cross(tX, tZ)
    got = k.k_cross_vjp(tX, tZ.detach(), knm.detach(), _t(knm_bar),
                        _t(kd_bar))
    assert len(got) == len(names) + 1
    objective = (torch.sum(knm * _t(knm_bar))
                 + torch.sum(k.k_diag(tX) * _t(kd_bar)))
    auto = torch.autograd.grad(objective, (*hypers, tZ), allow_unused=True)
    jknm = JSeFat.k_cross(jp, jnp.asarray(X), jnp.asarray(Z))
    jbar, jz_bar = JSeFat.k_cross_vjp(jp, jnp.asarray(X), jnp.asarray(Z),
                                      jknm, jnp.asarray(knm_bar),
                                      jnp.asarray(kd_bar))
    for name, g, a in zip((*names, "z"), got, auto):
        want = jz_bar if name == "z" else getattr(jbar, name)
        _close(g, want, 1e-12, name)
        if name == "log_hetero_skedasticity":
            assert a is None and not torch.any(g)
        else:
            _close(g, a.numpy(), 1e-12, name)


def _jax_value_and_grad(X, y, Z, jp, variational):
    names = [n for n in SeFat.param_names if getattr(jp, n) is not None]

    def f(fields, z, s2):
        p = JSeFat.Params(d=jp.d, **{
            n: fields.get(n) for n in SeFat.param_names})
        return jst.streaming_log_evidence(
            JSeFat, p, z, s2, jnp.asarray(X), jnp.asarray(y),
            variational=variational, block_size=64)

    fields = {n: getattr(jp, n) for n in names}
    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        fields, jnp.asarray(Z), jnp.asarray(0.3))
    return val, {**grads[0], "z": grads[1], "sigma2": grads[2]}


@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
def test_streaming_evidence_and_grads(opts, variational):
    """Value and the gradient with respect to every field that is on, z
    and sigma2 == jax.value_and_grad's, for both grad_impls (rtol 1e-10)."""
    X, y, Z, jp, _ = _problem(opts)
    jval, jgrads = _jax_value_and_grad(X, y, Z, jp, variational)
    for grad_impl in ("custom", "ad"):
        _, _, _, _, k = _problem(opts)
        names, hypers = hyper_leaves(k)
        z, s2 = _t(Z).requires_grad_(True), _t(0.3).requires_grad_(True)
        val = tst.streaming_log_evidence(
            k, z, s2, _t(X), _t(y), variational=variational, block_size=64,
            grad_impl=grad_impl)
        grads = torch.autograd.grad(val, (*hypers, z, s2))
        _close(val, jval, 1e-10, f"{grad_impl} value")
        for name, g in zip((*names, "z", "sigma2"), grads):
            _close(g, jgrads[name], 1e-10, f"{grad_impl} {name}")


class _AutogradSeFat(SeFat):
    """se_fat without its hand pullback: the streaming VJP must fall back
    to autograd of the tile, as a family with no ``k_cross_vjp`` does."""

    k_cross_vjp = None


def test_streaming_vjp_autograd_fallback():
    X, y, Z, _, k = _problem((True, True, True))
    plain = _AutogradSeFat.of(k.d, *(getattr(k, n) for n in (
        "log_sf2", "tproj", "log_hetero_skedasticity",
        "log_multiscales_m05")))
    grads = []
    for kernel in (k, plain):
        names, hypers = hyper_leaves(kernel)
        z = _t(Z).requires_grad_(True)
        val = tst.streaming_log_evidence(kernel, z, 0.3, _t(X), _t(y),
                                         variational=True, block_size=64)
        grads.append(torch.autograd.grad(val, (*hypers, z)))
    for name, a, b in zip((*names, "z"), *grads):
        _close(b, a.numpy(), 1e-12, name)


@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
def test_make_pack_matches_jax(opts):
    """The packed vector means the same in both packages, and unpack
    rebuilds the kernel with d and the fields that are off."""
    _, _, Z, jp, k = _problem(opts)
    for kw in ({}, {"fixed": ("log_sf2",)}, {"learn_sigma2": False}):
        jpack = j_make_pack(JSeFat, jp, jnp.asarray(Z), 0.3, **kw)
        pack = make_pack(k, _t(Z), 0.3, **kw)
        _close(pack.x0, jpack.x0, 0, str(kw))
        kernel, z, s2 = pack.unpack(pack.x0)
        assert kernel.d == k.d
        for name in SeFat.param_names:
            want = getattr(k, name)
            got = getattr(kernel, name)
            assert (got is None) == (want is None), name
            if want is not None:
                assert torch.equal(got, want.detach()), name


@pytest.mark.parametrize("impl", ["fused_acc", "fused"])
def test_kernel_impl_refuses_se_fat(impl):
    X, y, Z, _, k = _problem((True, True, True))
    with pytest.raises(ValueError, match="se_iso kernel only"):
        tst.streaming_log_evidence(k, _t(Z), 0.3, _t(X), _t(y), impl=impl)
    assert tst._resolve_impl(None, _t(X), k) == "reference"
