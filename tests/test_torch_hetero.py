"""Per-row sigma2 on the port's streaming path == gpr_tpu's, in f64 on the
CPU.

A vector sigma2 of length n (the heteroskedastic evidence) streams through
the plain loop under autograd, blocked like y, as the JAX package's scan
does: the masked evidence and its gradients with respect to the kernel's
hypers, z and the sigma2 vector equal JAX's at rtol 1e-10 under either
``grad_impl`` asked for (a vector takes ``"ad"`` by itself), for SE-iso
and a family with a hand pullback (rq); ``streaming_log_evidence``,
``streaming_trained`` and ``streaming_coeffs`` carry the vector; a
constant vector is the scalar; a kernel impl refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.models import streaming as jst
from gpr_tpu_torch import kernels as tk
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import fitc as tfitc
from gpr_tpu_torch.models import streaming as tst

F64 = torch.float64
N, D, M, BLOCK = 150, 3, 6, 32
RTOL = 1e-10
FIELDS = {"se_iso": {"log_ell": 0.2, "log_sf2": 0.1},
          "rq": {"log_ell": 0.2, "log_sf2": 0.1, "log_alpha": -0.3}}


def _problem(name, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D))
    y = np.sin(X[:, 0] + X[:, 2]) + 0.2 * rng.standard_normal(N)
    Z = rng.standard_normal((M, D))
    noise = 0.1 * (1.0 + 0.5 * rng.uniform(size=N))
    mask = (rng.uniform(size=N) > 0.15).astype(np.float64)
    fam = jk.FAMILIES[name]
    jp = fam.Params(**{k: jnp.asarray(v) for k, v in FIELDS[name].items()})
    kernel = tk.FAMILIES[name](**FIELDS[name], device="cpu", dtype=F64)
    return X, y, Z, noise, mask, fam, jp, kernel


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=RTOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
@pytest.mark.parametrize("grad_impl", ["custom", "ad"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_masked_value_and_grads(name, grad_impl, variational):
    X, y, Z, noise, mask, fam, jp, k = _problem(name)

    def jf(p, z, s2):
        inducing = jfitc.calc_inducing(fam, p, z)
        stats = jst.stream_stats(fam, p, inducing, s2, jnp.asarray(X),
                                 jnp.asarray(y), block_size=BLOCK,
                                 mask=jnp.asarray(mask))
        return jst.evidence_from_stats(inducing, stats,
                                       variational=variational)

    jval, (jgp, jgz, jgs) = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jp, jnp.asarray(Z), jnp.asarray(noise))
    z, s2 = _t(Z).requires_grad_(True), _t(noise).requires_grad_(True)
    inducing = tfitc.calc_inducing(k, z)
    stats = tst.stream_stats(k, inducing, s2, _t(X), _t(y),
                             block_size=BLOCK, mask=_t(mask),
                             grad_impl=grad_impl)
    val = tst.evidence_from_stats(inducing, stats, variational=variational)
    names, hypers = hyper_leaves(k)
    grads = torch.autograd.grad(val, (*hypers, z, s2))
    _close(val, jval, name="value")
    for field, g in zip(names, grads):
        _close(g, getattr(jgp, field), name=field)
    _close(grads[-2], jgz, name="z")
    _close(grads[-1], jgs, name="sigma2")
    # masked rows take no part: their sigma2 cotangent is exactly zero
    assert not torch.any(grads[-1][mask == 0])


def test_entry_points_carry_the_vector():
    """streaming_log_evidence (with its gradient), streaming_trained and
    streaming_coeffs take the vector as JAX's do."""
    X, y, Z, noise, _, fam, jp, k = _problem("se_iso")
    jX, jy, jz = jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z)
    jval, jg = jax.value_and_grad(
        lambda s2: jst.streaming_log_evidence(
            fam, jp, jz, s2, jX, jy, variational=True, block_size=BLOCK))(
        jnp.asarray(noise))
    s2 = _t(noise).requires_grad_(True)
    val = tst.streaming_log_evidence(k, _t(Z), s2, _t(X), _t(y),
                                     variational=True, block_size=BLOCK)
    val.backward()
    _close(val, jval)
    _close(s2.grad, jg)
    jtr = jst.streaming_trained(fam, jp, jz, jnp.asarray(noise), jX, jy,
                                block_size=BLOCK)
    tr = tst.streaming_trained(k, _t(Z), _t(noise), _t(X), _t(y),
                               block_size=BLOCK)
    for field in ("l", "coeffs", "means"):
        _close(getattr(tr, field), getattr(jtr, field), name=field)
    _close(tr.model.r_mat, jtr.model.r_mat, name="r_mat")
    _close(tr.model.sigma2, noise, 0, "sigma2")
    _, r_mat, coeffs = tst.streaming_coeffs(k, _t(Z), _t(noise), _t(X),
                                            _t(y), block_size=BLOCK)
    _, jr, jc = jst.streaming_coeffs(fam, jp, jz, jnp.asarray(noise), jX, jy,
                                     block_size=BLOCK)
    _close(coeffs, jc, name="coeffs")
    _close(r_mat, jr, name="r_mat")


def test_constant_vector_is_the_scalar():
    X, y, Z, _, mask, _, _, k = _problem("se_iso")
    inducing = tfitc.calc_inducing(k, _t(Z))
    per_row = tst.stream_stats(k, inducing, _t(np.full(N, 0.3)), _t(X),
                               _t(y), block_size=BLOCK, mask=_t(mask))
    scalar = tst.stream_stats(k, inducing, 0.3, _t(X), _t(y),
                              block_size=BLOCK, mask=_t(mask))
    for a, b in zip(vars(per_row).values(), vars(scalar).values()):
        _close(a, b.detach().numpy(), 1e-14)


@pytest.mark.parametrize("impl", ["fused_acc", "fused"])
def test_kernel_impl_refuses_a_vector(impl):
    """The kernels take a scalar sigma2: asked for with a vector they raise
    ValueError before anything runs; the default route takes the loop."""
    X, y, Z, noise, _, _, _, k = _problem("se_iso")
    with pytest.raises(ValueError, match="per-row sigma2"):
        tst.streaming_log_evidence(k, _t(Z), _t(noise), _t(X), _t(y),
                                   impl=impl)
    with pytest.raises(ValueError, match="per-row sigma2"):
        tst.streaming_log_evidence(k, _t(Z), _t(noise), _t(X), _t(y),
                                   impl=impl, grad_impl="ad")
    assert tst._resolve_impl(None, _t(X), k, z=_t(Z),
                             per_row=True) == "reference"
