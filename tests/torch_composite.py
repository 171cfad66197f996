"""Shared checks of the port's composite families (the combinators, the ICM
task kernel and the spectral mixture) against gpr_tpu, in f64 on the CPU.

Each check takes a JAX family, its params ``jp`` and the port's kernel
carried over from them (``port_kernel``), runs the same numpy inputs
through both packages and compares at the tolerance it states.  The test
files ``test_torch_combinators.py``, ``test_torch_task.py`` and
``test_torch_sm.py`` parametrize them over their families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.io import checkpoint as jckpt
from gpr_tpu.kernels import base as jbase
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.models import loo as jloo
from gpr_tpu.models import predict as jpred
from gpr_tpu.models import stats as jstats
from gpr_tpu.models import streaming as jst
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu_torch import kernels as tk
from gpr_tpu_torch import models as tm
from gpr_tpu_torch.convert import from_jax_params, params_from_artifact
from gpr_tpu_torch.io import checkpoint as tckpt
from gpr_tpu_torch.kernels import base as tbase
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import fitc as tfitc
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.optim import make_pack

F64 = torch.float64
S2 = 0.3


def t_(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol, name=""):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else a
                 for a in (got, want))
    want = np.asarray(want)
    assert np.shape(got) == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0),
                                               1e-300),
                               err_msg=name)


def jax_fields(jp) -> dict:
    """JAX params as the dotted names of its checkpoint (arrays, then the
    static fields)."""
    arrays, static = jckpt._params_to_arrays(jp)
    return {**arrays, **static}


def perturbed(jp, seed: int):
    """``jp`` with every leaf moved by its own uniform draw in [-0.3, 0.3),
    so that no two leaves hold the same value."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(a + rng.uniform(-0.3, 0.3, np.shape(a))), jp)


def port_kernel(jfam, jp):
    """The port's kernel with JAX's params, through the dotted names."""
    kernel, _, _ = from_jax_params(jax_fields(jp), np.zeros((1, 1)), 1.0,
                                   device="cpu", dtype=F64,
                                   family=jfam.name)
    assert type(kernel) is tk.resolve_family(jfam.name)
    return kernel


def check_methods(jfam, jp, k, X, Z):
    """Every method and protocol helper at rtol 1e-12; the leaf order is
    that of JAX's params."""
    coeffs = np.random.default_rng(3).standard_normal(len(Z))
    tX, tZ, jX, jZ = t_(X), t_(Z), jnp.asarray(X), jnp.asarray(Z)
    cases = {
        "inducing_from_inputs": (k.inducing_from_inputs(tX[:5]),
                                 jfam.inducing_from_inputs(jp, jX[:5])),
        "k_upper": (k.k_upper(tZ), jfam.k_upper(jp, jZ)),
        "k_diag": (k.k_diag(tX), jfam.k_diag(jp, jX)),
        "k_cross": (k.k_cross(tX, tZ), jfam.k_cross(jp, jX, jZ)),
        "k_upper_inputs": (k.k_upper_inputs(tX[:20]),
                           jfam.k_upper_inputs(jp, jX[:20])),
        "k_cross_inputs": (tbase.cross_inputs(k, tX[:7], tX[7:20]),
                           jbase.cross_inputs(jfam, jp, jX[:7], jX[7:20])),
        "k_one": (k.k_one(tX[0]), jfam.k_one(jp, jX[0])),
        "k_upper_cols": (tbase.k_upper_cols(k, tZ, 1, 3),
                         jbase.k_upper_cols(jfam, jp, jZ, 1, 3)),
        "weighted_eval": (
            tbase.weighted_eval(k, tX, tZ, t_(coeffs)),
            jbase.weighted_eval(jfam, jp, jX, jZ, jnp.asarray(coeffs))),
    }
    for method, (got, want) in cases.items():
        close(got, want, 1e-12, method)
    close(tbase.k_upper_cols(k, tZ, 1, 3), k.k_upper(tZ)[:, 1:4], 1e-12,
          "k_upper_cols vs k_upper")
    assert k.name == jfam.name
    assert tk.resolve_family(jfam.name) is type(k)
    assert type(k).learn_inducing_default == jfam.learn_inducing_default
    arrays, _ = jckpt._params_to_arrays(jp)
    assert hyper_leaves(k)[0] == tuple(arrays)


def grads_by_name(val, k, z, s2) -> dict:
    names, hypers = hyper_leaves(k)
    wrt = (*hypers, z, s2)
    grads = torch.autograd.grad(val, wrt)
    return dict(zip((*names, "z", "sigma2"), grads))


def jax_value_and_grads(jp, Z, f):
    """jax.value_and_grad of f(params, z, sigma2), the gradient by dotted
    name."""
    val, (gp, gz, gs) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jp, jnp.asarray(Z), jnp.asarray(S2))
    return val, {**jckpt._params_to_arrays(gp)[0], "z": gz, "sigma2": gs}


def check_value_and_grads(val, grads, jval, jgrads, rtol, tag):
    close(val, jval, rtol, f"{tag} value")
    assert set(grads) == set(jgrads), tag
    for name, g in grads.items():
        close(g, jgrads[name], rtol, f"{tag} {name}")


def check_dense(jfam, jp, k, X, y, Z, variational, factorization):
    """The dense evidence and its gradients at rtol 1e-10."""
    jval, jgrads = jax_value_and_grads(jp, Z, lambda p, z, s: (
        jfitc.log_evidence(jfam, p, z, s, jnp.asarray(X), jnp.asarray(y),
                           variational=variational,
                           factorization=factorization)))
    z, s2 = t_(Z).requires_grad_(True), t_(S2).requires_grad_(True)
    val = tfitc.log_evidence(k, z, s2, t_(X), t_(y), variational=variational,
                             factorization=factorization)
    grads = grads_by_name(val, k, z, s2)
    check_value_and_grads(val, grads, jval, jgrads, 1e-10, "dense")
    return grads


def jax_streaming(jfam, jp, X, y, Z, mask):
    def f(p, z, s):
        inducing = jfitc.calc_inducing(jfam, p, z)
        stats = jst.stream_stats(jfam, p, inducing, s, jnp.asarray(X),
                                 jnp.asarray(y), block_size=32,
                                 mask=jnp.asarray(mask))
        return jst.evidence_from_stats(inducing, stats, variational=True)

    return jax_value_and_grads(jp, Z, f)


def check_streaming(k, X, y, Z, mask, grad_impl, jval, jgrads):
    """The masked streaming evidence (variational, block 32: a ragged last
    block) and its gradients == JAX's at rtol 1e-10; the default route is
    the plain loop, and the kernel impls refuse the composite."""
    z, s2 = t_(Z).requires_grad_(True), t_(S2).requires_grad_(True)
    inducing = tfitc.calc_inducing(k, z)
    stats = tst.stream_stats(k, inducing, s2, t_(X), t_(y), block_size=32,
                             mask=t_(mask), grad_impl=grad_impl)
    val = tst.evidence_from_stats(inducing, stats, variational=True)
    grads = grads_by_name(val, k, z, s2)
    check_value_and_grads(val, grads, jval, jgrads, 1e-10, grad_impl)
    assert tst._resolve_impl(None, t_(X), k, z=z) == "reference"
    for impl in ("fused_acc", "fused"):
        with pytest.raises(ValueError, match="se_iso kernel only"):
            tst.stream_stats(k, inducing, s2, t_(X), t_(y), impl=impl)
    return grads


def check_pack(jfam, jp, k, Z):
    """The packed vector equals JAX's element for element (the leaf order
    of JAX's ravel) and unpacks to the kernel's values."""
    jpack = j_make_pack(jfam, jp, jnp.asarray(Z), S2)
    pack = make_pack(k, t_(Z), S2)
    close(pack.x0, jpack.x0, 0)
    assert pack.learn_inducing == jfam.learn_inducing_default
    kernel, z, _ = pack.unpack(pack.x0)
    for name, value in tbase.hyper_fields(k).items():
        assert torch.equal(tbase.field_of(kernel, name), value.detach())
    assert torch.equal(z, t_(Z))
    return pack, jpack


def check_artifacts(jfam, jp, k, X, y, Z, Xs, path):
    """A JAX artifact serves the same means and variances in the port, and
    the port's loads in JAX with the same params and coefficients."""
    jtr = jst.streaming_trained(jfam, jp, jnp.asarray(Z), S2, jnp.asarray(X),
                                jnp.asarray(y), block_size=32)
    art = jckpt.artifact_from_trained(jfam, jtr, kernel_params=jp)
    jckpt.save_model(str(path / "jax.npz"), art)
    tart, _ = tckpt.load_model(str(path / "jax.npz"))
    kernel, z, s2 = params_from_artifact(tart, device="cpu", dtype=F64)
    assert type(kernel) is type(k)
    args = (jfam, art.kernel_params, jnp.asarray(art.inducing))
    close(tst.predict_means_blocked(kernel, z, t_(art.coeffs), t_(Xs),
                                    block_size=8),
          jst.predict_means_blocked(*args, jnp.asarray(art.coeffs),
                                    jnp.asarray(Xs), block_size=8), 1e-12)
    close(tst.predict_variances_blocked(kernel, z, t_(art.chol_km),
                                        t_(art.r_mat), t_(Xs), s2,
                                        block_size=8),
          jst.predict_variances_blocked(*args, jnp.asarray(art.chol_km),
                                        jnp.asarray(art.r_mat),
                                        jnp.asarray(Xs), S2, block_size=8),
          1e-12)
    tr = tst.streaming_trained(k, t_(Z), S2, t_(X), t_(y), block_size=32)
    tckpt.save_model(str(path / "port.npz"), tckpt.artifact_from_trained(
        type(k), tr, kernel_params=k))
    jart, _ = jckpt.load_model(str(path / "port.npz"))
    assert jart.family is jfam
    for a, b in zip(jax.tree.leaves(jart.kernel_params),
                    jax.tree.leaves(jp)):
        close(a, b, 0)
    assert (jax.tree.structure(jart.kernel_params)
            == jax.tree.structure(jp))
    close(jart.coeffs, art.coeffs, 1e-10)


def check_serving(jfam, jp, k, X, y, Z, Xs, factorization):
    """The dense engine (``factorization``), ``predict_means`` /
    ``predict_variances``, ``calc_stats``, the FITC LOO and the FIC
    covariance sampler == JAX's at rtol 1e-10; the blocked FIC sampler
    runs and repeats under one seed."""
    jX, jXs = jnp.asarray(X), jnp.asarray(Xs)
    jmodel = jfitc.calc_model(jfam, jp, jX, jnp.asarray(Z), S2,
                              factorization=factorization)
    jtr = jfitc.calc_trained(jmodel, jnp.asarray(y))
    model = tm.calc_model(k, t_(X), t_(Z), t_(S2),
                          factorization=factorization)
    tr = tm.calc_trained(model, t_(y))
    close(tr.l, jtr.l, 1e-10, "l")
    close(tr.coeffs, jtr.coeffs, 1e-10, "coeffs")
    mp, jmp = tm.mean_predictor(tr), jpred.mean_predictor(jtr)
    cvp = tm.co_variance_predictor(model)
    jcvp = jpred.co_variance_predictor(jmodel)
    means = tm.predict_means(k, mp, t_(Xs))
    close(means, jpred.predict_means(jfam, jp, jmp, jXs), 1e-10, "means")
    close(tm.predict_variances(k, cvp, t_(Xs), S2),
          jpred.predict_variances(jfam, jp, jcvp, jXs, S2), 1e-10,
          "variances")
    for field, got in tm.calc_stats(tr).__dict__.items():
        close(got, getattr(jstats.calc_stats(jtr), field), 1e-10, field)
    close(tm.loo_log_likelihood_fitc(tr), jloo.loo_log_likelihood(jtr),
          1e-10, "loo")
    cov = tm.covariances_fic(k, cvp, t_(Xs), S2)
    close(cov, jpred.covariances_fic(jfam, jp, jcvp, jXs, S2), 1e-10, "cov")
    draws = [tm.sample_fic_blocked(torch.Generator().manual_seed(1), k, cvp,
                                   t_(Xs), S2, 3, block_size=8)
             for _ in range(2)]
    assert draws[0].shape == (len(Xs), 3) and torch.equal(*draws)
    assert torch.all(torch.isfinite(draws[0]))
