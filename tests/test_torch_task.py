"""The port's coregionalization (task) kernel and the ICM model ==
gpr_tpu's, in f64 on the CPU.

``ICM`` = icm_family(se_iso, 2, 3, 2) over rows [x0, x1, task id], with
JAX's params moved off their defaults: every method at 1e-12, the dense
evidence (qr and chol, variational on and off) and the masked streaming
evidence under both ``grad_impl``s with every gradient at 1e-10, the task
column of the z gradient exactly 0, the packed vector, artifacts both
ways, the dense engine's serving (predict, stats, sample, LOO); the task
family alone (entries, B, the keyless init bit-equal to JAX's, the
generator's draw) and the cols restriction law.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu_torch import kernels as tk
from torch_composite import (
    F64,
    check_artifacts,
    check_dense,
    check_methods,
    check_pack,
    check_serving,
    check_streaming,
    close,
    jax_streaming,
    perturbed,
    port_kernel,
    t_,
)

T, R, D, N, M = 3, 2, 2, 90, 6
JICM = jk.icm_family(jk.SeIso, D, T, R)


def _stacked(rng, n):
    """Rows [features..., task id]."""
    return np.c_[rng.standard_normal((n, D)),
                 rng.integers(0, T, n).astype(np.float64)]


@functools.lru_cache(maxsize=None)
def _problem():
    rng = np.random.default_rng(5)
    X = _stacked(rng, N)
    y = np.sin(X[:, 0]) * (1.0 + 0.5 * X[:, D]) + 0.1 * rng.standard_normal(N)
    jp = perturbed(JICM.default_params(X, M, jax.random.PRNGKey(1)), 3)
    Z = _stacked(rng, M)
    mask = (rng.uniform(size=N) > 0.2).astype(np.float64)
    return X, y, Z, mask, _stacked(rng, 15), jp, port_kernel(JICM, jp)


def test_methods_match_jax():
    X, _, Z, _, _, jp, k = _problem()
    check_methods(JICM, jp, k, X, Z)
    close(k.terms[0].terms[0].coregionalization(),
          jk.task_family(T, R).coregionalization(jp.terms[0].terms[0]),
          1e-12)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
def test_dense_evidence_and_grads(variational, factorization):
    X, y, Z, _, _, jp, k = _problem()
    grads = check_dense(JICM, jp, k, X, y, Z, variational, factorization)
    assert torch.all(grads["z"][:, D] == 0) and torch.any(grads["z"] != 0)


@functools.lru_cache(maxsize=None)
def _jax_streaming():
    X, y, Z, mask, _, jp, _ = _problem()
    return jax_streaming(JICM, jp, X, y, Z, mask)


@pytest.mark.parametrize("grad_impl", ["custom", "ad"])
def test_streaming_evidence_and_grads(grad_impl):
    X, y, Z, mask, _, _, k = _problem()
    grads = check_streaming(k, X, y, Z, mask, grad_impl, *_jax_streaming())
    assert torch.all(grads["z"][:, D] == 0)


def test_make_pack_matches_jax():
    _, _, Z, _, _, jp, k = _problem()
    pack, _ = check_pack(JICM, jp, k, Z)
    # the any() over the terms: the task term learns no inducing points,
    # the se_iso term does
    assert pack.learn_inducing and not tk.task_family(
        T, R).learn_inducing_default


def test_artifacts_cross_packages(tmp_path):
    X, y, Z, _, Xs, jp, k = _problem()
    check_artifacts(JICM, jp, k, X, y, Z, Xs, tmp_path)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_serving_matches_jax(factorization):
    X, y, Z, _, Xs, jp, k = _problem()
    check_serving(JICM, jp, k, X, y, Z, Xs, factorization)


def test_task_family_alone():
    """Entries of task(T, R) and B against explicit numpy; ids round half
    to even and clip, as jnp.round and jnp.clip do."""
    fam, jfam = tk.task_family(T, R), jk.task_family(T, R)
    rng = np.random.default_rng(2)
    W, log_kappa = rng.standard_normal((T, R)), rng.standard_normal(T)
    k = fam(W, log_kappa, device="cpu", dtype=F64)
    B = W @ W.T + np.diag(np.exp(log_kappa))
    close(k.coregionalization(), B, 1e-14)
    ids = np.array([[0.0], [0.5], [1.5], [2.5], [-3.0], [7.0], [1.2]])
    want_ids = np.array([0, 0, 2, 2, 0, 2, 1])
    close(k.k_cross(t_(ids), t_(ids)), B[np.ix_(want_ids, want_ids)], 1e-14)
    jp = jfam.Params(W=W, log_kappa=log_kappa)
    close(k.k_diag(t_(ids)), jfam.k_diag(jp, ids), 1e-14)
    close(k.k_one(t_(ids[3])), jfam.k_one(jp, ids[3]), 1e-14)
    assert fam.name == "task(3,2)" and tk.resolve_family(fam.name) is fam
    assert fam is tk.task_family(T, R) and fam is not tk.task_family(T, 1)
    assert fam.param_names == ("W", "log_kappa")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_default_params(dtype):
    """Without a generator, JAX's keyless 0.3 cos(arange + 0.7) bit for
    bit; with one, 0.3 N(0, 1) from that generator, reproducibly."""
    X = torch.zeros((4, 1), dtype=dtype)
    for t_r in ((3, 2), (4, 2), (5, 5)):
        k = tk.task_family(*t_r).default_params(X, 2)
        jp = jk.task_family(*t_r).default_params(X.numpy(), 2)
        assert k.W.dtype == dtype
        np.testing.assert_array_equal(k.W.detach().numpy(), np.asarray(jp.W))
        np.testing.assert_array_equal(k.log_kappa.detach().numpy(),
                                      np.asarray(jp.log_kappa))
    fam = tk.task_family(T, R)
    drawn = fam.default_params(X, 2, torch.Generator().manual_seed(4))
    again = fam.default_params(X, 2, torch.Generator().manual_seed(4))
    assert torch.equal(drawn.W, again.W) and drawn.W.shape == (T, R)
    assert not torch.equal(drawn.W, fam.default_params(X, 2).W)


def test_cols_restriction_law():
    """cols(se_iso, 0, d) on stacked rows == se_iso on the features."""
    X, _, Z, _, _, _, _ = _problem()
    fam = tk.cols_family(tk.SeIso, 0, D)
    k = fam(tk.SeIso(0.3, -0.2, device="cpu", dtype=F64))
    se = k.terms[0]
    close(k.k_cross(t_(X), t_(Z)), se.k_cross(t_(X[:, :D]), t_(Z[:, :D])),
          1e-15)
    close(k.k_upper(t_(Z)), se.k_upper(t_(Z[:, :D])), 1e-15)
    close(k.k_diag(t_(X)), se.k_diag(t_(X[:, :D])), 1e-15)
    assert tk.icm_family(tk.SeIso, D, T, R).name == JICM.name
