"""The port's spectral mixture == gpr_tpu's, in f64 on the CPU.

``sm_family(2)`` = sum(prod(se_ard,cosine),prod(se_ard,cosine)) with
JAX's params moved off their defaults: every method at 1e-12, the dense
evidence (qr and chol, variational on and off) and the masked streaming
evidence under both ``grad_impl``s with every gradient at 1e-10, the
packed vector, artifacts both ways and the dense engine's serving
(predict, stats, sample, LOO); ``sm_init_from_data`` and ``sm_spectrum``
bit for bit with no key and with an int key, and a ``torch.Generator``'s
int seed.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu_torch import kernels as tk
from gpr_tpu_torch.kernels.base import hyper_fields
from torch_composite import (
    F64,
    check_artifacts,
    check_dense,
    check_methods,
    check_pack,
    check_serving,
    check_streaming,
    jax_fields,
    jax_streaming,
    perturbed,
    port_kernel,
    t_,
)

N, D, M = 90, 2, 6
JSM2 = jk.sm_family(2)


@functools.lru_cache(maxsize=None)
def _problem():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((N, D))
    y = np.cos(2.0 * X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.standard_normal(N)
    jp = perturbed(JSM2.default_params(X, M, jax.random.PRNGKey(2)), 4)
    Z = rng.standard_normal((M, D))
    mask = (rng.uniform(size=N) > 0.2).astype(np.float64)
    return X, y, Z, mask, rng.standard_normal((15, D)), jp, port_kernel(JSM2,
                                                                         jp)


def test_methods_match_jax():
    X, _, Z, _, _, jp, k = _problem()
    check_methods(JSM2, jp, k, X, Z)
    assert tk.sm_family(2).name == JSM2.name
    assert tk.sm_family(1) is tk.product_family(tk.SeArd, tk.Cosine)
    with pytest.raises(ValueError, match="q >= 1"):
        tk.sm_family(0)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
def test_dense_evidence_and_grads(variational, factorization):
    X, y, Z, _, _, jp, k = _problem()
    check_dense(JSM2, jp, k, X, y, Z, variational, factorization)


@functools.lru_cache(maxsize=None)
def _jax_streaming():
    X, y, Z, mask, _, jp, _ = _problem()
    return jax_streaming(JSM2, jp, X, y, Z, mask)


@pytest.mark.parametrize("grad_impl", ["custom", "ad"])
def test_streaming_evidence_and_grads(grad_impl):
    X, y, Z, mask, _, _, k = _problem()
    check_streaming(k, X, y, Z, mask, grad_impl, *_jax_streaming())


def test_make_pack_matches_jax():
    _, _, Z, _, _, jp, k = _problem()
    check_pack(JSM2, jp, k, Z)


def test_artifacts_cross_packages(tmp_path):
    X, y, Z, _, Xs, jp, k = _problem()
    check_artifacts(JSM2, jp, k, X, y, Z, Xs, tmp_path)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_serving_matches_jax(factorization):
    X, y, Z, _, Xs, jp, k = _problem()
    check_serving(JSM2, jp, k, X, y, Z, Xs, factorization)


def _tone(n=200, seed=3):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-4.0, 4.0, (n, D)), axis=0)
    y = np.sin(2 * np.pi * 0.4 * X[:, 0]) + 0.2 * np.cos(X[:, 1])
    return X, y + 0.05 * rng.standard_normal(n)


@pytest.mark.parametrize("key", [None, 7], ids=["keyless", "int"])
@pytest.mark.parametrize("q", [1, 3])
def test_sm_init_bit_equal(q, key):
    """The same numpy arithmetic: every leaf equal to JAX's bit for bit,
    the module on X's device in X's dtype."""
    X, y = _tone()
    jp = jk.sm_init_from_data(q, X, y, key=key)
    k = tk.sm_init_from_data(q, t_(X), t_(y), key=key)
    assert type(k) is tk.sm_family(q)
    got = {n: v.detach().numpy() for n, v in hyper_fields(k).items()}
    want = jax_fields(jp)
    assert list(got) == list(want)
    for name, value in want.items():
        assert got[name].dtype == np.float64
        np.testing.assert_array_equal(got[name], np.asarray(value), name)
    assert all(p.device == torch.device("cpu") for p in k.parameters())


def test_sm_init_generator_and_spectrum():
    """A generator gives an int seed drawn from it (reproducible, and a
    fresh generator state draws anew); ``sm_spectrum`` is JAX's."""
    X, y = _tone()
    init = [tk.sm_init_from_data(3, t_(X), t_(y),
                                 key=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    mus = [k.terms[2].terms[1].mu for k in init]
    assert torch.equal(mus[0], mus[1]) and not torch.equal(mus[0], mus[2])
    f32 = tk.sm_init_from_data(2, t_(X).float(), t_(y).float())
    assert f32.terms[1].terms[1].mu.dtype == torch.float32
    for (f, p), (jf, jpow) in zip(tk.sm_spectrum(t_(X), t_(y), n_grid=64),
                                  jk.sm_spectrum(X, y, n_grid=64)):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(p, jpow)
    with pytest.raises(ValueError, match="q >= 1"):
        tk.sm_init_from_data(0, X, y, device="cpu")
    k = tk.sm_init_from_data(2, X, y, device="cpu")
    assert k.terms[0].terms[0].log_ells.dtype == F64
