"""Shared helpers of the port's Laplace tests (``test_torch_ift.py``,
``test_torch_classify.py``, ``test_torch_count.py``,
``test_torch_ordinal.py``): one numpy draw of rows, inducing points and
every family's targets, the SE-iso kernel at the same hypers in both
packages, and value-and-gradient of an evidence in each, compared at
rtol 1e-10 relative to each group's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu_torch.kernels import SeIso
from torch_ext import F64, RTOL, close, t

JP = jk.SeIso.Params(log_ell=jnp.asarray(0.2), log_sf2=jnp.asarray(0.3))
GROUPS = ("log_ell", "log_sf2", "z", "lik")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for a module's small tensors, restored after: under
    several pytest workers the default pool oversubscribes the cores (the
    EP and multi-class files took 3.7x the test time).  Autouse where a
    test module imports it."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def kernel():
    return SeIso(0.2, 0.3, device="cpu", dtype=F64)


def setup(n=97, m=7, d=2, seed=0):
    """X (n, d), Z (m, d) and the targets of every family over the latent
    sin(2 x0 - x1): binary labels in {-1, +1}, Poisson counts, binomial
    trials 1..5 and successes, NB2 counts (r = 2), ordinal categories
    0..3 and a log exposure."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    Z = rng.standard_normal((m, d))
    latent = np.sin(2.0 * X[:, 0] - X[:, 1])
    trials = rng.integers(1, 6, n)
    data = {
        "X": X, "Z": Z,
        "classify": np.where(latent + 0.5 * rng.standard_normal(n) > 0,
                             1.0, -1.0),
        "poisson": rng.poisson(np.exp(latent)).astype(float),
        "trials": trials.astype(float),
        "binomial": rng.binomial(trials, 1.0 / (1.0 + np.exp(-latent)))
        .astype(float),
        "negbin": rng.negative_binomial(2.0, 2.0 / (2.0 + np.exp(latent)))
        .astype(float),
        "ordinal": np.digitize(latent + 0.3 * rng.standard_normal(n),
                               [-0.5, 0.0, 0.5]),
        "exposure": 0.2 * rng.standard_normal(n),
        "mask": (np.arange(n) % 9 != 4).astype(float),
        "Xs": rng.standard_normal((11, d)),
    }
    return data


def jax_value_and_grad(fn, Z, extra=None):
    """(value, [log_ell, log_sf2, z(, extra)] gradients) of
    ``fn(params, z(, extra))`` in JAX."""
    args = (JP, jnp.asarray(Z))
    if extra is not None:
        args += (jnp.asarray(extra),)
    val, g = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)
    return float(val), [g[0].log_ell, g[0].log_sf2, *g[1:]]


def torch_value_and_grad(fn, Z, extra=None):
    """(value, [log_ell, log_sf2, z(, extra)] gradients) of
    ``fn(kernel, z(, extra))`` in the port, f64 on the CPU."""
    k = kernel()
    leaves = [t(Z).requires_grad_(True)]
    if extra is not None:
        leaves.append(t(extra).requires_grad_(True))
    val = fn(k, *leaves)
    grads = torch.autograd.grad(val, [k.log_ell, k.log_sf2, *leaves])
    return val, list(grads)


def assert_same(got, want, rtol=RTOL):
    close(got[0], want[0], rtol, "value")
    for name, g, w in zip(GROUPS, got[1], want[1]):
        close(g, w, rtol, name)
