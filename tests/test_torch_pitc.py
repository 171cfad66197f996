"""The port's PITC evidence (models/pitc.py) == gpr_tpu's, in f64 on the CPU.

The same numpy draw goes through ``gpr_tpu.models.pitc`` and the port: the
evidence and every gradient group (the kernel's hypers, z, sigma2) agree at
rtol 1e-10 for a partition with a padded last block and masked padding,
whatever the chunk of blocks a step (the chunk never changes the
partition), for SE-iso and for families whose within-block gram is batched
(rq, lin_ard, a sum); ``pitc_coeffs`` agrees too.  The JAX tests'
identities hold in the port: ``block_size=1`` is the FITC evidence and one
block of all rows the exact GP's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.models import pitc as jpitc
from gpr_tpu_torch.kernels import resolve_family
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import exact as texact
from gpr_tpu_torch.models import pitc as tpitc
from gpr_tpu_torch.models import streaming as tst
from torch_ext import F64, close as _close, jax_leaf as _jax_leaf, t as _t

N, D, M, SIGMA2 = 150, 3, 6, 0.3
FIELDS = {
    "se_iso": {"log_ell": 0.2, "log_sf2": 0.1},
    "rq": {"log_ell": 0.2, "log_sf2": 0.1, "log_alpha": -0.3},
    "lin_ard": {"log_ells": [0.3, -0.2, 0.1]},
    "sum(se_iso,lin_ard)": {"terms.0.log_ell": 0.2, "terms.0.log_sf2": 0.1,
                            "terms.1.log_ells": [0.3, -0.2, 0.1]},
}


def _jax_params(name):
    from gpr_tpu.kernels import resolve_family as jresolve

    fam = jresolve(name)
    if name.startswith("sum("):
        terms = tuple(
            t.Params(**{k.split(".")[-1]: jnp.asarray(v)
                        for k, v in FIELDS[name].items()
                        if k.startswith(f"terms.{i}.")})
            for i, t in enumerate(fam.terms))
        return fam, fam.Params(terms=terms)
    return fam, fam.Params(**{k: jnp.asarray(v)
                              for k, v in FIELDS[name].items()})


def _problem(name, n=N, m=M, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    fam, jp = _jax_params(name)
    kernel = resolve_family(name)(**FIELDS[name], device="cpu", dtype=F64)
    Z = np.asarray(fam.inducing_from_inputs(jp, jnp.asarray(X[:m])))
    return X, y, Z, fam, jp, kernel


@functools.lru_cache
def _jax_value_and_grads(block_size):
    X, y, Z, fam, jp, _ = _problem("se_iso")
    return jax.value_and_grad(
        lambda p, z, s2: jpitc.pitc_log_evidence(
            fam, p, z, s2, jnp.asarray(X), jnp.asarray(y),
            block_size=block_size),
        argnums=(0, 1, 2))(jp, jnp.asarray(Z), jnp.asarray(SIGMA2))


@pytest.mark.parametrize("chunk_rows", [7, 16, tpitc.CHUNK_ROWS])
@pytest.mark.parametrize("block_size", [1, 7, 50])
def test_value_and_grads_match_jax(block_size, chunk_rows, monkeypatch):
    """Block 7 leaves a padded last block of 3 rows; chunk 7 takes one
    block a step, 16 two (and a last chunk of one block)."""
    monkeypatch.setattr(tpitc, "CHUNK_ROWS", chunk_rows)
    X, y, Z, _, _, k = _problem("se_iso")
    jval, jg = _jax_value_and_grads(block_size)
    z, s2 = _t(Z).requires_grad_(True), _t(SIGMA2).requires_grad_(True)
    inducing = tpitc.calc_inducing(k, z)
    stats = tpitc.pitc_stream_stats(k, inducing, s2, _t(X), _t(y),
                                    block_size=block_size)
    val = tst.evidence_from_stats(inducing, stats)
    names, hypers = hyper_leaves(k)
    grads = torch.autograd.grad(val, (*hypers, z, s2))
    _close(val, jval, name="value")
    for name, g in zip(names, grads):
        _close(g, _jax_leaf(jg[0], name), name=name)
    _close(grads[-2], jg[1], name="z")
    _close(grads[-1], jg[2], name="sigma2")


@pytest.mark.parametrize("name", sorted(set(FIELDS) - {"se_iso"}))
def test_families_match_jax(name):
    """The within-block gram of each family, batched over a chunk, and the
    evidence's gradients."""
    # m below lin_ard's rank d: past it the jitter amplifies rounding
    X, y, Z, fam, jp, k = _problem(name, m=2)
    jval, (jgp, jgz) = jax.value_and_grad(
        lambda p, z: jpitc.pitc_log_evidence(
            fam, p, z, SIGMA2, jnp.asarray(X), jnp.asarray(y),
            block_size=20), argnums=(0, 1))(jp, jnp.asarray(Z))
    z = _t(Z).requires_grad_(True)
    val = tpitc.pitc_log_evidence(k, z, SIGMA2, _t(X), _t(y), block_size=20)
    names, hypers = hyper_leaves(k)
    grads = torch.autograd.grad(val, (*hypers, z))
    _close(val, jval, name="value")
    for field, g in zip(names, grads):
        _close(g, _jax_leaf(jgp, field), name=field)
    _close(grads[-1], jgz, name="z")


def test_coeffs_match_jax():
    X, y, Z, fam, jp, k = _problem("se_iso")
    ji, jr, jc = jpitc.pitc_coeffs(fam, jp, jnp.asarray(Z), SIGMA2,
                                   jnp.asarray(X), jnp.asarray(y),
                                   block_size=32)
    inducing, r_mat, coeffs = tpitc.pitc_coeffs(k, _t(Z), SIGMA2, _t(X),
                                                _t(y), block_size=32)
    _close(coeffs, jc, name="coeffs")
    _close(r_mat, jr, name="r_mat")
    _close(inducing.chol_km, ji.chol_km, name="chol_km")


def test_block_size_one_is_fitc():
    X, y, Z, _, _, k = _problem("se_iso")
    fitc = tst.streaming_log_evidence(k, _t(Z), SIGMA2, _t(X), _t(y),
                                      block_size=50)
    pitc = tpitc.pitc_log_evidence(k, _t(Z), SIGMA2, _t(X), _t(y),
                                   block_size=1)
    _close(pitc, fitc.detach().numpy())


def test_one_block_is_exact_gp():
    X, y, Z, _, _, k = _problem("se_iso", n=120)
    pitc = tpitc.pitc_log_evidence(k, _t(Z), SIGMA2, _t(X), _t(y),
                                   block_size=120)
    exact = texact.log_evidence_exact(k, _t(X), _t(y), SIGMA2)
    _close(pitc, exact.detach().numpy(), rtol=1e-8)
