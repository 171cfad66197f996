"""The port's batched multi-task GPs (models/multitask.py) == gpr_tpu's, in
f64 on the CPU.

B stacked tasks of one numpy draw go through ``gpr_tpu.models.multitask``
and the port: ``batched_log_evidence`` (dense under ``torch.func.vmap``,
shared inputs, and the streaming loop over tasks) and
``batched_value_and_grad``'s values and every per-task gradient group
(kernel hypers, z, sigma2), dense and streaming, at rtol 1e-10, each also
equal to the task's own evidence; ``multi_start``'s final vectors and
evidences.  On the card (``cuda``) the streaming value and gradient of B
SE-iso f32 tasks launch each statistics kernel B times.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import multitask as jmt
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models import multitask as tmt
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.optim import make_pack
from torch_ext import F64, close, cuda_device, t  # noqa: F401

B = 3


def _stacked(B=B, n=120, d=3, m=6, seed=0, dtype=F64, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, d))
    y = rng.standard_normal((B, n))
    Z = rng.standard_normal((B, m, d))
    log_ell = rng.standard_normal(B) * 0.2
    log_sf2 = rng.standard_normal(B) * 0.2
    sigma2 = 0.2 + rng.uniform(size=B)
    jp = jk.SeIso.Params(log_ell=jnp.asarray(log_ell),
                         log_sf2=jnp.asarray(log_sf2))
    k = SeIso(log_ell, log_sf2, device=device, dtype=dtype)
    return jp, k, Z, sigma2, X, y


@pytest.mark.parametrize("block_size", [None, 32])
def test_batched_evidence_matches_jax(block_size):
    jp, k, Z, s2, X, y = _stacked()
    want = jmt.batched_log_evidence(jk.SeIso, jp, jnp.asarray(Z),
                                    jnp.asarray(s2), jnp.asarray(X),
                                    jnp.asarray(y), block_size=block_size)
    got = tmt.batched_log_evidence(k, t(Z), t(s2), t(X), t(y),
                                   block_size=block_size)
    close(got, want)
    shared = tmt.batched_log_evidence(k, t(Z), t(s2), None, t(y),
                                      shared_inputs=t(X[0]),
                                      block_size=block_size)
    close(shared, jmt.batched_log_evidence(
        jk.SeIso, jp, jnp.asarray(Z), jnp.asarray(s2), None, jnp.asarray(y),
        shared_inputs=jnp.asarray(X[0]), block_size=block_size))


@pytest.mark.parametrize("block_size", [None, 32])
def test_batched_value_and_grad_matches_jax(block_size):
    jp, k, Z, s2, X, y = _stacked()
    jvals, (jgp, jgz, jgs) = jmt.batched_value_and_grad(
        jk.SeIso, block_size=block_size)(jp, jnp.asarray(Z), jnp.asarray(s2),
                                         jnp.asarray(X), jnp.asarray(y))
    vals, (gp, gz, gs) = tmt.batched_value_and_grad(block_size=block_size)(
        k, t(Z), t(s2), t(X), t(y))
    close(vals, jvals, name="values")
    for field in ("log_ell", "log_sf2"):
        close(gp[field], getattr(jgp, field), name=field)
    close(gz, jgz, name="z")
    close(gs, jgs, name="sigma2")
    # each task's own evidence
    for b in range(B):
        kb = SeIso(k.log_ell[b].item(), k.log_sf2[b].item(), device="cpu",
                   dtype=F64)
        own = tst.streaming_log_evidence(kb, t(Z[b]), s2[b], t(X[b]),
                                         t(y[b]), block_size=32)
        close(-vals[b], own.detach(), name=f"task {b}")


def test_multi_start_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((200, 1))
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(200)
    Z0 = X[::33][:6]
    jpack = jmake_pack(jk.SeIso, jk.SeIso.Params(log_ell=jnp.asarray(0.0),
                                                 log_sf2=jnp.asarray(0.0)),
                       jnp.asarray(Z0), 1.0)
    pack = make_pack(SeIso(0.0, 0.0, device="cpu", dtype=F64), t(Z0), 1.0)
    starts = np.stack([np.asarray(jpack.x0) + s for s in (0.0, 0.5, -0.5)])
    jbest, jls = jmt.multi_start(jk.SeIso, jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(starts), jpack.unpack, steps=10)
    best, ls = tmt.multi_start(t(X), t(y), t(starts), pack.unpack, steps=10)
    close(ls, jls, name="evidences")
    close(best, jbest, name="best")


@pytest.mark.cuda
def test_streaming_launches_per_task(cuda_device):
    from gpr_tpu_torch.ops import fused_stats

    f32 = torch.float32
    _, k, Z, s2, X, y = _stacked(B=4, n=20_000, d=8, m=64, dtype=f32,
                                 device=cuda_device)
    fwd = fused_stats.se_iso_stream_stats_fused_acc
    bwd = fused_stats.se_iso_stream_bwd_fused
    fwd.launches = bwd.launches = 0
    vals, _ = tmt.batched_value_and_grad(block_size=4096)(
        k, *(t(a, f32, cuda_device) for a in (Z, s2, X, y)))
    assert (fwd.launches, bwd.launches) == (4, 4)
    assert bool(torch.isfinite(vals).all())
