"""The streaming training step of gpr_tpu_torch == gpr_tpu's.

The port's evidence and its gradients with respect to log_ell, log_sf2, z,
sigma2 and y (the hand VJP of ``StreamStatsFn``, run on the CPU through
``_backward_scan``) against ``jax.value_and_grad`` of the JAX package's
``grad_variant="ug"`` VJP in f64 at rtol 1e-10; the custom VJP against
plain autograd; the backward twin against the JAX Pallas backward kernel in
interpret mode; and the upper-triangle rule the CUDA kernel relies on.  The
CUDA backward kernel itself is held against its twin by the tests marked
``cuda`` (skipped without a GPU) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models import streaming as jst
from gpr_tpu.models.fitc import calc_inducing as j_calc_inducing
from gpr_tpu.numerics.linalg import inv_tri_upper as j_inv_tri_upper
from gpr_tpu.ops import fused_stats as jops
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.models.fitc import calc_inducing
from gpr_tpu_torch.numerics.linalg import inv_tri_upper
from gpr_tpu_torch.ops import fused_stats as tops

F64 = torch.float64
RTOL = 1e-10
GRAD_NAMES = ("log_ell", "log_sf2", "z", "sigma2", "y")


def _problem(rng, n=300, d=3, m=8, masked=0):
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.3 * rng.standard_normal(n)
    Z = rng.standard_normal((m, d))
    mask = (np.arange(n) < n - masked).astype(np.float64) if masked else None
    jp = JSeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.1))
    return X, y, Z, mask, jp, 0.4


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _close(t, j, rtol=RTOL, name=""):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * np.abs(j).max(), err_msg=name)


def _leaves(kernel, z, sigma2, y):
    """The port's differentiable inputs, in GRAD_NAMES order."""
    for t in (z, sigma2, y):
        t.requires_grad_(True)
    return (kernel.log_ell, kernel.log_sf2, z, sigma2, y)


def _jax_value_and_grads(jobj, jp, Z, s2, y):
    val, (gp, gz, gs, gy) = jax.value_and_grad(jobj, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(Z), jnp.asarray(s2), jnp.asarray(y))
    return val, (gp.log_ell, gp.log_sf2, gz, gs, gy)


@pytest.mark.parametrize("variational", [False, True])
@pytest.mark.parametrize("block_size", [64, 128])
@pytest.mark.parametrize("n", [256, 300])  # divisible and padded
def test_value_and_gradients_match_jax(rng, variational, block_size, n):
    X, y, Z, _, jp, s2 = _problem(rng, n=n)

    def jobj(p, z, s, yy):
        return jst.streaming_log_evidence(
            JSeIso, p, z, s, jnp.asarray(X), yy, variational=variational,
            block_size=block_size, grad_variant="ug")

    want, jgrads = _jax_value_and_grads(jobj, jp, Z, s2, y)
    kernel, z, sigma2 = from_jax_params(
        {"log_ell": 0.3, "log_sf2": 0.1}, Z, s2, device="cpu", dtype=F64)
    yt = _t(y)
    leaves = _leaves(kernel, z, sigma2, yt)
    got = tst.streaming_log_evidence(kernel, z, sigma2, _t(X), yt,
                                     variational=variational,
                                     block_size=block_size)
    _close(got, want)
    grads = torch.autograd.grad(got, leaves)
    for name, g, w in zip(GRAD_NAMES, grads, jgrads):
        _close(g, w, name=name)


def _masked_objective_port(X, y, Z, mask, s2, grad_impl):
    kernel, z, sigma2 = from_jax_params(
        {"log_ell": 0.3, "log_sf2": 0.1}, Z, s2, device="cpu", dtype=F64)
    yt = _t(y)
    leaves = _leaves(kernel, z, sigma2, yt)
    inducing = calc_inducing(kernel, z)
    stats = tst.stream_stats(kernel, inducing, sigma2, _t(X), yt,
                             block_size=64, mask=_t(mask),
                             grad_impl=grad_impl)
    value = tst.evidence_from_stats(inducing, stats, variational=True)
    return value, torch.autograd.grad(value, leaves)


def test_masked_stream_stats_gradients_match_jax(rng):
    """An explicit mask through stream_stats (masked rows inside n, plus
    padding): the evidence of the statistics and all five gradients."""
    X, y, Z, mask, jp, s2 = _problem(rng, n=300, masked=37)

    def jobj(p, z, s, yy):
        ind = j_calc_inducing(JSeIso, p, z)
        stats = jst.stream_stats(JSeIso, p, ind, s, jnp.asarray(X), yy,
                                 block_size=64, mask=jnp.asarray(mask),
                                 grad_variant="ug")
        return jst.evidence_from_stats(ind, stats, variational=True)

    want, jgrads = _jax_value_and_grads(jobj, jp, Z, s2, y)
    got, grads = _masked_objective_port(X, y, Z, mask, s2, "custom")
    _close(got, want)
    for name, g, w in zip(GRAD_NAMES, grads, jgrads):
        _close(g, w, name=name)


@pytest.mark.parametrize("masked", [0, 37])
def test_custom_vjp_matches_autograd(rng, masked):
    """grad_impl="custom" (the hand VJP) == grad_impl="ad" (autograd
    through the plain loop) in the port itself."""
    X, y, Z, mask, _, s2 = _problem(rng, n=300, masked=masked)
    if mask is None:
        mask = np.ones(300)
    v_c, g_c = _masked_objective_port(X, y, Z, mask, s2, "custom")
    v_a, g_a = _masked_objective_port(X, y, Z, mask, s2, "ad")
    assert v_c.item() == pytest.approx(v_a.item(), rel=1e-13)
    for name, c, a in zip(GRAD_NAMES, g_c, g_a):
        _close(c, a.numpy(), rtol=1e-11, name=name)


def _f32_bwd_inputs(rng, n, masked=0, m=9):
    """f32 inputs of the backward kernel and the real cotangents of the
    evidence's epilogue (from the f64 twin's statistics), as numpy."""
    X, y, Z, mask, jp, s2 = _problem(rng, n=n, m=m, masked=masked)
    u_inv = j_inv_tri_upper(j_calc_inducing(JSeIso, jp, jnp.asarray(Z)).chol_km)
    f32 = [np.asarray(a, np.float32) for a in (Z, u_inv, s2, X, y)]
    mask32 = None if mask is None else mask.astype(np.float32)
    t = [_t(a) for a in f32]
    kernel, z, _ = from_jax_params({"log_ell": 0.3, "log_sf2": 0.1}, Z, s2,
                                   device="cpu", dtype=F64)
    with torch.no_grad():
        stats = tops._se_iso_stats_reference(
            _t(0.3), _t(0.1), *t, None if mask32 is None else _t(mask32),
            block_size=64, acc_dtype=F64)
    stats = [s.clone().requires_grad_(i < 5) for i, s in enumerate(stats)]
    inducing = calc_inducing(kernel, z)
    value = tst.evidence_from_stats(inducing, tst.StreamStats(*stats),
                                    variational=True)
    cot = torch.autograd.grad(value, stats[:5])
    cot32 = [c.numpy().astype(np.float32) for c in cot]
    return f32, mask32, cot32


@pytest.mark.parametrize("n,masked", [(256, 0), (300, 37)])
def test_bwd_twin_matches_pallas_kernel(rng, n, masked):
    """The Pallas backward kernel (interpret, f32) against the twin run in
    f64 on the same f32 inputs, at tests/test_pallas_stats.py's backward
    tolerances."""
    f32, mask32, cot32 = _f32_bwd_inputs(rng, n, masked)
    ref = jops.se_iso_stream_bwd_fused(
        jnp.asarray(0.3), jnp.asarray(0.1), *(jnp.asarray(a) for a in f32),
        None if mask32 is None else jnp.asarray(mask32),
        *(jnp.asarray(c) for c in cot32), block_size=64, interpret=True,
    )
    out = tops.se_iso_stream_bwd_fused(
        _t(0.3), _t(0.1), *(_t(a) for a in f32),
        None if mask32 is None else _t(mask32), *(_t(c) for c in cot32),
        block_size=64, acc_dtype=F64,
    )
    for name, g, w in zip(("log_ell", "log_sf2", "z", "u_inv", "sigma2"),
                          out[:5], ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-4, err_msg=name)
    assert out[5].shape == (n,)


def test_upper_triangle_of_u_inv_cotangent_suffices(rng, monkeypatch):
    """The CUDA kernel returns triu(u_inv_bar) only: through the triangular
    solve that forms U^-1, the evidence gradient is the same as with the
    full product the twin returns."""
    X, y, Z, mask, _, s2 = _problem(rng, n=300, masked=37)
    _, full = _masked_objective_port(X, y, Z, mask, s2, "custom")
    inner = tops._backward_scan

    def upper_only(*args, **kw):
        lel, lsf, zb, uib, s2b, yb = inner(*args, **kw)
        assert bool((uib.tril(-1) != 0).any())  # the twin's is full
        return lel, lsf, zb, uib.triu(), s2b, yb

    monkeypatch.setattr(tops, "_backward_scan", upper_only)
    _, upper = _masked_objective_port(X, y, Z, mask, s2, "custom")
    for name, f, u in zip(GRAD_NAMES, full, upper):
        _close(u, f.numpy(), rtol=1e-13, name=name)


def test_y_cotangent_only_on_request(rng):
    """The y cotangent is computed only when y requires grad: the backward
    kernel gets a null pointer otherwise."""
    f32, mask32, cot32 = _f32_bwd_inputs(rng, 100)
    out = tops.se_iso_stream_bwd_fused(
        _t(0.3), _t(0.1), *(_t(a) for a in f32), None,
        *(_t(c) for c in cot32), block_size=64, acc_dtype=F64, need_y=False)
    assert out[5] is None
    X, y, Z, _, _, s2 = _problem(rng, n=100)
    kernel, z, sigma2 = from_jax_params(
        {"log_ell": 0.3, "log_sf2": 0.1}, Z, s2, device="cpu", dtype=F64)
    yt = _t(y)
    tst.streaming_log_evidence(kernel, z, sigma2, _t(X), yt,
                               block_size=64).backward()
    assert yt.grad is None and kernel.log_ell.grad is not None


def test_backward_launch_counter_stays_zero_on_cpu(rng):
    f32, mask32, cot32 = _f32_bwd_inputs(rng, 100)
    before = tops.se_iso_stream_bwd_fused.launches
    tops.se_iso_stream_bwd_fused(
        _t(0.3), _t(0.1), *(_t(a) for a in f32), None,
        *(_t(c) for c in cot32), block_size=64, acc_dtype=F64)
    assert tops.se_iso_stream_bwd_fused.launches == before == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,masked,m", [(4096, 0, 300), (1000, 37, 37)])
def test_cuda_bwd_kernel_matches_twin(rng, cuda_device, n, masked, m):
    """The f32 backward kernel against the f64 twin on the same (f32)
    inputs and cotangents: z_bar, triu(u_inv_bar) and y_bar within 1e-4
    relative (Frobenius), the scalars within 1e-4."""
    X, y, Z, mask, _, s2 = _problem(rng, n=n, d=8, m=m, masked=masked)
    f32 = np.float32
    kernel, z, sigma2 = from_jax_params(
        {"log_ell": 0.3, "log_sf2": 0.1}, Z.astype(f32), s2,
        device=cuda_device, dtype=torch.float32)
    Xc = torch.as_tensor(X.astype(f32), device=cuda_device)
    yc = torch.as_tensor(y.astype(f32), device=cuda_device)
    mc = None if mask is None else torch.as_tensor(mask.astype(f32),
                                                   device=cuda_device)
    u_inv = inv_tri_upper(calc_inducing(kernel, z).chol_km).contiguous()
    args = [kernel.log_ell.detach(), kernel.log_sf2.detach(), z, u_inv,
            sigma2, Xc, yc, mc]
    g = torch.Generator().manual_seed(0)
    cot = [torch.randn(m, m, generator=g), torch.randn(m, generator=g),
           *torch.randn(3, generator=g)]
    cot = [c.to(cuda_device, torch.float32) for c in cot]
    before = tops.se_iso_stream_bwd_fused.launches
    got = tops.se_iso_stream_bwd_fused(*args, *cot, block_size=1024,
                                       acc_dtype=F64)
    assert tops.se_iso_stream_bwd_fused.launches == before + 1
    want = tops._se_iso_bwd_reference(
        *[None if a is None else a.double() for a in args],
        *[c.double() for c in cot], block_size=1024, acc_dtype=F64)
    want = list(want)
    want[3] = want[3].triu()
    for name, o, w in zip(("log_ell", "log_sf2", "z", "u_inv", "sigma2",
                           "y"), got, want):
        err = float(torch.linalg.norm(o - w) / torch.linalg.norm(w))
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
def test_cuda_training_step_matches_twin(rng, cuda_device):
    """Value and gradient through both kernels (f32) against the f64 plain
    path on the card: each gradient group within 1e-3 relative."""
    X, y, Z, _, _, s2 = _problem(rng, n=20_000, d=8, m=64)

    def run(dtype, impl):
        kernel, z, sigma2 = from_jax_params(
            {"log_ell": 0.3, "log_sf2": 0.1}, Z, s2, device=cuda_device,
            dtype=dtype)
        z.requires_grad_(True)
        sigma2.requires_grad_(True)
        Xc = torch.as_tensor(X, dtype=dtype, device=cuda_device)
        yc = torch.as_tensor(y, dtype=dtype, device=cuda_device)
        val = tst.streaming_log_evidence(kernel, z, sigma2, Xc, yc,
                                         block_size=1024, impl=impl)
        val.backward()
        return val, (kernel.log_ell.grad, kernel.log_sf2.grad, z.grad,
                     sigma2.grad)

    before = [tops.se_iso_stream_stats_fused_acc.launches,
              tops.se_iso_stream_bwd_fused.launches]
    v32, g32 = run(torch.float32, "fused_acc")
    assert [tops.se_iso_stream_stats_fused_acc.launches,
            tops.se_iso_stream_bwd_fused.launches] == [b + 1 for b in before]
    v64, g64 = run(F64, "reference")
    assert float(v32) == pytest.approx(float(v64), rel=2e-5)
    for a, b in zip(g32, g64):
        err = float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
        assert err <= 1e-3

