"""Forward-statistics wrappers of gpr_tpu_torch.ops == gpr_tpu's.

On the CPU each wrapper runs its plain twin.  The twins are held against
the JAX Pallas kernels (interpret mode) in f32 inputs, at the f32
tolerances of tests/test_pallas_stats.py, and against the JAX scan in f64
at 1e-11.  The CUDA kernels themselves are held against the twins by the
tests marked ``cuda`` (skipped without a GPU) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models.fitc import calc_inducing as j_calc_inducing
from gpr_tpu.models.streaming import stream_stats as j_stream_stats
from gpr_tpu.numerics.linalg import inv_tri_upper as j_inv_tri_upper
from gpr_tpu.ops import fused_stats as jops
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models.fitc import calc_inducing
from gpr_tpu_torch.models.streaming import stream_stats, streaming_log_evidence
from gpr_tpu_torch.numerics.linalg import inv_tri_upper
from gpr_tpu_torch.ops import fused_stats as tops

WRAPPERS = ["se_iso_stream_stats_fused_acc", "se_iso_stream_stats_fused"]
FIELDS = ("gram", "u_vec", "log_det_s", "y_is_y", "is_r_sum", "n")


def _setup(rng, n=300, d=3, m=8, masked=0):
    X = rng.standard_normal((n, d))
    y = rng.standard_normal(n)
    Z = rng.standard_normal((m, d))
    mask = (np.arange(n) < n - masked).astype(np.float64) if masked else None
    return X, y, Z, mask


def _torch_args(X, y, Z, mask, dtype, log_ell=0.3, log_sf2=0.1, sigma2=0.4):
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    kernel = SeIso(log_ell, log_sf2, device="cpu", dtype=dtype)
    inducing = calc_inducing(kernel, t(Z))
    u_inv = inv_tri_upper(inducing.chol_km)
    args = (kernel.log_ell.detach(), kernel.log_sf2.detach(), inducing.z,
            u_inv, t(sigma2), t(X), t(y), None if mask is None else t(mask))
    return kernel, inducing, args


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("n", [256, 300])  # divisible and padded
def test_twin_matches_pallas_kernel(rng, wrapper, n):
    """The Pallas kernel (interpret, f32) against the twin on the same f32
    inputs, at tests/test_pallas_stats.py's f32 tolerances: the twin runs
    in f64, as the scan does there."""
    X, y, Z, _ = _setup(rng, n=n)
    p = JSeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.1))
    u_inv = j_inv_tri_upper(j_calc_inducing(JSeIso, p, jnp.asarray(Z)).chol_km)
    # the f32 values the kernel computes on, given to both sides
    f32 = [np.asarray(a, np.float32) for a in (Z, u_inv, 0.4, X, y)]
    ref = getattr(jops, wrapper)(
        p.log_ell, p.log_sf2, *(jnp.asarray(a) for a in f32),
        block_size=64, interpret=True,
    )
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    out = getattr(tops, wrapper)(
        t(0.3), t(0.1), *(t(a) for a in f32),
        block_size=64, acc_dtype=torch.float64,
    )
    g, u, lds, yiy, isr, cnt = (o.numpy() for o in out)
    np.testing.assert_allclose(g, np.asarray(ref[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u, np.asarray(ref[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lds, float(ref[2]), rtol=1e-5)
    np.testing.assert_allclose(yiy, float(ref[3]), rtol=1e-4)
    np.testing.assert_allclose(isr, float(ref[4]), rtol=1e-4)
    assert int(cnt) == n


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("n,masked", [(256, 0), (300, 0), (300, 37)])
def test_twin_matches_scan_f64(rng, wrapper, n, masked):
    """f64 twin == JAX stream_stats(grad_impl="ad") at 1e-11, for divisible
    and padded n and with an explicit mask.  The absolute floor scales with
    each output's largest entry: small Gram entries are differences of
    large products."""
    X, y, Z, mask = _setup(rng, n=n, m=37, masked=masked)
    p = JSeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.1))
    jind = j_calc_inducing(JSeIso, p, jnp.asarray(Z))
    ref = j_stream_stats(
        JSeIso, p, jind, jnp.asarray(0.4), jnp.asarray(X), jnp.asarray(y),
        block_size=64, grad_impl="ad",
        mask=None if mask is None else jnp.asarray(mask),
    )
    _, _, args = _torch_args(X, y, Z, mask, torch.float64)
    out = getattr(tops, wrapper)(*args, block_size=64,
                                 acc_dtype=torch.float64)
    for name, o in zip(FIELDS, out):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(o.numpy(), want, rtol=1e-11,
                                   atol=1e-11 * np.abs(want).max(),
                                   err_msg=name)
    assert int(out[-1]) == n - masked


def test_compensated_f32_twin_matches_f64(rng):
    """With f32 accumulators the twin carries (hi, lo) pairs: over 2048
    one-row blocks its f32 scalars keep the per-term rounding only (about
    1e-7), where a plain f32 running sum drifts by about sqrt(2048) ulps."""
    X, y, Z, _ = _setup(rng, n=2048, m=8)
    _, _, a32 = _torch_args(X, y, Z, None, torch.float32)
    a64 = [a.double() for a in a32[:-1]] + [None]  # the same f32 values
    comp = tops.se_iso_stream_stats_fused_acc(*a32, block_size=1,
                                              acc_dtype=torch.float32)
    ref = tops.se_iso_stream_stats_fused_acc(*a64, block_size=1,
                                             acc_dtype=torch.float64)
    for c, r in zip(comp[2:5], ref[2:5]):
        np.testing.assert_allclose(float(c), float(r), rtol=5e-7)


def test_kernel_impls_refuse_cpu_tensors(rng):
    X, y, Z, _ = _setup(rng, n=64)
    kernel, inducing, args = _torch_args(X, y, Z, None, torch.float64)
    for impl in ("fused_acc", "fused"):
        with pytest.raises(ValueError, match="CUDA"):
            stream_stats(kernel, inducing, args[4], args[5], args[6],
                         impl=impl)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            streaming_log_evidence(kernel, args[2], args[4], args[5],
                                   args[6], impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        stream_stats(kernel, inducing, args[4], args[5], args[6],
                     impl="pallas")


def test_kernel_impls_refuse_autograd(rng):
    """No autograd through the kernels: their gradient is the hand VJP, so a
    kernel impl with grad_impl="ad" raises, while grad_impl="custom" (the
    default) takes a tensor that requires grad (and here only trips on the
    CPU tensors)."""
    X, y, Z, _ = _setup(rng, n=64)
    kernel, _, args = _torch_args(X, y, Z, None, torch.float64)
    for impl in ("fused_acc", "fused"):
        with pytest.raises(ValueError, match="grad_impl='custom'"):
            streaming_log_evidence(kernel, args[2], args[4], args[5],
                                   args[6], impl=impl, grad_impl="ad")
        with pytest.raises(ValueError, match="CUDA"):
            streaming_log_evidence(kernel, args[2], args[4], args[5],
                                   args[6], impl=impl)
    with pytest.raises(ValueError, match="unknown grad_impl"):
        streaming_log_evidence(kernel, args[2], args[4], args[5], args[6],
                               grad_impl="pallas")


def test_launch_counters_stay_zero_on_cpu(rng):
    X, y, Z, _ = _setup(rng, n=100)
    _, _, args = _torch_args(X, y, Z, None, torch.float64)
    before = [getattr(tops, w).launches for w in WRAPPERS]
    for w in WRAPPERS:
        getattr(tops, w)(*args, block_size=64, acc_dtype=torch.float64)
    assert [getattr(tops, w).launches for w in WRAPPERS] == before == [0, 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("n,masked,m", [(4096, 0, 300), (1000, 37, 37),
                                         (4096, 0, 64), (1000, 37, 65),
                                         (4096, 100, 129), (4096, 0, 383),
                                         (4096, 0, 400), (1000, 37, 1000)])
def test_cuda_kernel_matches_twin(rng, cuda_device, wrapper, n, masked, m):
    """The f32 kernel against the f64 twin on the same (f32) inputs: the
    tiled route at G = 1, 2, 3, 5 and 6 column groups, the wide route at
    m = 400 (64-row tiles) and 1,000 (48-row tiles)."""
    X, y, Z, mask = _setup(rng, n=n, d=8, m=m, masked=masked)
    f32 = np.float32
    X, y, Z = X.astype(f32), y.astype(f32), Z.astype(f32)
    _, _, args = _torch_args(X, y, Z, mask, torch.float32)
    dev = [None if a is None else a.to(cuda_device).contiguous()
           for a in args]
    ref = [None if a is None else a.double() for a in dev]
    fn = getattr(tops, wrapper)
    before = fn.launches
    out = fn(*dev, block_size=1024, acc_dtype=torch.float64)
    assert fn.launches == before + 1
    want = tops._se_iso_stats_reference(*ref, block_size=1024,
                                        acc_dtype=torch.float64)
    for name, o, w in zip(FIELDS, out, want):
        err = float(torch.linalg.norm(o - w) / torch.linalg.norm(w))
        assert err <= (1e-4 if o.ndim else 1e-5), (name, err)


def test_vg_from_v_is_the_twins_vg(rng):
    """The identity the backward kernel's tiled route rests on: VG = Knm
    (U^-1 Gs) = (Knm U^-1) Gs = V Gs with Gs = G-bar + G-bar', so the kernel
    forms VG from V and the wrapper need not form U^-1 Gs.  In f64 the two
    orders agree to 1e-10."""
    from gpr_tpu_torch.numerics.linalg import matmul

    X, y, Z, _ = _setup(rng, n=256, d=3, m=37)
    kernel, _, args = _torch_args(X, y, Z, None, torch.float64)
    u_inv, x_t = args[3], args[5]
    gbar = torch.as_tensor(rng.standard_normal((37, 37)))
    gsym = gbar + gbar.T
    with torch.no_grad():
        knm = kernel.k_cross(x_t, args[2])
        left = matmul(matmul(knm, u_inv), gsym).numpy()
        right = matmul(knm, matmul(u_inv, gsym)).numpy()
    np.testing.assert_allclose(left, right, rtol=1e-10,
                               atol=1e-10 * np.abs(right).max())


def _bwd_case(rng, cuda_device, n, m, masked, d=8):
    """Kernel inputs on the card (f32), their f64 copies, and seeded
    cotangents of the evidence's magnitudes."""
    X, y, Z, mask = _setup(rng, n=n, d=d, m=m, masked=masked)
    f32 = np.float32
    _, _, args = _torch_args(X.astype(f32), y.astype(f32), Z.astype(f32),
                             mask, torch.float32)
    dev = [None if a is None else a.to(cuda_device).contiguous()
           for a in args]
    cot = [torch.as_tensor(c, dtype=torch.float32, device=cuda_device)
           for c in (1e-3 * rng.standard_normal((m, m)),
                     1e-2 * rng.standard_normal(m), -0.5, -0.4, -0.3)]
    as64 = lambda ts: [None if t is None else t.double() for t in ts]  # noqa: E731
    return dev, cot, as64(dev), as64(cot)


@pytest.mark.cuda
def test_cuda_bwd_kernel_matches_twin(rng, cuda_device):
    """The f32 backward kernel against the f64 twin on the same (f32)
    inputs: the tiled route at G = 1, 2, 3 and 5 column groups (m = 320 its
    last), the wide route at m = 336 and 400 (32-row tiles) and 1,000 at
    d = 20 (24; at d = 8 even the f32 twin's z-bar lies 2e-3 from the f64
    twin's), with and without a mask and y_bar; m = 3,000 fits no route
    and raises."""
    fn = tops.se_iso_stream_bwd_fused
    for n, masked, m, need_y, d in [
            (4096, 0, 64, True, 8), (1000, 37, 65, True, 8),
            (4096, 100, 129, False, 8), (4096, 0, 300, True, 8),
            (1000, 37, 320, True, 8), (4096, 0, 336, True, 8),
            (1000, 37, 400, False, 8), (2048, 0, 1000, True, 20)]:
        dev, cot, ref, cot64 = _bwd_case(rng, cuda_device, n, m, masked, d)
        before = fn.launches
        out = fn(*dev, *cot, block_size=1024, acc_dtype=torch.float64,
                 need_y=need_y)
        assert fn.launches == before + 1
        want = tops._se_iso_bwd_reference(
            *ref, *cot64, block_size=1024, acc_dtype=torch.float64,
            need_y=need_y)
        assert (out[-1] is None) == (not need_y)
        for i, (o, w) in enumerate(zip(out, want)):
            if o is None:
                continue
            if i == 3:  # the kernel keeps the upper triangle only
                o, w = o.triu(), w.triu()
            err = float(torch.linalg.norm(o - w) / torch.linalg.norm(w))
            assert err <= 1e-4, (m, i, err)
    dev, cot, _, _ = _bwd_case(rng, cuda_device, 256, 3000, 0)
    with pytest.raises(ValueError, match="shared memory"):
        fn(*dev, *cot, block_size=1024)


@pytest.mark.cuda
def test_cuda_any_positive_block_size(rng, cuda_device):
    """On CUDA tensors ``block_size`` sets neither the grid nor anything
    else: every wrapper takes any positive block, not only a multiple of
    the kernels' 64-row tile, and returns what it returns at 64 (the
    streaming path's default route sends any block to the kernels);
    a block that is not positive raises."""
    dev, cot, _, _ = _bwd_case(rng, cuda_device, 256, 37, 0)
    want_bwd = tops.se_iso_stream_bwd_fused(*dev, *cot, block_size=64)
    want = {name: getattr(tops, name)(*dev, block_size=64)
            for name in WRAPPERS}
    for odd in (32, 96, 100, 1000):
        got = tops.se_iso_stream_bwd_fused(*dev, *cot, block_size=odd)
        assert all(torch.equal(g, w) for g, w in zip(got, want_bwd)), odd
        for name in WRAPPERS:
            got = getattr(tops, name)(*dev, block_size=odd)
            assert all(torch.equal(g, w)
                       for g, w in zip(got, want[name])), (name, odd)
    for bad in (0, -64):
        with pytest.raises(ValueError, match="positive"):
            tops.se_iso_stream_bwd_fused(*dev, *cot, block_size=bad)
        for name in WRAPPERS:
            with pytest.raises(ValueError, match="positive"):
                getattr(tops, name)(*dev, block_size=bad)
    assert want_bwd[2].shape == (37, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,block,kernels", [(300, 8, 1000, True),
                                               (300, 8, 8192, True),
                                               (400, 8, 8192, True),
                                               (1000, 20, 8192, True),
                                               (3000, 8, 8192, False)])
def test_cuda_default_route(rng, cuda_device, m, d, block, kernels):
    """streaming_log_evidence with impl=None on f32 CUDA tensors launches
    kernels #1 and #3 where both fit the card (at any block, m up to 2,880
    at d = 8) and neither past that; its value and gradients equal the
    plain loop's, to f32 rounding on the kernels and to the bit on the
    loop.  Without a gradient #1 alone launches, m = 3,000 too."""
    X, y, Z, _ = _setup(rng, n=4096, d=d, m=m)
    f32 = np.float32
    t = lambda a: torch.as_tensor(a.astype(f32), device=cuda_device)  # noqa: E731
    jitter = 1e-6 if m <= 1000 else 1e-3  # Km of 3,000 points needs more

    def value_and_grad(impl):
        kernel = SeIso(0.3, 0.1, device=cuda_device, dtype=torch.float32)
        z = t(Z).requires_grad_(True)
        s2 = torch.tensor(0.4, device=cuda_device, requires_grad=True)
        val = streaming_log_evidence(kernel, z, s2, t(X), t(y), impl=impl,
                                     block_size=block, jitter=jitter)
        return val, torch.autograd.grad(val, (kernel.log_ell,
                                              kernel.log_sf2, z, s2))

    fwd, bwd = tops.se_iso_stream_stats_fused_acc, tops.se_iso_stream_bwd_fused
    before = (fwd.launches, bwd.launches)
    with torch.no_grad():
        served = streaming_log_evidence(
            SeIso(0.3, 0.1, device=cuda_device, dtype=torch.float32), t(Z),
            0.4, t(X), t(y), block_size=block, jitter=jitter)
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (1, 0)
    assert bool(torch.isfinite(served))
    before = (fwd.launches, bwd.launches)
    val, grads = value_and_grad(None)
    launched = (fwd.launches - before[0], bwd.launches - before[1])
    assert launched == ((1, 1) if kernels else (0, 0))
    want, want_grads = value_and_grad("reference")
    if not kernels:
        assert torch.equal(val, want)
        assert all(torch.equal(g, w) for g, w in zip(grads, want_grads))
        return
    assert abs(float(val.detach() - want.detach())) <= 2e-5 * abs(float(
        want.detach()))
    for g, w in zip(grads, want_grads):
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= 1e-3


def test_build_is_keyed_by_sources_and_failure_raises(tmp_path, monkeypatch):
    """An edited source, or an edited header it includes, gets a new
    library; a failed build raises with the compiler's output, and nothing
    falls back to the plain twin."""
    from gpr_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    headers = [p.name for p in _build._CSRC.glob("*.cuh")]
    assert "fp32_tile.cuh" in headers
    for name in (*_build.SOURCES, *headers):
        (csrc / name).write_text((_build._CSRC / name).read_text())
    src = (csrc / "se_iso_stats.cu").read_text()
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "_build")
    first = _build.library_path()
    (csrc / "se_iso_stats.cu").write_text(src + "\n// edited\n")
    second = _build.library_path()
    assert second != first
    header = csrc / "fp32_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() not in (first, second)

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.load_library()
    assert not _build.library_path().exists()
