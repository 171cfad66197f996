"""The GEMM-chain wrapper of gpr_tpu_torch.ops == the roofline probe's
``k_chain`` (probes/r3_roofline_probe.py, leg 1).

``k_chain`` is local to the probe's ``main()``, so its body is rebuilt here
as the probe builds it: ``acc = x; repeat reps: acc = _dot3(acc, w)`` over
a grid of row blocks, with ``_dot3``'s exact f32 contraction
(``precise=True``) and the kernel interpreted on the CPU.  The CUDA kernel
itself is held against the twin by the test marked ``cuda`` and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gpr_tpu.ops.fused_stats import _dot3
from gpr_tpu_torch.ops import gemm_chain
from gpr_tpu_torch.ops.gemm_chain import (
    MAX_M,
    _gemm_chain_reference,
    _geometry,
)

B = 64  # the probe's row block, cut to test size


def _k_chain(xs, w, reps):
    """The probe's leg-1 pallas_call, interpreted."""
    nb, mp = xs.shape[0] // B, xs.shape[1]

    def k_chain(x_ref, w_ref, o_ref):
        acc = x_ref[:]
        for _ in range(reps):
            acc = _dot3(acc, w_ref[:], (((1,), (0,)), ((), ())), True)
        o_ref[:] = acc

    run = pl.pallas_call(
        k_chain,
        grid=(nb,),
        in_specs=[pl.BlockSpec((B, mp), lambda i: (i, 0)),
                  pl.BlockSpec((mp, mp), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((B, mp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((nb * B, mp), jnp.float32),
        interpret=True,
    )
    return np.asarray(run(xs, w))


def _inputs(m, nb=3, seed=0):
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((nb * B, m)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((m, m)) * 0.05).astype(np.float32)
    return xs, w


@pytest.mark.parametrize("m", [128, 384])
@pytest.mark.parametrize("reps", [1, 4])
def test_twin_matches_pallas_k_chain(m, reps):
    """f32 on both sides: 1e-5 relative (Frobenius and per entry)."""
    xs, w = _inputs(m)
    want = _k_chain(jnp.asarray(xs), jnp.asarray(w), reps)
    got = _gemm_chain_reference(torch.as_tensor(xs), torch.as_tensor(w),
                                reps).numpy()
    assert got.dtype == np.float32
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_wrapper_runs_the_twin_on_cpu_and_counts_nothing():
    xs, w = _inputs(40, nb=1)
    before = gemm_chain.launches
    got = gemm_chain(torch.as_tensor(xs).double(),
                     torch.as_tensor(w).double(), 3)
    want = xs.astype(np.float64) @ w @ w @ w
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert gemm_chain.launches == before == 0


def test_wrapper_checks_its_inputs():
    x, w = torch.zeros(10, 6), torch.zeros(6, 6)
    with pytest.raises(ValueError, match="reps"):
        gemm_chain(x, w, 0)
    with pytest.raises(ValueError, match="reps"):
        gemm_chain(x, w, 2.0)
    with pytest.raises(ValueError, match="expected x"):
        gemm_chain(x, torch.zeros(5, 6), 1)
    with pytest.raises(ValueError, match="expected x"):
        gemm_chain(x[None], w, 1)
    with pytest.raises(ValueError, match="on meta"):
        gemm_chain(x, w.to("meta"), 1)


@pytest.mark.parametrize("m,groups,width", [(1, 1, 64), (37, 1, 64),
                                             (64, 1, 64), (65, 2, 128),
                                             (129, 3, 192), (300, 5, 320),
                                             (384, 6, 384)])
def test_geometry_pads_m_to_whole_column_groups(m, groups, width):
    """G = ceil(m / 64) picks the kernel's instantiation; the padded width
    is 64 G (300 pads to 320, not to the largest width)."""
    geo = _geometry(1000, m, 132)
    assert (geo.groups, geo.width) == (groups, width)


def test_geometry_shared_memory_fits_one_block_for_every_m():
    """A tile of the left operand plus three ring stages fit the 232,448
    bytes a block may opt into on Hopper, for every m the kernel takes, and
    grow with G only."""
    smem = [_geometry(1, m, 132).smem_bytes for m in range(1, MAX_M + 1)]
    assert max(smem) == smem[-1] == 191_232 <= 232_448
    assert smem == sorted(smem)
    assert len(set(smem)) == 6
    assert _geometry(1, 300, 132).smem_bytes == 4 * (320 * 68 + 3 * 16 * (
        320 + 68))


@pytest.mark.parametrize("m", [0, MAX_M + 1, 1000])
def test_geometry_refuses_m_outside_the_kernel(m):
    with pytest.raises(ValueError, match=f"m={m}: the gemm_chain kernel "
                                         f"takes 1 <= m <= 384"):
        _geometry(1000, m, 132)


@pytest.mark.parametrize("n,sms,tiles,ctas", [(1, 132, 1, 1),
                                              (64, 132, 1, 1),
                                              (65, 132, 2, 2),
                                              (100_003, 132, 1563, 132),
                                              (999_424, 132, 15_616, 132),
                                              (999_424, 114, 15_616, 114)])
def test_geometry_launches_one_cta_per_sm_and_no_idle_cta(n, sms, tiles,
                                                          ctas):
    geo = _geometry(n, 384, sms)
    assert (geo.n_tiles, geo.n_ctas) == (tiles, ctas)
    assert geo.n_ctas <= geo.n_tiles


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,reps", [(4096, 384, 4), (1001, 300, 3),
                                      (31, 37, 1), (100_003, 64, 2),
                                      (100_003, 65, 3), (100_003, 129, 4)])
def test_cuda_kernel_matches_twin(cuda_device, n, m, reps):
    """The f32 kernel against the f64 twin on the same inputs (ragged row
    tiles, column groups and k slices included), one launch; f64 and
    non-contiguous inputs raise."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(n, m, device=cuda_device, generator=g) * 0.1
    w = torch.randn(m, m, device=cuda_device, generator=g) * 0.05
    before = gemm_chain.launches
    got = gemm_chain(x, w, reps)
    torch.cuda.synchronize()
    assert gemm_chain.launches == before + 1
    want = _gemm_chain_reference(x.double(), w.double(), reps)
    err = float(torch.linalg.norm(got.double() - want)
                / torch.linalg.norm(want))
    assert err <= 1e-5, err
    with pytest.raises(TypeError, match="float32"):
        gemm_chain(x.double(), w.double(), reps)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_chain(w.mT, w, reps)  # an (m, m) x, transposed in place
