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
from gpr_tpu_torch.ops.gemm_chain import _gemm_chain_reference

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,reps", [(4096, 384, 4), (1001, 300, 3),
                                      (31, 37, 1)])
def test_cuda_kernel_matches_twin(cuda_device, n, m, reps):
    """The f32 kernel against the f64 twin on the same inputs (tail tiles
    and a panel tail included), one launch; f64 and CPU-w inputs raise."""
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
