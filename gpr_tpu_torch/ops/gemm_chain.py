"""A chain of f32 matrix products, ``x @ w @ w ... @ w`` (``reps`` times).

The counterpart of ``k_chain`` in ``probes/r3_roofline_probe.py``, the
roofline probe's speed-of-light kernel: the intermediate product never
leaves the SM.  A CUDA tensor goes to the hand-written kernel of
``csrc/gemm_chain.cu`` (plain f32 FMA, the backward kernel's product loop);
a CPU tensor goes to the plain twin :func:`_gemm_chain_reference`, which
also serves f64 on the card when called directly.  There is no fallback
between the two: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import torch

from ..numerics.linalg import matmul
from ._build import load_library


@torch.no_grad()
def _gemm_chain_reference(x: torch.Tensor, w: torch.Tensor,
                          reps: int) -> torch.Tensor:
    """Plain PyTorch twin: ``reps`` matrix products in the inputs' dtype."""
    acc = x
    for _ in range(reps):
        acc = matmul(acc, w)
    return acc


def _check(x, w, reps):
    """Shapes, reps and devices for both routes; dtype and layout for the
    kernel's."""
    if not isinstance(reps, int) or reps < 1:
        raise ValueError(f"reps must be a positive int, got {reps!r}")
    if x.ndim != 2 or tuple(w.shape) != (x.shape[1], x.shape[1]):
        raise ValueError(f"expected x (n, m) and w (m, m), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not x.is_cuda:
        return
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError("x has no rows or no columns")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype} (the twin _gemm_chain_reference "
                            f"takes any dtype)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


@torch.no_grad()
def gemm_chain(x: torch.Tensor, w: torch.Tensor, reps: int) -> torch.Tensor:
    """``x @ w`` applied ``reps`` times: x (n, m), w (m, m), float32.

    On CUDA one launch; CTAs (one per SM) stride over 32-row tiles, each
    tile's products stay in shared memory.  The kernel's shared memory grows
    with m (192 KB at m = 384); an m the device cannot hold raises.
    """
    _check(x, w, reps)
    if not x.is_cuda:
        return _gemm_chain_reference(x, w, reps)
    lib = load_library()
    n, m = x.shape
    props = torch.cuda.get_device_properties(x.device)
    smem = lib.gemm_chain_smem_bytes(m)
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(
            f"m={m} needs {smem} bytes of shared memory per block; the "
            f"device allows {props.shared_memory_per_block_optin}"
        )
    out = torch.empty_like(x)
    n_ctas = min(props.multi_processor_count, -(-n // 32))  # 32-row tiles
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.gemm_chain(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, m,
                             reps, n_ctas, stream)
    if err != 0:
        raise RuntimeError(
            f"gemm_chain kernel launch failed: "
            f"{lib.se_iso_stats_error_string(err).decode()} ({err})"
        )
    gemm_chain.launches += 1
    return out


gemm_chain.launches = 0
