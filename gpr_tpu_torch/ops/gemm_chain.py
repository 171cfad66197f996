"""A chain of f32 matrix products, ``x @ w @ w ... @ w`` (``reps`` times).

The counterpart of ``k_chain`` in ``probes/r3_roofline_probe.py``, the
roofline probe's speed-of-light kernel: the intermediate product never
leaves the SM.  A CUDA tensor goes to the hand-written kernel of
``csrc/gemm_chain.cu`` (plain f32 FMA, a register-tiled product loop fed by
a ``cp.async`` ring of W and x slices); a CPU tensor goes to the plain twin
:func:`_gemm_chain_reference`, which also serves f64 on the card when called
directly.  There is no fallback between the two: a CUDA tensor the kernel
does not take raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics.linalg import matmul
from ._build import load_library

# The kernel's launch geometry; csrc/gemm_chain.cu holds the same constants.
ROWS = 64  # rows per tile (one CTA's 8 warps x 8 rows)
GROUP = 64  # columns per group: 2 a lane
MAX_GROUPS = 6  # the kernel is instantiated for G = 1..6
MAX_M = GROUP * MAX_GROUPS
BK = 16  # k per slice (W rows, x columns)
STAGES = 3  # stages of the cp.async ring (a W slice and an x slice)
A_STRIDE = ROWS + 4  # floats per k-row of the tile and of an x slice


class Geometry(NamedTuple):
    groups: int  # G = ceil(m / 64): the kernel's instantiation
    width: int  # padded columns, 64 G
    smem_bytes: int  # dynamic shared memory of one CTA
    n_tiles: int  # 64-row tiles
    n_ctas: int  # CTAs launched: one per SM, at most one per tile


def _geometry(n: int, m: int, sm_count: int) -> Geometry:
    """The kernel's launch for x (n, m) on a device of ``sm_count`` SMs."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m={m}: the gemm_chain kernel takes 1 <= m <= "
                         f"{MAX_M} columns (use _gemm_chain_reference)")
    groups = -(-m // GROUP)
    width = GROUP * groups
    smem = 4 * (width * A_STRIDE + STAGES * BK * (width + A_STRIDE))
    n_tiles = -(-n // ROWS)
    return Geometry(groups, width, smem, n_tiles, min(sm_count, n_tiles))


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

    On CUDA one launch; CTAs (one per SM) stride over 64-row tiles, each
    tile's products stay on the SM.  m above 384, or a shared-memory need
    (187 KB at m = 384) the device cannot meet, raises.
    """
    _check(x, w, reps)
    if not x.is_cuda:
        return _gemm_chain_reference(x, w, reps)
    lib = load_library()
    n, m = x.shape
    props = torch.cuda.get_device_properties(x.device)
    geo = _geometry(n, m, props.multi_processor_count)
    if geo.smem_bytes > props.shared_memory_per_block_optin:
        raise ValueError(
            f"m={m} needs {geo.smem_bytes} bytes of shared memory per block; "
            f"the device allows {props.shared_memory_per_block_optin}"
        )
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.gemm_chain(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, m,
                             reps, geo.n_ctas, stream)
    if err != 0:
        raise RuntimeError(
            f"gemm_chain kernel launch failed: "
            f"{lib.se_iso_stats_error_string(err).decode()} ({err})"
        )
    gemm_chain.launches += 1
    return out


gemm_chain.launches = 0
