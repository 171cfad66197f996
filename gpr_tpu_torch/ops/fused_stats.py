"""Fused forward statistics of the streaming SE-iso evidence.

The counterpart of ``gpr_tpu/ops/fused_stats.py``.  For rows X (masked by
``mask``) and inducing points z, with V = Knm U^-1 and is = mask / s, both
entries return

    (G, u, sum log s, y' diag(is) y, sum is r, n_live)
    G = (V sqrt(is))' (V sqrt(is)),   u = V' (is y)

as ``models/streaming.py``'s ``StreamStats`` fields, and nothing n x m ever
reaches device memory.

Each entry is a thin wrapper.  A CUDA tensor goes to the hand-written
kernel of ``csrc/se_iso_stats.cu`` (f32 compute, built at first use by
``ops/_build.py``); a CPU tensor goes to the plain twin
:func:`_se_iso_stats_reference`, in the inputs' own dtype.  There is no
fallback between the two: a CUDA launch that fails raises.

``block_size`` is the number of rows reduced into one partial: one loop
block of the twin, one CTA of the kernel (a multiple of the kernel's
64-row tile).  Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from ..kernels.se_iso import SeIso
from ..models.stream_grad import _forward_scan
from ..models.streaming import _pad_blocks
from ._build import load_library

_BLK = 8  # edge of the kernel's Gram register blocks (csrc kBlk)


@torch.no_grad()
def _se_iso_stats_reference(log_ell, log_sf2, z, u_inv, sigma2, X, y,
                            mask=None, *, block_size, acc_dtype):
    """Plain PyTorch twin of both kernels: the blocked loop of
    ``models/stream_grad._forward_scan`` in the dtype of ``z``."""
    kernel = SeIso(log_ell, log_sf2, device=z.device, dtype=z.dtype)
    xb, yb, maskb = _pad_blocks(X, y, mask, block_size)
    return _forward_scan(kernel, z, u_inv, sigma2, xb, yb, maskb, acc_dtype)


def _check(name, t, shape):
    if not t.is_cuda or t.dtype != torch.float32:
        raise TypeError(f"{name}: expected a float32 CUDA tensor, got "
                        f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _unpack_gram(blocks, m):
    """(nblk, 8, 8) upper blocks of the (mp, mp) Gram of [V w | w y], in
    the kernel's row-major upper-triangle order, to (G, u)."""
    nb8 = -(-(m + 1) // _BLK)
    bi, bj = torch.triu_indices(nb8, nb8, device=blocks.device)
    full = torch.zeros(nb8, nb8, _BLK, _BLK, dtype=blocks.dtype,
                       device=blocks.device)
    full[bj, bi] = blocks.mT
    full[bi, bj] = blocks
    full = full.permute(0, 2, 1, 3).reshape(nb8 * _BLK, nb8 * _BLK)
    return full[:m, :m], full[:m, m]


def _launch(entry, comp, log_ell, log_sf2, z, u_inv, sigma2, X, y, mask,
            block_size, acc_dtype):
    lib = load_library()
    n, d = X.shape
    m = z.shape[0]
    _check("X", X, (n, d))
    _check("y", y, (n,))
    _check("z", z, (m, d))
    _check("u_inv", u_inv, (m, m))
    if mask is not None:
        _check("mask", mask, (n,))
    if n == 0:
        raise ValueError("X has no rows")
    rows = lib.se_iso_stats_rows_per_tile()
    if block_size <= 0 or block_size % rows:
        raise ValueError(
            f"block_size must be a positive multiple of {rows} on CUDA, got "
            f"{block_size}"
        )
    smem = lib.se_iso_stats_smem_bytes(m, d)
    smem_max = torch.cuda.get_device_properties(
        X.device).shared_memory_per_block_optin
    if smem > smem_max:
        raise ValueError(
            f"m={m}, d={d} needs {smem} bytes of shared memory per block; "
            f"the device allows {smem_max}"
        )
    tiles_per_cta = block_size // rows
    n_ctas = -(-n // block_size)
    nb8 = -(-(m + 1) // _BLK)
    nblk = nb8 * (nb8 + 1) // 2
    pairs = 2 if comp else 1
    gram_part = torch.empty(n_ctas, pairs, nblk, _BLK, _BLK,
                            dtype=torch.float32, device=X.device)
    sums_part = torch.empty(n_ctas, 2, 4, dtype=torch.float32,
                            device=X.device)
    # the kernel takes [-1/(2 ell^2), log sf2, sigma2] by value: one sync
    log_ell, log_sf2, sigma2 = (
        torch.as_tensor(t, device=X.device).detach()
        for t in (log_ell, log_sf2, sigma2)
    )
    q, lsf2, s2 = torch.stack([
        -0.5 * torch.exp(-2.0 * log_ell), log_sf2, sigma2,
    ]).to(torch.float32).tolist()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        err = getattr(lib, entry)(
            X.data_ptr(), y.data_ptr(),
            None if mask is None else mask.data_ptr(),
            z.data_ptr(), u_inv.data_ptr(), n, d, m, q, lsf2, s2,
            n_ctas, tiles_per_cta, gram_part.data_ptr(),
            sums_part.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"se_iso_stats kernel launch failed: "
            f"{lib.se_iso_stats_error_string(err).decode()} ({err})"
        )
    # the cross-CTA reduce in f64 (hi + lo folded first): deterministic
    blocks = gram_part.to(torch.float64).sum(dim=(0, 1))
    gram, u_vec = _unpack_gram(blocks, m)
    sums = sums_part.to(torch.float64).sum(dim=(0, 1))
    return (gram.to(acc_dtype), u_vec.to(acc_dtype),
            *(s.to(acc_dtype) for s in sums.unbind()))


def se_iso_stream_stats_fused_acc(log_ell, log_sf2, z, u_inv, sigma2, X, y,
                                  mask=None, *, block_size=8192,
                                  acc_dtype=torch.float32):
    """Single-pass fused statistics with compensated in-kernel accumulation.

    On CUDA every CTA walks its ``block_size`` rows in 64-row tiles and
    carries G, u and the four scalars as two-sum (hi, lo) pairs; the
    wrapper folds and sums the per-CTA partials in f64 and returns them in
    ``acc_dtype``.  ``u_inv`` must be upper triangular (the inverse of the
    upper Cholesky factor): the kernel reads only that triangle.
    """
    if not X.is_cuda:
        return _se_iso_stats_reference(
            log_ell, log_sf2, z, u_inv, sigma2, X, y, mask,
            block_size=block_size, acc_dtype=acc_dtype,
        )
    out = _launch("se_iso_stats_acc", True, log_ell, log_sf2,
                  z, u_inv, sigma2, X, y, mask, block_size, acc_dtype)
    se_iso_stream_stats_fused_acc.launches += 1
    return out


def se_iso_stream_stats_fused(log_ell, log_sf2, z, u_inv, sigma2, X, y,
                              mask=None, *, block_size=8192,
                              acc_dtype=torch.float32):
    """Per-block partial statistics, summed outside the kernel in f64.

    The parity variant: each CTA adds its tiles' Gram plainly in f32 (the
    scalars stay compensated) and writes one partial per ``block_size``
    rows; the wrapper sums the partials in f64, as the JAX wrapper sums its
    per-tile partials, and returns them in ``acc_dtype``.  ``u_inv`` must be
    upper triangular.
    """
    if not X.is_cuda:
        return _se_iso_stats_reference(
            log_ell, log_sf2, z, u_inv, sigma2, X, y, mask,
            block_size=block_size, acc_dtype=acc_dtype,
        )
    out = _launch("se_iso_stats_partials", False, log_ell,
                  log_sf2, z, u_inv, sigma2, X, y, mask, block_size,
                  acc_dtype)
    se_iso_stream_stats_fused.launches += 1
    return out


se_iso_stream_stats_fused_acc.launches = 0
se_iso_stream_stats_fused.launches = 0
