"""Fused statistics of the streaming SE-iso evidence and their backward.

The counterpart of ``gpr_tpu/ops/fused_stats.py``.  For rows X (masked by
``mask``) and inducing points z, with V = Knm U^-1 and is = mask / s, both
forward entries return

    (G, u, sum log s, y' diag(is) y, sum is r, n_live)
    G = (V sqrt(is))' (V sqrt(is)),   u = V' (is y)

as ``models/streaming.py``'s ``StreamStats`` fields, and nothing n x m ever
reaches device memory.

Each entry is a thin wrapper.  A CUDA tensor goes to the hand-written
kernel of ``csrc/se_iso_stats.cu`` (f32 compute, built at first use by
``ops/_build.py``); a CPU tensor goes to the plain twin
:func:`_se_iso_stats_reference`, in the inputs' own dtype.  There is no
fallback between the two: a CUDA launch that fails raises.

``block_size`` is the number of rows of one loop block of the twin.  The
kernels take their grid from the device instead (:func:`_geometry` and
:func:`_bwd_geometry`: one CTA per SM) and do not read it.  Each wrapper
counts its kernel launches in ``.launches``.  :func:`default_route` is
where the streaming path's default takes the kernels: wherever they fit
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.se_iso import SeIso
from ..models.stream_grad import _backward_scan, _forward_scan, _pad_blocks
from ._build import load_library

_BLK = 8  # edge of the kernels' m x m register blocks (csrc kBlk)
# The kernels' launch geometry; csrc/se_iso_stats.cu, csrc/se_iso_bwd.cu,
# csrc/stats_tile.cuh and csrc/fp32_tile.cuh hold the same constants.
ROWS = 64  # rows per tile
GROUP = 64  # columns per group of the tiled route: 2 a lane
MAX_TILED_M = GROUP * 6 - 1  # G <= 6, and column m (u) in the last group
BK = 16  # U^-1 rows per ring slice
RING = 2  # stages of the tiled route's cp.async ring
A_STRIDE = ROWS + 4  # floats per k-row of the Knm tile
PANEL = 32  # the wide route's U^-1 panel width
CHUNK = 64  # U^-1 rows of such a panel a ring stage holds
WIDE_RING = 2  # stages of the wide route's U^-1 ring
WIDE_ROWS = (64, 48, 32, 24, 16, 8)  # the wide route's rows per tile, by preference
SMEM_OPTIN = 232_448  # bytes of shared memory a block may opt into (sm_90)
BWD_MAX_GROUPS = 5  # the backward tiled route: G = 6 never fits
BWD_WIDE_ROWS = (32, 24, 16, 8)  # the backward wide route's rows per tile
BWD_WIDE_PANEL = 128  # its products' panel width
BWD_CHUNK = 16  # weight rows of such a panel a ring stage holds
BWD_WIDE_RING = 3  # stages of its weight ring
L2_BYTES = 50 * 2 ** 20  # the H100's L2
BWD_MAX_SHARE = 4  # CTAs that take turns on one partial, at most


class Geometry(NamedTuple):
    groups: int  # G = ceil((m + 1) / 64) of the tiled route; 0: the wide route
    fold: bool  # the tiled route folds two tiles into each Gram update
    smem_bytes: int  # dynamic shared memory of one CTA
    n_tiles: int  # 64-row tiles
    n_ctas: int  # CTAs launched, each with at least one tile
    tiles_per_cta: int  # the wide route's contiguous chunk (the most a CTA takes)
    nblk: int  # upper 8 x 8 blocks of the (m + 1)-square Gram of [V w | w y]
    rows: int  # rows per tile


def _wide_rows(floats, choices):
    """The first of ``choices`` (rows per tile) whose shared memory,
    ``floats(rows)`` floats, fits; the last where none does."""
    for rows in choices:
        if 4 * floats(rows) <= SMEM_OPTIN:
            return rows
    return choices[-1]


def _geometry(n: int, m: int, d: int, sm_count: int) -> Geometry:
    """The forward kernels' route and launch for n rows, m inducing points
    and d inputs on a device of ``sm_count`` SMs.  The tiled route takes
    m <= 383 where its shared memory fits, and folds two tiles into each
    update of its Gram partial where a second row tile (B) fits too; the
    wide route every other m, with the most rows a tile (64, 48, 32, 24, 16
    or 8)
    whose shared memory fits: about m <= 5,980 at any d, and past that
    ``smem_bytes`` exceeds what the device allows (the wrapper raises).
    Both launch at most one CTA per SM."""
    nb8 = -(-(m + 1) // _BLK)
    nblk = nb8 * (nb8 + 1) // 2
    mp = nb8 * _BLK
    n_tiles = -(-n // ROWS)
    n_ctas = min(sm_count, n_tiles)
    groups = -(-(m + 1) // GROUP)
    width = GROUP * groups
    tiled = 4 * (width * A_STRIDE + RING * (BK * width + d * ROWS)
                 + d * width + width + 32)
    if m <= MAX_TILED_M and tiled <= SMEM_OPTIN:
        fold = tiled + 4 * ROWS * mp <= SMEM_OPTIN
        return Geometry(groups, fold, tiled + fold * 4 * ROWS * mp, n_tiles,
                        n_ctas, -(-n_tiles // n_ctas), nblk, ROWS)

    def wide(rows):  # the tile, the U^-1 ring, |z|^2, the x tile, w, wy, sums
        return (rows * mp + WIDE_RING * CHUNK * PANEL + mp + rows * d
                + 2 * rows + 32)

    rows = _wide_rows(wide, WIDE_ROWS)
    n_tiles = -(-n // rows)
    # contiguous chunks: every CTA must own a tile
    tiles_per_cta = -(-n_tiles // min(sm_count, n_tiles))
    return Geometry(0, False, 4 * wide(rows), n_tiles,
                    -(-n_tiles // tiles_per_cta), tiles_per_cta, nblk, rows)


class BwdGeometry(NamedTuple):
    groups: int  # G = ceil(m / 64) of the tiled route; 0: the wide route
    smem_bytes: int  # dynamic shared memory of one CTA
    n_tiles: int  # row tiles: 64 rows on the tiled route, 32 on the wide
    n_ctas: int  # CTAs launched, each with at least one tile
    tiles_per_cta: int  # the wide route's contiguous chunk
    nblk: int  # upper 8 x 8 blocks of the m-square U^-1 cotangent
    share: int  # CTAs that take turns on one partial of that cotangent
    n_parts: int  # such partials: ceil(n_ctas / share)
    rows: int  # rows per tile


def _bwd_geometry(n: int, m: int, d: int, sm_count: int,
                  l2_bytes: int = L2_BYTES) -> BwdGeometry:
    """The backward kernel's route and launch for n rows, m inducing points
    and d inputs on a device of ``sm_count`` SMs and ``l2_bytes`` of L2.
    The tiled route takes G = ceil(m / 64) <= 5 where its shared memory
    fits (m <= 320 at d = 8): the k-major tile A, the row-major tile R, two
    ring slices, two x tiles, Z', |z|^2, u-bar, three row vectors and the
    warp sums.  Its CTAs read and write back their hi/lo partial of the
    U^-1 cotangent on every tile, so the fewest neighbouring CTAs (1, 2 or
    4) share one partial that make all partials fit in a quarter of the L2:
    4 at m = 300 on 132 SMs and 50 MiB (8 measured slower than 1: the CTAs
    wait for their turns).  The wide route takes every other m, one partial
    a CTA, with the most rows a tile (32, 24, 16 or 8) whose two tiles fit:
    about m <= 2,870 at any d, and past that ``smem_bytes`` exceeds what
    the device allows (the wrapper raises).  Both launch at most one CTA
    per SM."""
    nb8 = -(-m // _BLK)
    nblk = nb8 * (nb8 + 1) // 2
    mp = nb8 * _BLK
    groups = -(-m // GROUP)
    width = GROUP * groups
    tiled = 4 * (width * A_STRIDE + ROWS * mp + RING * BK * width
                 + 2 * d * ROWS + d * width + 2 * width + 3 * ROWS + 16)
    if groups <= BWD_MAX_GROUPS and tiled <= SMEM_OPTIN:
        n_tiles = -(-n // ROWS)
        n_ctas = min(sm_count, n_tiles)
        part_bytes = 2 * 4 * _BLK * _BLK * nblk
        share = 1
        while (share < BWD_MAX_SHARE
               and -(-n_ctas // share) * part_bytes > l2_bytes // 4):
            share *= 2
        return BwdGeometry(groups, tiled, n_tiles, n_ctas,
                           -(-n_tiles // n_ctas), nblk, share,
                           -(-n_ctas // share), ROWS)

    def wide(rows):  # two tiles, the weight ring, |z|^2 and u-bar, the x
        return (2 * rows * mp + BWD_WIDE_RING * BWD_CHUNK * BWD_WIDE_PANEL
                + 2 * mp + rows * d + 4 * rows + 16)  # tile, 4 row vectors

    rows = _wide_rows(wide, BWD_WIDE_ROWS)
    n_tiles = -(-n // rows)
    # contiguous chunks: every CTA must own a tile
    tiles_per_cta = -(-n_tiles // min(sm_count, n_tiles))
    n_ctas = -(-n_tiles // tiles_per_cta)
    return BwdGeometry(0, 4 * wide(rows), n_tiles, n_ctas, tiles_per_cta,
                       nblk, 1, n_ctas, rows)


def _fits(props, smem):
    """Whether ``smem`` bytes of shared memory a block fit the device."""
    return smem <= props.shared_memory_per_block_optin


def default_route(m: int, d: int, dtype, props, *, grad: bool = True) -> str:
    """The streaming statistics' implementation for an SE-iso model with m
    inducing points over d inputs, in ``dtype``, on a CUDA device of
    properties ``props`` (``torch.cuda.get_device_properties``, or any
    object with ``multi_processor_count``, ``L2_cache_size`` and
    ``shared_memory_per_block_optin``): ``"fused_acc"``, kernel #1 and,
    when ``grad`` (a gradient will be taken), #3, where the dtype is f32
    and the shared memory of the forward's route (:func:`_geometry`) and,
    when ``grad``, of the backward's (:func:`_bwd_geometry`) fits the
    device, else ``"reference"``, the plain loop.  Neither depends on the
    rows or the block size, so neither does the route."""
    if dtype != torch.float32:
        return "reference"
    sm = props.multi_processor_count
    fits = _fits(props, _geometry(1, m, d, sm).smem_bytes) and (
        not grad or _fits(props, _bwd_geometry(
            1, m, d, sm, props.L2_cache_size).smem_bytes))
    return "fused_acc" if fits else "reference"


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


def _dense_from_blocks(blocks, nb8, *, symmetric):
    """(nblk, 8, 8) upper 8 x 8 blocks, in the kernels' row-major
    upper-triangle order, to the dense (8 nb8, 8 nb8) matrix: mirrored
    when ``symmetric``, else with zero blocks below the diagonal."""
    bi, bj = torch.triu_indices(nb8, nb8, device=blocks.device)
    full = torch.zeros(nb8, nb8, _BLK, _BLK, dtype=blocks.dtype,
                       device=blocks.device)
    if symmetric:
        full[bj, bi] = blocks.mT
    full[bi, bj] = blocks
    return full.permute(0, 2, 1, 3).reshape(nb8 * _BLK, nb8 * _BLK)


def _unpack_gram(blocks, m):
    """Upper blocks of the (mp, mp) Gram of [V w | w y] to (G, u)."""
    full = _dense_from_blocks(blocks, -(-(m + 1) // _BLK), symmetric=True)
    return full[:m, :m], full[:m, m]


def _partials(geo, comp, device):
    """The per-CTA partials the forward kernels write: the Gram's upper
    8 x 8 blocks (hi, lo when ``comp``), float4 v of block b (entries v // 2,
    4 (v % 2) .. + 3) at [v, b], and the four scalars' (hi, lo)."""
    gram = torch.empty(geo.n_ctas, 2 if comp else 1, _BLK * _BLK // 4,
                       geo.nblk, 4, dtype=torch.float32, device=device)
    return gram, torch.empty(geo.n_ctas, 2, 4, dtype=torch.float32,
                             device=device)


def _fold_partials(gram_part):
    """The cross-CTA reduce in f64 (hi and lo folded too), deterministic:
    (n_ctas, pairs, 16, nblk, 4) partials to the (nblk, 8, 8) blocks."""
    blocks = gram_part.sum(dim=(0, 1), dtype=torch.float64)
    return blocks.permute(1, 0, 2).reshape(-1, _BLK, _BLK)


def _validate(X, y, z, u_inv, mask, block_size):
    """Check the tensors and ``block_size`` (positive: it sets the twin's
    blocks, the kernels do not read it); return (n, d, m)."""
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
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    return n, d, m


def _check_smem(props, smem, m, d):
    if not _fits(props, smem):
        raise ValueError(
            f"m={m}, d={d} needs {smem} bytes of shared memory per block; "
            f"the device allows {props.shared_memory_per_block_optin}"
        )


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.se_iso_stats_error_string(err).decode()} ({err})"
        )


def _host_scalars(device, *values):
    """Scalars the kernels take by value, as f32 Python floats: one sync."""
    return torch.stack([
        torch.as_tensor(v, device=device).detach().to(torch.float64)
        for v in values
    ]).to(torch.float32).tolist()


def _launch(entry, comp, log_ell, log_sf2, z, u_inv, sigma2, X, y, mask,
            block_size, acc_dtype):
    lib = load_library()
    n, d, m = _validate(X, y, z, u_inv, mask, block_size)
    props = torch.cuda.get_device_properties(X.device)
    geo = _geometry(n, m, d, props.multi_processor_count)
    _check_smem(props, geo.smem_bytes, m, d)
    if geo.groups:  # the tiled route's copies read whole rows of u_inv
        u_inv = u_inv.triu()
    gram_part, sums_part = _partials(geo, comp, X.device)
    log_ell = torch.as_tensor(log_ell, device=X.device).detach()
    q, lsf2, s2 = _host_scalars(X.device, -0.5 * torch.exp(-2.0 * log_ell),
                                log_sf2, sigma2)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        err = getattr(lib, entry)(
            X.data_ptr(), y.data_ptr(),
            None if mask is None else mask.data_ptr(),
            z.data_ptr(), u_inv.data_ptr(), n, d, m, q, lsf2, s2,
            geo.n_ctas, geo.tiles_per_cta, gram_part.data_ptr(),
            sums_part.data_ptr(), stream,
        )
    _raise_on(lib, err, "se_iso_stats")
    gram, u_vec = _unpack_gram(_fold_partials(gram_part), m)
    sums = sums_part.sum(dim=(0, 1), dtype=torch.float64)
    return (gram.to(acc_dtype), u_vec.to(acc_dtype),
            *(s.to(acc_dtype) for s in sums.unbind()))


def se_iso_stream_stats_fused_acc(log_ell, log_sf2, z, u_inv, sigma2, X, y,
                                  mask=None, *, block_size=8192,
                                  acc_dtype=torch.float32):
    """Single-pass fused statistics with compensated in-kernel accumulation.

    On CUDA one CTA per SM walks 64-row tiles and carries G, u and the
    four scalars as two-sum (hi, lo) pairs; the wrapper folds and sums the
    per-CTA partials in f64 and returns them in ``acc_dtype``.
    ``block_size`` sets the twin's blocks; on CUDA it must be positive and
    is not read.  ``u_inv`` must be upper triangular (the inverse of the
    upper Cholesky factor): only that triangle is read.
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

    The parity variant: each CTA (one per SM) adds its tiles' Gram plainly
    in f32 (the scalars stay compensated) and writes one partial; the
    wrapper sums the partials in f64, as the JAX wrapper sums its per-tile
    partials, and returns them in ``acc_dtype``.  ``block_size`` as in
    :func:`se_iso_stream_stats_fused_acc`.  ``u_inv`` must be upper
    triangular.
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


@torch.no_grad()
def _se_iso_bwd_reference(log_ell, log_sf2, z, u_inv, sigma2, X, y, mask,
                          gbar, ubar, lds_bar, yiy_bar, isr_bar, *,
                          block_size, acc_dtype, need_y=True):
    """Plain PyTorch twin of the backward kernel: the blocked loop of
    ``models/stream_grad._backward_scan`` in the dtype of ``z``.  Its
    u_inv cotangent is the full product Knm' V-bar, as in the JAX package."""
    kernel = SeIso(log_ell, log_sf2, device=z.device, dtype=z.dtype)
    xb, yb, maskb = _pad_blocks(X, y, mask, block_size)
    *grads, y_bar = _backward_scan(
        kernel, z, u_inv, sigma2, xb, yb, maskb,
        (gbar, ubar, lds_bar, yiy_bar, isr_bar), acc_dtype, need_y,
    )
    return (*grads, None if y_bar is None else y_bar.reshape(-1)[:X.shape[0]])


def _launch_bwd(log_ell, log_sf2, z, u_inv, sigma2, X, y, mask, gbar, ubar,
                lds_bar, yiy_bar, isr_bar, block_size, acc_dtype, need_y):
    lib = load_library()
    n, d, m = _validate(X, y, z, u_inv, mask, block_size)
    props = torch.cuda.get_device_properties(X.device)
    geo = _bwd_geometry(n, m, d, props.multi_processor_count,
                        props.L2_cache_size)
    _check_smem(props, geo.smem_bytes, m, d)
    f32, f64 = torch.float32, torch.float64
    # once per backward, outside the kernel: Gs = G-bar + G-bar', and U^-T
    # row-major for K-bar = V-bar U^-T.  Both routes form VG = V Gs
    # themselves (the JAX wrapper passes U^-1 Gs); the tiled route reads
    # whole rows of both triangles.
    gsym = (gbar + gbar.mT).to(f32).contiguous()
    if geo.groups:
        u_inv = u_inv.triu()
    u_inv_t = u_inv.mT.contiguous()
    ubar = ubar.to(f32).contiguous()
    dev = X.device
    # float4 v of block b at [v, b]; c'[X | 1 | xx] (d + 2, mp) on the tiled
    # route, (m, d + 2) on the wide
    ui_part = torch.empty(geo.n_parts, 2, _BLK * _BLK // 4, geo.nblk, 4,
                          dtype=f32, device=dev)
    if geo.groups:
        caug_part = torch.empty(geo.n_ctas, 2, d + 2, -(-m // _BLK) * _BLK,
                                dtype=f32, device=dev)
    else:
        caug_part = torch.empty(geo.n_ctas, 2, m, d + 2, dtype=f32, device=dev)
    sums_part = torch.empty(geo.n_ctas, 2, 2, dtype=f32, device=dev)
    # the tickets of the CTAs that share a partial start at zero
    turn = (torch.zeros(geo.n_parts, dtype=torch.int32, device=dev)
            if geo.share > 1 else None)
    y_bar = torch.empty(n, dtype=f32, device=dev) if need_y else None
    log_ell = torch.as_tensor(log_ell, device=dev).detach().to(f64)
    log_sf2 = torch.as_tensor(log_sf2, device=dev).detach().to(f64)
    scal = _host_scalars(dev, -0.5 * torch.exp(-2.0 * log_ell), log_sf2,
                         sigma2, lds_bar, yiy_bar, isr_bar)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.se_iso_bwd_acc(
            X.data_ptr(), y.data_ptr(),
            None if mask is None else mask.data_ptr(),
            z.data_ptr(), u_inv.data_ptr(), u_inv_t.data_ptr(),
            gsym.data_ptr(), ubar.data_ptr(), n, d, m, *scal,
            geo.n_ctas, geo.tiles_per_cta, geo.share,
            None if turn is None else turn.data_ptr(), ui_part.data_ptr(),
            caug_part.data_ptr(), sums_part.data_ptr(),
            None if y_bar is None else y_bar.data_ptr(), stream,
        )
    _raise_on(lib, err, "se_iso_bwd")
    # fold hi + lo and reduce across CTAs in f64; then the SE-iso pullback
    # of kernels/se_iso.py::k_cross_vjp from c'[X | 1 | xx]
    ui_bar = _dense_from_blocks(_fold_partials(ui_part), -(-m // _BLK),
                                symmetric=False)[:m, :m].triu()
    caug = caug_part.sum(dim=(0, 1), dtype=f64)
    if geo.groups:  # (d + 2, mp), zero past column m
        caug = caug[:, :m].mT
    c_x, c_s, c_xx = caug[:, :d], caug[:, d], caug[:, d + 1]
    rbar_sum, s2_bar = sums_part.sum(dim=(0, 1), dtype=f64).unbind()
    a = torch.exp(-2.0 * log_ell)
    z64 = z.to(f64)
    c_dot_d2 = (torch.sum(c_xx) + torch.dot(c_s, torch.sum(z64 * z64, dim=1))
                - 2.0 * torch.sum(c_x * z64))
    grads = (a * c_dot_d2, torch.sum(c_s) + torch.exp(log_sf2) * rbar_sum,
             -a * (c_s[:, None] * z64 - c_x), ui_bar, s2_bar)
    return (*(g.to(acc_dtype) for g in grads),
            None if y_bar is None else y_bar.to(acc_dtype))


def se_iso_stream_bwd_fused(log_ell, log_sf2, z, u_inv, sigma2, X, y, mask,
                            gbar, ubar, lds_bar, yiy_bar, isr_bar, *,
                            block_size=8192, acc_dtype=torch.float32,
                            need_y=True):
    """Backward of the fused statistics: the cotangents (G-bar, u-bar,
    lds-bar, yiy-bar, isr-bar) of ``se_iso_stream_stats_fused_acc``'s
    outputs pulled back to

        (log_ell_bar, log_sf2_bar, z_bar, u_inv_bar, sigma2_bar, y_bar)

    in ``acc_dtype``; ``y_bar`` (n,) is None unless ``need_y``.

    On CUDA one CTA per SM walks row tiles (:func:`_bwd_geometry`: 64 rows
    on the tiled route, m <= 320 at d = 8; 32, 24, 16 or 8 on the wide
    route, m up to about 2,870), recomputes
    Knm, V = Knm U^-1 and VG = V (G-bar + G-bar'), chains the cotangents and
    carries two-sum (hi, lo) partials of u_inv_bar, of c'[X | 1 | xx]
    (c = K-bar * Knm, the SE-iso pullback's one reduction) and of the
    scalars; the wrapper folds and sums them in f64.  Where one u_inv_bar
    partial a CTA would overflow a quarter of the L2, up to 4 neighbouring
    CTAs take turns on one, in a fixed order, and the launch is
    cooperative.  ``block_size`` sets the twin's blocks; on CUDA it must be
    positive and is not read.  ``u_inv`` must be upper
    triangular, and the kernel returns only the upper triangle of u_inv_bar
    (zero below): the triangular solve that forms U^-1 reads only that
    triangle of its cotangent.  The twin returns the full product.
    """
    if not X.is_cuda:
        return _se_iso_bwd_reference(
            log_ell, log_sf2, z, u_inv, sigma2, X, y, mask, gbar, ubar,
            lds_bar, yiy_bar, isr_bar, block_size=block_size,
            acc_dtype=acc_dtype, need_y=need_y,
        )
    out = _launch_bwd(log_ell, log_sf2, z, u_inv, sigma2, X, y, mask, gbar,
                      ubar, lds_bar, yiy_bar, isr_bar, block_size, acc_dtype,
                      need_y)
    se_iso_stream_bwd_fused.launches += 1
    return out


se_iso_stream_bwd_fused.launches = 0
