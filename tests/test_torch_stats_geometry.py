"""Launch geometry of the statistics kernels, forward and backward
(ops/fused_stats.py).

The kernels themselves run only on the card (chip_smoke.py holds
``_geometry``'s and ``_bwd_geometry``'s shared memory, route and rows a
tile equal to the library's for every m in 1..1200 and at the wide routes'
limits); here the route, the padded column groups, the shared memory, the
grid and the partials the wrapper allocates are checked on the CPU.
"""

import numpy as np
import pytest
import torch

from gpr_tpu_torch.ops import fused_stats as tops
from gpr_tpu_torch.ops.fused_stats import (
    SMEM_OPTIN,
    _bwd_geometry,
    _geometry,
)


def _tiled_bytes(m, d):
    """The Knm tile, two ring stages (a U^-1 slice and an x tile), Z^T,
    |z|^2 and the warp sums."""
    g = -(-(m + 1) // 64)
    w = 64 * g
    return 4 * (w * 68 + 2 * (16 * w + 64 * d) + d * w + w + 32)


def _held_bytes(m):
    """B, the second row tile of A' that a folding CTA holds."""
    return 4 * 64 * -(-(m + 1) // 8) * 8


def _wide_bytes(m, d, rows):
    """The wide route at ``rows`` rows a tile: the (rows, mp) tile, two
    64 x 32 chunks of U^-1 (the ring), |z|^2, the x tile, w and w y, the
    warp sums."""
    mp = 8 * -(-(m + 1) // 8)
    return 4 * (rows * mp + 2 * 64 * 32 + mp + rows * d + 2 * rows + 32)


@pytest.mark.parametrize("d", [1, 3, 8, 20, 48])
def test_route_groups_and_fold_for_every_m(d):
    """The tiled route takes m <= 383 where its shared memory fits, with
    G = ceil((m + 1) / 64) groups (column m, u, in the last one), and folds
    two tiles into each Gram update where B fits too; every other m takes
    the wide route.  Up to d = 20 the switch is at m = 384; at d = 48 the
    G = 6 tile no longer fits, so it comes at m = 320."""
    routes = []
    for m in range(1, 401):
        geo = _geometry(1000, m, d, 132)
        tiled = _tiled_bytes(m, d)
        if m <= 383 and tiled <= SMEM_OPTIN:
            assert geo.groups == -(-(m + 1) // 64), (m, d)
            assert 64 * geo.groups >= m + 1
            assert geo.fold == (tiled + _held_bytes(m) <= SMEM_OPTIN)
            assert geo.smem_bytes == tiled + geo.fold * _held_bytes(m)
            assert geo.smem_bytes <= SMEM_OPTIN
        else:
            assert (geo.groups, geo.fold) == (0, False), (m, d)
            assert (geo.rows, geo.smem_bytes) == (64, _wide_bytes(m, d, 64))
        routes.append(geo.groups > 0)
    first_wide = routes.index(False) + 1
    assert first_wide == (320 if d == 48 else 384)
    assert not any(routes[first_wide - 1:])
    if d == 8:  # every G <= 5 folds; G = 6 does not
        assert all(_geometry(1000, m, d, 132).fold == (m < 320)
                   for m in range(1, 384))


def test_shared_memory_at_the_bench_shape():
    """m = 300, d = 8: G = 5, 320 padded columns; the Knm tile (87,040 B),
    two ring stages of a U^-1 slice and an x tile (45,056 B), Z^T, |z|^2,
    the warp sums and B (77,824 B): 221,568 bytes, one CTA per SM, folding.
    At d = 20 B no longer fits.  m = 400 takes the wide route with 64-row
    tiles; it takes fewer rows a tile where they no longer fit (48, 32, 24,
    16, 8; m = 1,000: 48), and past that (m >= 5,984 at d = 8) the wrapper
    refuses."""
    geo = _geometry(1_000_000, 300, 8, 132)
    assert (geo.groups, geo.fold, geo.smem_bytes) == (5, True, 221_568)
    assert 320 * 68 * 4 == 87_040 and 2 * (16 * 320 + 512) * 4 == 45_056
    assert 64 * 304 * 4 == 77_824
    assert _geometry(1_000_000, 300, 20, 132)[:2] == (5, False)
    wide = _geometry(1_000_000, 400, 8, 132)
    mp = 408
    assert (wide.groups, wide.fold, wide.smem_bytes, wide.rows) == (
        0, False, 4 * (64 * mp + 2 * 64 * 32 + mp + 64 * 8 + 128 + 32), 64)
    assert wide.n_tiles == 15_625
    for d in (1, 8, 20, 64):
        last = {}
        for m in range(384, 6_400):
            geo = _geometry(1_000_000, m, d, 132)
            for rows in (64, 48, 32, 24, 16, 8):
                if _wide_bytes(m, d, rows) <= SMEM_OPTIN:
                    break
            assert (geo.rows, geo.smem_bytes) == (rows,
                                                  _wide_bytes(m, d, rows))
            assert geo.n_tiles == -(-1_000_000 // rows)
            if geo.smem_bytes <= SMEM_OPTIN:
                last[rows] = m
        # the last m of each rows a tile: a wider x tile moves them down
        assert [last[r] for r in (64, 48, 32, 24, 16, 8)] == (
            {1: [823, 1_095, 1_631, 2_151, 3_167, 5_991],
             8: [815, 1_087, 1_623, 2_143, 3_159, 5_983],
             20: [807, 1_079, 1_607, 2_135, 3_151, 5_975],
             64: [759, 1_031, 1_567, 2_095, 3_111, 5_935]}[d])
    geo = _geometry(1_000_000, 1_000, 8, 132)
    assert (geo.rows, geo.n_tiles, geo.n_ctas) == (48, 20_834, 132)


def test_grid_is_one_cta_per_sm_and_every_cta_owns_a_tile():
    """Tiled: n_ctas = min(SMs, tiles), the CTAs stride over the tiles.
    Wide: contiguous chunks of tiles_per_cta tiles, n_ctas <= min(SMs,
    tiles), and the last CTA's chunk is not empty."""
    for n in (1, 64, 65, 8191, 100_003, 999_424, 1_000_000):
        for sms in (1, 114, 132):
            for m, d in ((300, 8), (37, 3), (400, 8), (200, 32)):
                geo = _geometry(n, m, d, sms)
                tiles = -(-n // 64)
                assert geo.n_tiles == tiles
                assert 1 <= geo.n_ctas <= min(sms, tiles)
                if geo.groups:
                    assert geo.n_ctas == min(sms, tiles)
                else:
                    tpc = geo.tiles_per_cta
                    assert (geo.n_ctas - 1) * tpc < tiles <= geo.n_ctas * tpc
    assert _geometry(1_000_000, 300, 8, 132).n_ctas == 132
    assert _geometry(1_000_000, 400, 8, 132).n_ctas == 132


@pytest.mark.parametrize("comp", [True, False])
def test_partials_unpack_to_the_gram_and_u(comp):
    """The partials the wrapper allocates, (n_ctas, pairs, 16, nblk, 4) and
    (n_ctas, 2, 4), filled as the kernels write them (float4 v of block b at
    [v, b]) with the blocks of a known [V w | w y] Gram split over CTAs and
    hi/lo halves, fold and unpack to (G, u) as the wrapper does."""
    rng = np.random.default_rng(0)
    for m in (1, 7, 8, 37, 300, 383, 400):
        geo = _geometry(10_000, m, 8, 3)
        gram, sums = tops._partials(geo, comp, "cpu")
        pairs = 2 if comp else 1
        assert tuple(gram.shape) == (geo.n_ctas, pairs, 16, geo.nblk, 4)
        assert tuple(sums.shape) == (geo.n_ctas, 2, 4)
        nb8 = -(-(m + 1) // 8)
        a = rng.standard_normal((64, m + 1))
        full = np.zeros((8 * nb8, 8 * nb8))
        full[:m + 1, :m + 1] = a.T @ a
        blocks = np.stack([full[8 * i:8 * i + 8, 8 * j:8 * j + 8]
                           for i in range(nb8) for j in range(i, nb8)])
        assert blocks.shape[0] == geo.nblk
        written = blocks.reshape(geo.nblk, 16, 4).transpose(1, 0, 2)
        shares = rng.dirichlet(np.ones(geo.n_ctas * pairs))
        parts = shares.reshape(geo.n_ctas, pairs, 1, 1, 1) * written
        g, u = tops._unpack_gram(tops._fold_partials(torch.as_tensor(parts)),
                                 m)
        np.testing.assert_allclose(g.numpy(), full[:m, :m], rtol=1e-12,
                                   atol=1e-12 * np.abs(full).max())
        np.testing.assert_allclose(u.numpy(), full[:m, m], rtol=1e-12,
                                   atol=1e-12 * np.abs(full).max())


def _bwd_tiled_bytes(m, d):
    """The k-major tile A, the row-major tile R, two ring slices, two x
    tiles, Z^T, |z|^2 and u-bar, three row vectors and the warp sums."""
    w = 64 * -(-m // 64)
    mp = 8 * -(-m // 8)
    return 4 * (w * 68 + 64 * mp + 2 * 16 * w + 2 * 64 * d + d * w + 2 * w
                + 3 * 64 + 16)


def _bwd_wide_bytes(m, d, rows=32):
    """Two tiles of ``rows`` rows, three 16 x 128 chunks of a weight panel
    (the ring), |z|^2 and u-bar, the x tile, four row vectors and the warp
    sums."""
    mp = 8 * -(-m // 8)
    return 4 * (2 * rows * mp + 3 * 16 * 128 + 2 * mp + rows * d + 4 * rows
                + 16)


@pytest.mark.parametrize("d", [1, 3, 8, 20, 48])
def test_bwd_route_and_grid_for_every_m(d):
    """The backward tiled route takes G = ceil(m / 64) <= 5 column groups
    where its two tiles, ring and vectors fit in the 232,448 bytes a block
    may opt into; every other m takes the wide route.  At d <= 8 the switch
    is at m = 321; a wider x tile and Z^T move it down.  The wide route
    takes 32-row tiles up to m = 400.  Both routes launch min(SMs, tiles)
    CTAs or fewer, each with a tile."""
    routes = []
    for m in range(1, 401):
        geo = _bwd_geometry(1_000_000, m, d, 132)
        tiled = _bwd_tiled_bytes(m, d)
        assert geo.nblk == -(-m // 8) * (-(-m // 8) + 1) // 2
        if -(-m // 64) <= 5 and tiled <= SMEM_OPTIN:
            assert geo.groups == -(-m // 64), (m, d)
            assert geo.smem_bytes == tiled <= SMEM_OPTIN
            assert geo.n_tiles == 15_625 and geo.n_ctas == 132
            # the fewest CTAs a partial (1, 2 or 4) that keep all hi/lo
            # partials of the triangle within a quarter of the 50 MiB L2
            part = 2 * 4 * 64 * geo.nblk
            assert geo.share in (1, 2, 4)
            assert geo.n_parts == -(-132 // geo.share)
            assert geo.share == 4 or geo.n_parts * part <= 50 * 2 ** 20 // 4
            assert geo.share == 1 or (-(-132 // (geo.share // 2)) * part
                                      > 50 * 2 ** 20 // 4)
        else:
            assert geo.groups == 0, (m, d)
            assert (geo.rows, geo.smem_bytes) == (32, _bwd_wide_bytes(m, d))
            assert geo.n_tiles == 31_250
            tpc = geo.tiles_per_cta
            assert (geo.n_ctas - 1) * tpc < geo.n_tiles <= geo.n_ctas * tpc
            assert geo.n_ctas <= 132
            assert (geo.share, geo.n_parts) == (1, geo.n_ctas)
        routes.append(geo.groups > 0)
    first_wide = routes.index(False) + 1
    assert first_wide == {1: 321, 3: 321, 8: 321, 20: 257, 48: 209}[d]
    assert not any(routes[first_wide - 1:])
    for n in (1, 64, 65, 8191, 100_003):
        for sms in (1, 114, 132):
            for m in (37, 300, 336):
                geo = _bwd_geometry(n, m, d, sms)
                assert geo.rows == (64 if geo.groups else 32)
                assert geo.n_tiles == -(-n // geo.rows)
                assert 1 <= geo.n_ctas <= min(sms, geo.n_tiles)
                assert geo.n_parts == -(-geo.n_ctas // geo.share)
                if geo.groups:
                    assert geo.n_ctas == min(sms, geo.n_tiles)
                else:
                    tpc = geo.tiles_per_cta
                    assert (geo.n_ctas - 1) * tpc < geo.n_tiles
    # a smaller L2 shares sooner; a device without partials to spare, never
    assert _bwd_geometry(1_000_000, 129, d, 132).share == 1
    assert _bwd_geometry(1_000_000, 129, d, 132, 2 ** 20).share == 4
    assert _bwd_geometry(64, 300, 1, 132).share == 1


def test_bwd_shared_memory_at_the_bench_shape():
    """m = 300, d = 8: G = 5, 320 padded columns; A k-major (87,040 B), R
    row-major (77,824 B), two ring slices (40,960 B), two x tiles (4,096 B),
    Z^T (10,240 B), |z|^2 and u-bar (2,560 B), three row vectors and the
    warp sums (832 B): 223,552 bytes, one CTA per SM.  One hi/lo partial of
    the triangle a CTA would be 50 MB, so 4 CTAs take turns on each of 33
    (12.5 MB).  m = 320 is the last tiled m.  The wide route's two tiles
    take 32 rows up to m = 776, 24 up to 1,032, 16 up to 1,520 and 8 up to
    2,880 at d = 8; past that the wrapper refuses."""
    geo = _bwd_geometry(1_000_000, 300, 8, 132)
    assert (geo.groups, geo.smem_bytes, geo.n_ctas) == (5, 223_552, 132)
    assert (geo.nblk, geo.share, geo.n_parts) == (741, 4, 33)
    assert 132 * 2 * 4 * 64 * 741 == 50_079_744
    assert (87_040 + 77_824 + 40_960 + 4_096 + 10_240 + 2_560 + 832
            == 223_552)
    assert _bwd_geometry(1_000_000, 320, 8, 132)[:2] == (5, 227_648)
    wide = _bwd_geometry(1_000_000, 336, 8, 132)
    assert (wide.groups, wide.smem_bytes, wide.rows) == (0, 114_880, 32)
    assert (4 * (2 * 32 * 336 + 3 * 16 * 128 + 2 * 336 + 32 * 8 + 128 + 16)
            == 114_880)
    for m, rows in ((337, 32), (400, 32), (776, 32), (777, 24), (1_000, 24),
                    (1_032, 24), (1_033, 16), (1_520, 16), (1_521, 8),
                    (2_880, 8)):
        geo = _bwd_geometry(1_000_000, m, 8, 132)
        assert (geo.groups, geo.rows) == (0, rows), m
        assert geo.smem_bytes == _bwd_wide_bytes(m, 8, rows) <= SMEM_OPTIN
        assert geo.n_tiles == -(-1_000_000 // rows)
    assert _bwd_geometry(1_000_000, 2_881, 8, 132).smem_bytes > SMEM_OPTIN


def test_bwd_triangle_partial_unpacks_to_upper_blocks():
    """The tiled route's partial of the U^-1 cotangent, (n_ctas, 2, 16,
    nblk, 4) with float4 v of block b at [v, b], filled with the upper 8 x 8
    blocks of a known Knm' V-bar split over CTAs and hi/lo halves, folds and
    unpacks to that matrix with zero blocks below the diagonal."""
    rng = np.random.default_rng(1)
    for m in (1, 8, 37, 64, 65, 300, 320):
        geo = _bwd_geometry(10_000, m, 8, 3)
        assert geo.n_parts == geo.n_ctas == 3
        nb8 = -(-m // 8)
        s_mat = rng.standard_normal((64, m))
        t_mat = rng.standard_normal((64, m))
        full = np.zeros((8 * nb8, 8 * nb8))
        full[:m, :m] = s_mat.T @ t_mat
        blocks = np.stack([full[8 * i:8 * i + 8, 8 * j:8 * j + 8]
                           for i in range(nb8) for j in range(i, nb8)])
        assert blocks.shape[0] == geo.nblk
        written = blocks.reshape(geo.nblk, 16, 4).transpose(1, 0, 2)
        shares = rng.dirichlet(np.ones(geo.n_parts * 2))
        parts = shares.reshape(geo.n_parts, 2, 1, 1, 1) * written
        dense = tops._dense_from_blocks(
            tops._fold_partials(torch.as_tensor(parts)), nb8, symmetric=False)
        want = full.copy()
        for i in range(nb8):  # blocks below the diagonal are not kept
            want[8 * i:8 * i + 8, :8 * i] = 0.0
        np.testing.assert_allclose(dense.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(full).max())
        np.testing.assert_allclose(np.triu(dense.numpy()[:m, :m]),
                                   np.triu(full[:m, :m]), rtol=1e-12,
                                   atol=1e-12 * np.abs(full).max())


def test_every_kernel_variant_edit_applies():
    """ops/stats_variants.py and ops/bwd_variants.py measure each phase and
    design choice of the tiled kernels by exact edits of csrc/se_iso_stats.cu,
    csrc/se_iso_bwd.cu and the headers they include: each must apply once,
    to one of those files as they stand, and change it."""
    from gpr_tpu_torch.ops import bwd_variants, stats_variants

    for mod in (stats_variants, bwd_variants):
        srcs = stats_variants.read_sources(mod.SOURCE)
        assert set(srcs) >= {mod.SOURCE, "fp32_tile.cuh", "stats_tile.cuh"}
        for name, edits in mod.EDITS.items():
            out = stats_variants.variant_sources(srcs, edits)
            assert (out == srcs) == (name == "as built"), (mod.SOURCE, name)
        with pytest.raises(ValueError):
            stats_variants.variant_sources(srcs, [("no such text", "")])
    # the backward list covers what it is meant to measure
    assert {"no V product", "no VG product", "no Kb product",
            "no triangle update", "no write-back", "no Knm recomputes",
            "no triangle skip"} <= set(bwd_variants.EDITS)
