"""Launch geometry of the forward-statistics kernels (ops/fused_stats.py).

The kernels themselves run only on the card (chip_smoke.py holds
``_geometry``'s shared memory and route equal to the library's for every m
in 1..400); here the route, the padded column groups, the shared memory,
the grid and the partials the wrapper allocates are checked on the CPU.
"""

import numpy as np
import pytest
import torch

from gpr_tpu_torch.ops import fused_stats as tops
from gpr_tpu_torch.ops.fused_stats import SMEM_OPTIN, _geometry


def _tiled_bytes(m, d):
    """The Knm tile, two ring stages (a U^-1 slice and an x tile), Z^T,
    |z|^2 and the warp sums."""
    g = -(-(m + 1) // 64)
    w = 64 * g
    return 4 * (w * 68 + 2 * (16 * w + 64 * d) + d * w + w + 32)


def _held_bytes(m):
    """B, the second row tile of A' that a folding CTA holds."""
    return 4 * 64 * -(-(m + 1) // 8) * 8


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
    At d = 20 B no longer fits.  m = 400 takes the wide route with the first
    kernel's layout."""
    geo = _geometry(1_000_000, 300, 8, 132)
    assert (geo.groups, geo.fold, geo.smem_bytes) == (5, True, 221_568)
    assert 320 * 68 * 4 == 87_040 and 2 * (16 * 320 + 512) * 4 == 45_056
    assert 64 * 304 * 4 == 77_824
    assert _geometry(1_000_000, 300, 20, 132)[:2] == (5, False)
    wide = _geometry(1_000_000, 400, 8, 132)
    mp = 408
    assert (wide.groups, wide.fold, wide.smem_bytes) == (0, False, 4 * (
        64 * mp + 400 * 32 + 8 * mp + mp + 64 * 8 + 128 + 32))


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


def test_every_kernel_variant_edit_applies():
    """ops/stats_variants.py measures each phase and design choice of the
    tiled kernel by exact edits of csrc/se_iso_stats.cu: each must apply
    once to the source as it stands, and change it."""
    from gpr_tpu_torch.ops import _build, stats_variants

    src = (_build._CSRC / "se_iso_stats.cu").read_text()
    for name, edits in stats_variants.EDITS.items():
        out = stats_variants.variant_source(src, edits)
        assert (out == src) == (name == "as built"), name
    with pytest.raises(ValueError):
        stats_variants.variant_source(src, [("no such text", "")])
