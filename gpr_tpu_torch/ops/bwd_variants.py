"""Variant builds of the backward kernel's tiled route, to measure on the
card what each of its phases and design choices costs.

    python3 -m gpr_tpu_torch.ops.bwd_variants

The machinery is ``ops/stats_variants.py``'s: each variant is
``csrc/se_iso_bwd.cu`` and its headers with a few exact text edits -- a
phase whose work is skipped on all but a CTA's first tile, so that the
compiler keeps it, or one design choice undone -- compiled side by side
into ``gpr_tpu_torch/_build/bwd_variants/`` and launched raw at the
training step's shape of ``chip_smoke.py`` (bench.py's draw, 1,000,000 x 8,
m = 300), all in turns, CUDA events, median of 14; the kernel as built is
also launched with 1, 2, 4 and 8 CTAs taking turns on each partial of the
U^-1 cotangent (the wrapper picks 4 there).  The cotangents are
seeded draws of the evidence's magnitudes; the ablated variants compute
wrong gradients by design and no result is checked here (``chip_smoke.py``
checks the kernel as built).  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from .fused_stats import _BLK, _bwd_geometry
from .stats_variants import (
    D,
    M,
    N,
    bench_draw,
    build,
    card_name,
    time_variants,
)

SOURCE = "se_iso_bwd.cu"
SHARES = (1, 2, 4, 8)
ENTRY = "se_iso_bwd_acc"

_UPPER = "      mma_upper<G>(acc, A + s * kBK * kAStride, ring + read_stage * kStage, s * kBK);"
_FULL = "      mma_slice<G>(acc, A + s * kBK * kAStride, ring + read_stage * kStage);"
_LOWER = "      mma_lower<G>(acc, A + s * kBK * kAStride, ring + read_stage * kStage, s * kBK);"
_KNM = "      form_knm<G>(acc, x2, xs, Zt, z2, d, m, q, log_sf2);\n    }\n"
_KNM_6 = _KNM + "    mul_rows<G>(acc, A, mp);"
_KNM_7 = _KNM + "    store_rows<G>(A, acc, mp);\n    if (share > 1"
_GRAM = "    add_gram<true, kBatch>(A, nullptr, mp, ui, ticket == 0, R);"
_CAUG = "    for (int e = tid; e < naug4; e += kThreads) {"


def _first_only(text: str) -> tuple:
    """The statement ``text`` run on a CTA's first tile only."""
    body = text.lstrip(" ")
    return text, text[:len(text) - len(body)] + "if (first) " + body


EDITS = {
    "as built": [],
    "no V product": [_first_only(_UPPER)],
    "no VG product": [_first_only(_FULL)],
    "no Kb product": [_first_only(_LOWER)],
    "no triangle update": [_first_only(_GRAM)],
    "no write-back": [("      if (!first) {\n#pragma unroll\n        for (int v0 = 0;",
                       "      if (!first) {\n        continue;\n#pragma unroll\n"
                       "        for (int v0 = 0;")],
    "no Knm recomputes": [_first_only(_KNM_6), _first_only(_KNM_7)],
    "no c'[X|1|xx]": [(_CAUG, _CAUG.replace("e < naug4", "e < (first ? naug4 : 0)"))],
    "no triangle skip": [(_UPPER, _FULL.replace("mma_slice<G>(", "mma_slice<G, 0>(")),
                         (_LOWER, _FULL.replace("mma_slice<G>(", "mma_slice<G, 0, (G + 1) / 2>("))],
    **{f"write-back {k} in flight": [("constexpr int kBatch = 8; ",
                                      f"constexpr int kBatch = {k};")]
       for k in (1, 4, 16)},
}


def launcher(lib, inputs, dev, share=None):
    """One raw launch at the step's shape; ``share`` CTAs a partial of the
    U^-1 cotangent instead of the wrapper's choice when given."""
    X, y, z, u_inv, q, lsf2, s2 = inputs
    props = torch.cuda.get_device_properties(dev)
    geo = _bwd_geometry(N, M, D, props.multi_processor_count,
                        props.L2_cache_size)
    share = share or geo.share
    n_parts = -(-geo.n_ctas // share)
    if not geo.groups:
        raise RuntimeError("the variants edit the tiled route")
    gen = torch.Generator(device=dev).manual_seed(5)
    gbar = 1e-3 * torch.randn(M, M, device=dev, generator=gen)
    gs = (gbar + gbar.mT).contiguous()
    ubar = 1e-2 * torch.randn(M, device=dev, generator=gen)
    u_inv_t = u_inv.mT.contiguous()
    f32 = torch.float32
    ui = torch.empty(n_parts, 2, _BLK * _BLK // 4, geo.nblk, 4, dtype=f32,
                     device=dev)
    turn = torch.zeros(n_parts, dtype=torch.int32, device=dev)
    caug = torch.empty(geo.n_ctas, 2, D + 2, -(-M // _BLK) * _BLK, dtype=f32,
                       device=dev)
    sums = torch.empty(geo.n_ctas, 2, 2, dtype=f32, device=dev)
    fn = getattr(lib, ENTRY)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        turn.zero_()
        err = fn(X.data_ptr(), y.data_ptr(), None, z.data_ptr(),
                 u_inv.data_ptr(), u_inv_t.data_ptr(), gs.data_ptr(),
                 ubar.data_ptr(), N, D, M, q, lsf2, s2, -0.5, -0.5, -0.5,
                 geo.n_ctas, geo.tiles_per_cta, share, turn.data_ptr(),
                 ui.data_ptr(),
                 caug.data_ptr(), sums.data_ptr(), None, stream)
        if err:
            raise RuntimeError(f"{ENTRY}: launch failed ({err})")
    return run


def main() -> int:
    card = card_name()
    dev = torch.device("cuda", 0)
    libs = build(edits=EDITS, source=SOURCE, entries=(ENTRY,),
                 argtypes=_build._BWD_ARGTYPES, subdir="bwd_variants")
    inputs = bench_draw(dev)
    runs = {(name, ENTRY): launcher(lib, inputs, dev)
            for name, lib in libs.items()}
    # the partials of the U^-1 cotangent beside the L2: 50, 25, 12.5 MB
    runs.update({(f"{k} CTAs a partial", ENTRY): launcher(
        libs["as built"], inputs, dev, k) for k in SHARES})
    time_variants(runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
