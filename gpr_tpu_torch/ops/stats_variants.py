"""Variant builds of the forward-statistics kernel, to measure on the card
what each phase and each design choice of its tiled route costs.

    python3 -m gpr_tpu_torch.ops.stats_variants

Each variant is ``csrc/se_iso_stats.cu`` and the headers it includes with
a few exact text edits (each applies once, in one of those files; an edit
that no longer applies raises, so the list follows the source): a
phase taken out -- its work skipped on all but a CTA's first tile or
update, so that the compiler keeps it -- or one design choice undone.  The
variants compile side by side with the library's nvcc flags, each into a
shared library of its own under ``gpr_tpu_torch/_build/variants/``; each
kernel entry is then launched at the serving shape of ``chip_smoke.py``
(bench.py's draw, 1,000,000 x 8, m = 300, log_ell 0.5, log_sf2 0, sigma2
0.1, jitter 1e-6) and timed with CUDA events, all variants in turns forward
then reversed, median of 14 launches.  The ablated variants compute wrong
statistics by design, and "block-major partials" writes a layout the
wrapper does not read: no result is checked here (``chip_smoke.py`` checks
the kernel as built).  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..convert import from_jax_params
from ..models.fitc import calc_inducing
from ..numerics.linalg import inv_tri_upper
from . import _build
from .fused_stats import _geometry, _partials

N, D, M = 1_000_000, 8, 300
SOURCE = "se_iso_stats.cu"
ENTRIES = ("se_iso_stats_acc", "se_iso_stats_partials")

_KNM_SHARED = """    {
      const float* xs = ring + read_stage * stage + kBK * kWidth;
      const int r = tid % kRows;
      float x2 = 0.0f;
      for (int k = 0; k < d; ++k) x2 += xs[k * kRows + r] * xs[k * kRows + r];
      for (int j = tid / kRows; j < kWidth; j += kThreads / kRows) {
        float val = 0.0f;
        if (j < m) {
          float xz = 0.0f;
          for (int k = 0; k < d; ++k) xz += xs[k * kRows + r] * Zt[k * kWidth + j];
          float d2 = fmaxf(x2 - 2.0f * xz + z2[j], 0.0f);
          val = expf(log_sf2 + q * d2);
        }
        A[j * kAStride + r] = val;
      }
    }
"""
_KNM_START = "    {\n      const float* xs = ring + read_stage * stage + kBK * kWidth;\n"
_KNM_END = "      store_a<G>(A, acc);\n    }\n"
_RMW = "      const int i = v / 2, j = (v % 2) * 4;\n"

# name -> [(old, new), ...]; a new of None replaces old up to _KNM_END
EDITS = {
    "as built": [],
    "no write-back": [(_RMW, "      if (!first) continue;\n" + _RMW)],
    "no Gram": [("    add_gram<kComp>(held ? B : A,",
                 "    if (first) add_gram<kComp>(held ? B : A,")],
    "no Knm": [(_KNM_START, "    if (t == blockIdx.x)" + _KNM_START[4:])],
    "no V product": [("      mma_upper<G>(acc,",
                      "      if (t == blockIdx.x) mma_upper<G>(acc,")],
    "no fold": [("  return route_groups(m, d) && fits(tiled_smem_floats(m, d, true));",
                 "  return false;")],
    "no triangle skip": [("      mma_upper<G>(acc, A + s * kBK * kAStride, ring + read_stage * "
                          "stage, s * kBK);",
                          "      mma_slice<G>(acc, A + s * kBK * kAStride, ring + read_stage * "
                          "stage);")],
    "no L2 prefetch": [("  if (!kComp || b >= nblk) return;", "  return;")],
    "Gram rows one a trip": [("#pragma unroll 4\n      for (int r = 0; r < kR; ++r) {",
                              "      for (int r = 0; r < kR; ++r) {")],
    "block-major partials": [
        ("    float4* hi4 = reinterpret_cast<float4*>(part) + b;",
         "    float4* hi4 = reinterpret_cast<float4*>(part) + (size_t)b * kVecs;"),
        ("      const size_t at = (size_t)v * nblk;", "      const size_t at = v;"),
        ("  const float4* p = reinterpret_cast<const float4*>(part) + b;",
         "  const float4* p = reinterpret_cast<const float4*>(part) + (size_t)b * kVecs;"),
        ("(p + (size_t)v * nblk)", "(p + (v < kVecs ? v : nblk * kVecs - kVecs + v))")],
    "Knm from shared memory": [(_KNM_START, None)],
    "3-stage ring, no fold": [("constexpr int kRing = 2;", "constexpr int kRing = 3;")],
}


def read_sources(source: str = SOURCE) -> dict:
    """{file name: text} of ``source`` and every header of csrc/."""
    return {p.name: p.read_text()
            for p in (_build._CSRC / source, *_build._CSRC.glob("*.cuh"))}


def variant_sources(srcs: dict, edits) -> dict:
    """``srcs`` with each (old, new) applied to the one file that holds
    ``old``, which must occur once in all of them."""
    srcs = dict(srcs)
    for old, new in edits:
        hits = [name for name, text in srcs.items() if old in text]
        if len(hits) != 1 or srcs[hits[0]].count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:70]!r}")
        src = srcs[hits[0]]
        if new is None:  # the Knm block, start to end
            a = src.index(old)
            b = src.index(_KNM_END, a) + len(_KNM_END)
            srcs[hits[0]] = src[:a] + _KNM_SHARED + src[b:]
        else:
            srcs[hits[0]] = src.replace(old, new)
    return srcs


def build(names=None, *, edits=None, source=SOURCE, entries=ENTRIES,
          argtypes=_build._STATS_ARGTYPES, subdir="variants") -> dict:
    """Compile the named variants of ``source`` side by side; {name: CDLL}."""
    edits = EDITS if edits is None else edits
    srcs = read_sources(source)
    root = _build._BUILD / subdir
    nvcc, procs = _build._nvcc(), {}
    for i, name in enumerate(names or edits):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in variant_sources(srcs, edits[name]).items():
            (d / fname).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in entries:
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def bench_draw(dev):
    """bench.py's draw and model at chip_smoke.py's shape, as the kernels
    take them: X, y, z, triu(U^-1) and the scalars q, log_sf2, sigma2."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)
    Z = rng.standard_normal((M, D)).astype(np.float32)
    params = {"log_ell": np.float32(0.5), "log_sf2": np.float32(0.0)}
    kernel, z, s2 = from_jax_params(params, Z, np.float32(0.1), device=dev,
                                    dtype=torch.float32)
    with torch.no_grad():
        u_inv = inv_tri_upper(calc_inducing(kernel, z, 1e-6).chol_km).triu()
    q = float(-0.5 * torch.exp(-2.0 * kernel.log_ell.detach()))
    return (torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev),
            z.contiguous(), u_inv.contiguous(), q,
            float(kernel.log_sf2.detach()), float(s2))


def launcher(lib, entry, inputs, dev):
    X, y, z, u_inv, q, lsf2, s2 = inputs
    geo = _geometry(N, M, D, torch.cuda.get_device_properties(dev)
                    .multi_processor_count)
    gram, sums = _partials(geo, entry == "se_iso_stats_acc", dev)
    fn = getattr(lib, entry)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = fn(X.data_ptr(), y.data_ptr(), None, z.data_ptr(),
                 u_inv.data_ptr(), N, D, M, q, lsf2, s2, geo.n_ctas,
                 geo.tiles_per_cta, gram.data_ptr(), sums.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{entry}: launch failed ({err})")
    return run


def event_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def card_name() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel variants run on a CUDA card only")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def time_variants(runs: dict, card: str) -> None:
    """Time ``runs`` ({(variant, entry): launch}) in turns, forward then
    reversed, and print one line each beside the entry as built."""
    times = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            times[key] += event_ms(runs[key], 7)
    base = {entry: statistics.median(times["as built", entry])
            for _, entry in runs}
    for (name, entry), ts in times.items():
        ms = statistics.median(ts)
        print(f"variant {name:24s} {entry:22s} {ms:8.3f} ms "
              f"({ms - base[entry]:+.3f} vs as built; min {min(ts):.3f}, "
              f"max {max(ts):.3f}; CUDA events, median of {len(ts)}; {card})",
              flush=True)


def main() -> int:
    card = card_name()
    dev = torch.device("cuda", 0)
    libs = build()
    inputs = bench_draw(dev)
    time_variants({(name, entry): launcher(lib, entry, inputs, dev)
                   for name, lib in libs.items() for entry in ENTRIES}, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
