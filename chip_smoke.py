#!/usr/bin/env python3
"""Drive gpr_tpu_torch's streaming serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device  -- the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  No GPU: the script raises; there is no CPU path.
2. build   -- nvcc builds csrc/se_iso_stats.cu and csrc/se_iso_bwd.cu for
   sm_90a side by side (gpr_tpu_torch/_build/), with the ptxas register and
   spill report.
3. kernels -- both forward-statistics kernels (f32) against their plain
   PyTorch twin run in f64 on the card, on the same inputs: G and u within
   1e-4 relative (Frobenius), the four scalars within 1e-5.
4. bwd     -- the backward kernel (f32) against its twin run in f64 on the
   card, on the same f32 inputs and the real cotangents of the evidence's
   epilogue, at (65,536, m=300) and (100,003, m=37, 1,000 rows masked):
   z_bar, triu(u_inv_bar) and y_bar within 1e-4 relative (Frobenius), the
   three scalar gradients within 1e-4.
5. slice   -- serving: SE-iso at n = 1,000,000, d = 8, m = 300, on the data
   draw of bench.py (np.random.default_rng(0): X, y, Z, cast to f32),
   log_ell 0.5, log_sf2 0, sigma2 0.1, jitter 1e-6, block 8,192.  The f32
   evidence through each kernel must be within 2e-5 relative of the pinned
   f64 truth -2123659.4, the f64 twin within 1 nat; the kernel path's
   coefficients within 1e-3 of the twin's and its 1M predicted means
   finite.  Both forward launch counters must be positive after that run.
6. step    -- training: value and gradient (log_ell, log_sf2, z, sigma2) of
   the same evidence through the forward and backward kernels
   (``.backward()``); both counters positive, the evidence within 2e-5
   relative of the truth, each gradient group within 1e-3 relative
   (2-norm) of the f64 twin's on the card.  Block 8,192, not bench.py's
   16,384: 62 CTAs fill half the card's 132 SMs.
7. fit     -- ``optim.fit`` for 10 L-BFGS iterations on bench.py's training
   recipe (yf = sin(X (0.3 k + 0.2)) + 0.3 noise, the noise drawn here;
   pack from log_ell 0.5, sigma2 1.0; variational): finite, with a mean NLL
   that decreases, through both kernels.
Timings: median of 5 after a warm-up, host clock around synchronised
calls.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises (exit code 1).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models import streaming
from gpr_tpu_torch.models.fitc import calc_inducing
from gpr_tpu_torch.numerics.linalg import inv_tri_upper
from gpr_tpu_torch.ops import _build, fused_stats
from gpr_tpu_torch.optim import fit, make_pack

N, D, M = 1_000_000, 8, 300
LOG_ELL, LOG_SF2, SIGMA2, JITTER = 0.5, 0.0, 0.1, 1e-6
TRUTH = -2123659.4  # bench.py's f64 evidence for exactly this draw
BLOCK = 8192
SOURCE = "gpr_tpu_torch/csrc/se_iso_stats.cu"
BWD_SOURCE = "gpr_tpu_torch/csrc/se_iso_bwd.cu"
KERNELS = {  # forward wrapper -> the Pallas body it replaces
    "se_iso_stream_stats_fused_acc": "gpr_tpu/ops/fused_stats.py:121",
    "se_iso_stream_stats_fused": "gpr_tpu/ops/fused_stats.py:79",
}
BWD_KERNEL = "se_iso_stream_bwd_fused"
BWD_REPLACES = "gpr_tpu/ops/fused_stats.py:341"
COUNTED = (*KERNELS, BWD_KERNEL)
FIELDS = ("G", "u", "sum_log_s", "y_is_y", "is_r", "n_live")
BWD_FIELDS = ("log_ell", "log_sf2", "z", "u_inv", "sigma2", "y")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi.splitlines()[0]


def build_phase() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    path = _build.library_path()
    log(f"build: {secs:.1f} s -> {path.name}")
    build_log = path.with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")


def rel_errors(got, want):
    """Per-output relative errors (Frobenius for G and u)."""
    return {
        name: float(torch.linalg.norm(g.double() - w.double())
                    / torch.linalg.norm(w.double()))
        for name, g, w in zip(FIELDS, got, want)
    }


def check_errors(tag, errs):
    log(f"  {tag}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for name, err in errs.items():
        bound = 1e-4 if name in ("G", "u") else 1e-5
        if not err <= bound:
            raise AssertionError(f"{tag}: {name} rel err {err:.3e} > {bound}")


def stats_inputs(kernel, z, sigma2, X, y, jitter=None):
    """Positional inputs of the ops wrappers for one problem."""
    inducing = calc_inducing(kernel, z, jitter)
    return (kernel.log_ell.detach(), kernel.log_sf2.detach(), z,
            inv_tri_upper(inducing.chol_km).contiguous(), sigma2, X, y)


def as_f64(args):
    return [None if a is None else a.double() for a in args]


def kernels_phase(dev) -> None:
    rng = np.random.default_rng(1)
    params = {"log_ell": np.float32(LOG_ELL), "log_sf2": np.float32(LOG_SF2)}
    for n, m, masked in ((65_536, 300, 0), (100_003, 37, 1_000)):
        X = torch.as_tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        Z = rng.standard_normal((m, D)).astype(np.float32)
        mask = None
        if masked:
            mask = torch.ones(n, dtype=torch.float32, device=dev)
            mask[-masked:] = 0.0
        with torch.no_grad():
            kernel, z, s2 = from_jax_params(params, Z, np.float32(SIGMA2),
                                            device=dev, dtype=torch.float32)
            args = [*stats_inputs(kernel, z, s2, X, y), mask]
            want = fused_stats._se_iso_stats_reference(
                *as_f64(args), block_size=BLOCK, acc_dtype=torch.float64)
            if int(want[-1]) != n - masked:
                raise AssertionError(f"twin counted {int(want[-1])} rows")
            for name in KERNELS:
                got = getattr(fused_stats, name)(
                    *args, block_size=BLOCK, acc_dtype=torch.float64)
                torch.cuda.synchronize()
                check_errors(f"kernels n={n} m={m} masked={masked} {name}",
                             rel_errors(got, want))


def epilogue_cotangents(kernel64, z64, stats):
    """The real cotangents of the evidence's epilogue at ``stats`` (f64;
    variational, so all five are nonzero)."""
    with torch.no_grad():
        inducing = calc_inducing(kernel64, z64, JITTER)
    leaves = [s.detach().double().requires_grad_(True) for s in stats[:5]]
    value = streaming.evidence_from_stats(
        inducing, streaming.StreamStats(*leaves, stats[5].double()),
        variational=True)
    return torch.autograd.grad(value, leaves)


def bwd_errors(got, want):
    """Relative errors of the backward outputs (Frobenius for z, u_inv and
    y); the kernel returns only the upper triangle of u_inv_bar."""
    errs = {}
    for name, g, w in zip(BWD_FIELDS, got, want):
        if g is None:
            continue
        if name == "u_inv":
            g, w = g.triu(), w.triu()
        errs[name] = float(torch.linalg.norm(g.double() - w.double())
                           / torch.linalg.norm(w.double()))
    return errs


def check_bwd(tag, errs):
    log(f"  {tag}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for name, err in errs.items():
        if not err <= 1e-4:
            raise AssertionError(f"{tag}: {name} rel err {err:.3e} > 1e-4")


def bwd_phase(dev) -> None:
    rng = np.random.default_rng(2)
    params = {"log_ell": np.float32(LOG_ELL), "log_sf2": np.float32(LOG_SF2)}
    for n, m, masked in ((65_536, 300, 0), (100_003, 37, 1_000)):
        X = torch.as_tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        Z = rng.standard_normal((m, D)).astype(np.float32)
        mask = None
        if masked:
            mask = torch.ones(n, dtype=torch.float32, device=dev)
            mask[-masked:] = 0.0
        with torch.no_grad():
            kernel, z, s2 = from_jax_params(params, Z, np.float32(SIGMA2),
                                            device=dev, dtype=torch.float32)
            args = [*stats_inputs(kernel, z, s2, X, y), mask]
            stats = fused_stats._se_iso_stats_reference(
                *as_f64(args), block_size=BLOCK, acc_dtype=torch.float64)
        k64, z64, _ = from_jax_params(params, Z, np.float32(SIGMA2),
                                      device=dev, dtype=torch.float64)
        cot32 = [c.float() for c in epilogue_cotangents(k64, z64, stats)]
        with torch.no_grad():
            got = fused_stats.se_iso_stream_bwd_fused(
                *args, *cot32, block_size=BLOCK, acc_dtype=torch.float64)
            torch.cuda.synchronize()
            want = fused_stats._se_iso_bwd_reference(
                *as_f64(args), *as_f64(cot32), block_size=BLOCK,
                acc_dtype=torch.float64)
        check_bwd(f"bwd n={n} m={m} masked={masked}", bwd_errors(got, want))


def median_ms(fn, reps=5) -> float:
    """Host clock around synchronised calls: median of ``reps`` after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def counted(tag, fn, must_launch):
    """Run one main path with every launch counter set to 0 just before it;
    return (fn's result, the counts read just after).  Fails unless each
    kernel in ``must_launch`` launched."""
    for name in COUNTED:
        getattr(fused_stats, name).launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: getattr(fused_stats, name).launches for name in COUNTED}
    log(f"{tag} launches: {launches}")
    missing = [name for name in must_launch if not launches[name] > 0]
    if missing:
        raise AssertionError(f"{tag}: a kernel of the path never launched: "
                             f"{missing}")
    return out, launches


def bench_data(dev):
    """bench.py's draw, in its order: X, y (f32 on the card) and Z."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)
    Z = rng.standard_normal((M, D)).astype(np.float32)
    return torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev), Z


def bench_model(dev, Z, dtype):
    params = {"log_ell": np.float32(LOG_ELL), "log_sf2": np.float32(LOG_SF2)}
    return from_jax_params(params, Z, np.float32(SIGMA2), device=dev,
                           dtype=dtype)


def slice_phase(dev, card: str, data) -> list[dict]:
    X32, y32, Z = data
    k32, z32, s32 = bench_model(dev, Z, torch.float32)
    k64, z64, s64 = bench_model(dev, Z, torch.float64)
    X64, y64 = X32.double(), y32.double()

    # -- the main path, through the entry points, counted
    def serve():
        with torch.no_grad():
            evidence = {
                impl: float(streaming.streaming_log_evidence(
                    k32, z32, s32, X32, y32, jitter=JITTER,
                    block_size=BLOCK, impl=impl))
                for impl in ("fused_acc", "fused")
            }
            _, _, coeffs = streaming.streaming_coeffs(
                k32, z32, s32, X32, y32, jitter=JITTER, block_size=BLOCK)
            means = streaming.predict_means_blocked(k32, z32, coeffs, X32,
                                                    block_size=65_536)
        return evidence, coeffs, means

    (evidence, coeffs, means), launches = counted("slice", serve, KERNELS)

    # -- checks against the pinned truth and the f64 twin
    with torch.no_grad():
        ev64 = float(streaming.streaming_log_evidence(
            k64, z64, s64, X64, y64, jitter=JITTER, block_size=BLOCK,
            impl="reference"))
        _, _, coeffs64 = streaming.streaming_coeffs(
            k64, z64, s64, X64, y64, jitter=JITTER, block_size=BLOCK,
            impl="reference")
    for impl, ev in evidence.items():
        rel = (ev - TRUTH) / abs(TRUTH)
        log(f"slice evidence f32 impl={impl}: {ev:.3f} (truth {TRUTH}; "
            f"{ev - TRUTH:+.3f} nats, rel {rel:+.2e})")
        if not abs(rel) <= 2e-5:
            raise AssertionError(f"impl={impl} evidence off by rel {rel:.2e}")
    log(f"slice evidence f64 twin: {ev64:.4f} ({ev64 - TRUTH:+.4f} nats)")
    if not abs(ev64 - TRUTH) <= 1.0:
        raise AssertionError(f"f64 twin evidence off by {ev64 - TRUTH:+.4f}")
    c_rel = float(torch.linalg.norm(coeffs.double() - coeffs64)
                  / torch.linalg.norm(coeffs64))
    log(f"slice coeffs rel err vs f64 twin: {c_rel:.2e}; means "
        f"{tuple(means.shape)} finite={bool(torch.isfinite(means).all())}")
    if not c_rel <= 1e-3:
        raise AssertionError(f"coefficients off by rel {c_rel:.2e}")
    if tuple(means.shape) != (N,) or not bool(torch.isfinite(means).all()):
        raise AssertionError("predicted means are not finite of shape (N,)")

    # -- each kernel against the twin at the path's shapes, and timings
    with torch.no_grad():
        args = stats_inputs(k32, z32, s32, X32, y32, JITTER)
        want = fused_stats._se_iso_stats_reference(
            *as_f64(args), block_size=BLOCK, acc_dtype=torch.float64)

        def twin32():
            return fused_stats._se_iso_stats_reference(
                *args, block_size=BLOCK, acc_dtype=torch.float32)

        plain_ms = median_ms(twin32)
        log(f"time twin f32 forward stats: {plain_ms:.3f} ms ({card})")
        rows = []
        for name, replaces in KERNELS.items():
            fn = getattr(fused_stats, name)

            def run(fn=fn):
                return fn(*args, block_size=BLOCK, acc_dtype=torch.float32)

            got = fn(*args, block_size=BLOCK, acc_dtype=torch.float64)
            errs = rel_errors(got, want)
            check_errors(f"slice {name}", errs)
            max_abs = max(float((g - w).abs().max())
                          for g, w in zip(got[:2], want[:2]))
            ms = median_ms(run)
            log(f"time {name}: {ms:.3f} ms vs twin {plain_ms:.3f} ms; "
                f"max |err| of G and u {max_abs:.3e} ({card})")
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            })

        for impl in ("fused_acc", "reference"):
            ms = median_ms(lambda impl=impl: streaming.streaming_log_evidence(
                k32, z32, s32, X32, y32, jitter=JITTER, block_size=BLOCK,
                impl=impl))
            log(f"time evidence f32 impl={impl}: {ms:.3f} ms ({card})")
        ms = median_ms(lambda: streaming.predict_means_blocked(
            k32, z32, coeffs, X32, block_size=65_536))
        log(f"time predict means 1M: {ms:.3f} ms = {N / ms / 1e3:.1f} M "
            f"pts/s ({card})")
    return rows


def step_phase(dev, card: str, data) -> dict:
    X32, y32, Z = data

    def value_and_grad(dtype, impl, X, y):
        kernel, z, s2 = bench_model(dev, Z, dtype)
        z.requires_grad_(True)
        s2.requires_grad_(True)
        ev = streaming.streaming_log_evidence(
            kernel, z, s2, X, y, jitter=JITTER, block_size=BLOCK, impl=impl)
        ev.backward()
        return ev.item(), (kernel.log_ell.grad, kernel.log_sf2.grad, z.grad,
                           s2.grad)

    # -- the main path, through the entry point, counted
    (ev, grads), launches = counted(
        "step", lambda: value_and_grad(torch.float32, "fused_acc", X32, y32),
        ("se_iso_stream_stats_fused_acc", BWD_KERNEL))
    rel = (ev - TRUTH) / abs(TRUTH)
    log(f"step evidence f32: {ev:.3f} ({ev - TRUTH:+.3f} nats, rel "
        f"{rel:+.2e})")
    if not abs(rel) <= 2e-5:
        raise AssertionError(f"step evidence off by rel {rel:.2e}")
    _, grads64 = value_and_grad(torch.float64, "reference", X32.double(),
                                y32.double())
    for name, g, w in zip(("log_ell", "log_sf2", "z", "sigma2"), grads,
                          grads64):
        err = float(torch.linalg.norm(g.double() - w) / torch.linalg.norm(w))
        log(f"step grad {name}: rel err {err:.2e} vs f64 twin (|grad| "
            f"{float(torch.linalg.norm(w)):.4e})")
        if not (err <= 1e-3 and bool(torch.isfinite(g).all())):
            raise AssertionError(f"step grad {name} off by rel {err:.3e}")

    # -- timings of the step, and the backward kernel alone at its shapes
    for impl in ("fused_acc", "reference"):
        ms = median_ms(lambda impl=impl: value_and_grad(torch.float32, impl,
                                                        X32, y32))
        log(f"time value+grad f32 impl={impl}: {ms:.3f} ms ({card})")
    k32, z32, s32 = bench_model(dev, Z, torch.float32)
    k64, z64, _ = bench_model(dev, Z, torch.float64)
    with torch.no_grad():
        args = stats_inputs(k32, z32, s32, X32, y32, JITTER)
        stats = fused_stats.se_iso_stream_stats_fused_acc(
            *args, block_size=BLOCK, acc_dtype=torch.float64)
    cot32 = [c.float() for c in epilogue_cotangents(k64, z64, stats)]
    kernel_fn = getattr(fused_stats, BWD_KERNEL)
    with torch.no_grad():
        got = kernel_fn(*args, None, *cot32, block_size=BLOCK,
                        acc_dtype=torch.float64, need_y=False)
        want = fused_stats._se_iso_bwd_reference(
            *as_f64(args), None, *as_f64(cot32), block_size=BLOCK,
            acc_dtype=torch.float64, need_y=False)
        check_bwd(f"step {BWD_KERNEL}", bwd_errors(got, want))
        max_abs = max(float((got[2] - want[2]).abs().max()),
                      float((got[3].triu() - want[3].triu()).abs().max()))
        ms = median_ms(lambda: kernel_fn(
            *args, None, *cot32, block_size=BLOCK, acc_dtype=torch.float32,
            need_y=False))
        plain_ms = median_ms(lambda: fused_stats._se_iso_bwd_reference(
            *args, None, *cot32, block_size=BLOCK, acc_dtype=torch.float32,
            need_y=False))
    log(f"time {BWD_KERNEL}: {ms:.3f} ms vs twin {plain_ms:.3f} ms; max "
        f"|err| of z_bar and u_inv_bar {max_abs:.3e} ({card})")
    return {
        "name": BWD_KERNEL, "route": "cuda", "source": BWD_SOURCE,
        "replaces": BWD_REPLACES, "launches": launches[BWD_KERNEL],
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
    }


def fit_phase(dev, card: str, data) -> None:
    X32, _, Z = data
    w = torch.arange(D, dtype=torch.float32, device=dev) * 0.3 + 0.2
    noise = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    yf = torch.sin(X32 @ w) + 0.3 * torch.as_tensor(noise, device=dev)
    kernel = SeIso(LOG_ELL, LOG_SF2, device=dev, dtype=torch.float32)
    pack = make_pack(kernel, torch.as_tensor(Z, device=dev), 1.0)
    with torch.no_grad():
        f0 = -float(streaming.streaming_log_evidence(
            *pack.unpack(pack.x0), X32, yf, variational=True,
            block_size=BLOCK)) / N
    t0 = time.perf_counter()
    (_, _, s2, st), _ = counted(
        "fit", lambda: fit(X32, yf, pack, variational=True,
                           streaming_block_size=BLOCK, max_iter=10,
                           epsabs=1e-4),
        ("se_iso_stream_stats_fused_acc", BWD_KERNEL))
    secs = time.perf_counter() - t0
    f, gnorm = float(st.f), float(torch.linalg.norm(st.g))
    log(f"fit: n_iter {st.n_iter}, n_evals {st.n_evals}, failed "
        f"{st.failed}, mean NLL {f0:.6f} -> {f:.6f}, |g| {gnorm:.3e}, "
        f"sigma2 {float(s2):.4f}, {secs:.2f} s = "
        f"{1e3 * secs / st.n_evals:.1f} ms per evaluation ({card})")
    if not (np.isfinite(f) and bool(torch.isfinite(st.x).all())):
        raise AssertionError("fit: non-finite objective or iterate")
    if not (st.n_iter >= 1 and f < f0):
        raise AssertionError(f"fit: mean NLL did not decrease ({f0} -> {f})")


def main() -> int:
    card = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    kernels_phase(dev)
    bwd_phase(dev)
    data = bench_data(dev)
    rows = slice_phase(dev, card, data)
    rows.append(step_phase(dev, card, data))
    fit_phase(dev, card, data)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
