"""The yardstick's arithmetic: peaks of one NVIDIA H100, the least time a
kernel could take, the operations of one value+grad evaluation from its
shapes, and an nvidia-smi sampler of the SM clock and the power draw.

The bounds and the sampler are frozen copies of ``chip_smoke.py``'s
(``bound``, ``stats_bound``, ``bwd_bound``, ``chain_bound``,
``clock_log``, ``read_clock_log``, ``clock_window``); later changes to the
program cannot move them.
"""

from __future__ import annotations

import subprocess
from datetime import datetime

PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores (H100 SXM data sheet)
HBM = 3.35e12  # bytes/s


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the flops at the
    FP32 peak and the bytes at the HBM rate."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / HBM
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _stats_fma(n, d, m):
    return n * (m * d + m * (m + 1) + m)


def _bwd_fma(n, d, m):
    return n * (m * d + 3 * m * (m + 1) // 2 + m * m + m * (d + 2))


def stats_bound(n, d, m) -> dict:
    """Forward statistics over n live rows: per row m d (x z'), m (m + 1)/2
    (V against the upper-triangular U^-1), m (m + 1)/2 (the symmetric Gram)
    and m (u) FMAs; X, y, z and U^-1 read, G, u and 4 scalars written."""
    return bound(2.0 * _stats_fma(n, d, m),
                 4.0 * (n * (d + 1) + m * d + 2 * m * m + m + 4))


def bwd_bound(n, d, m) -> dict:
    """The backward tile over n rows: per row m d (Knm), m (m + 1)/2 (V),
    m^2 (VG), m (m + 1)/2 (Kb against U^-T), m (m + 1)/2 (the upper
    triangle of Knm' Vb) and m (d + 2) (the pullback) FMAs; X, y, z, U^-1,
    U^-T, UG and u-bar read, z-bar, U^-1-bar and 3 scalars written."""
    return bound(2.0 * _bwd_fma(n, d, m),
                 4.0 * (n * (d + 1) + 2 * m * d + 4 * m * m + m + 3))


def chain_bound(n, m, reps) -> dict:
    """x W^reps: 2 n m^2 reps flops; x and W read, out written."""
    return bound(2.0 * n * m * m * reps, 4.0 * (2 * n * m + m * m))


def epilogue_flops(m) -> float:
    """The O(m^3) work of one evaluation, forward and backward: the
    Cholesky of K(Z, Z) (m^3/3 FMAs), U^-1 (m^3/3), the Cholesky of I + G
    (m^3/3), and their backward at twice that."""
    return 2.0 * 3.0 * m ** 3


def eval_flops(family: str, n: int, d: int, m: int, big_d: int | None = None
               ) -> float:
    """Operations of one value+grad evaluation of the streaming evidence
    over n rows with m inducing points, counted from the shapes whatever
    implements it: the O(n m^2) statistics and their backward as
    ``stats_bound`` and ``bwd_bound`` count them, the family's own O(n m d)
    covariance work in place of SE-iso's, and the epilogue.

    se_fat (projection ``big_d`` -> d, multiscales on): per row D d FMAs
    to project, m (2 d + 1) for the cross covariance as one augmented
    product; backward the same again to recompute it, m (2 d + 1) and m 2 d
    for the pullback's two products, and D d for the projection's."""
    if family == "se_iso":
        fma = _stats_fma(n, d, m) + _bwd_fma(n, d, m)
    elif family == "se_fat":
        big_d = d if big_d is None else big_d
        cross = m * (2 * d + 1)
        # the SE-iso counts less their m d (x z') and m (d + 2) terms
        fma = (_stats_fma(n, d, m) - n * m * d + n * (big_d * d + cross)
               + _bwd_fma(n, d, m) - n * (m * d + m * (d + 2))
               + n * (big_d * d + cross + cross + 2 * d * m + big_d * d))
    else:
        raise ValueError(f"no operation count for the family {family!r}")
    return 2.0 * fma + epilogue_flops(m)


def clock_log() -> subprocess.Popen:
    """Start nvidia-smi sampling the SM clock and the power draw every 100
    ms; stop it with read_clock_log."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def read_clock_log(proc: subprocess.Popen) -> list[tuple]:
    """Stop the sampler; its samples as (unix time, SM MHz, W)."""
    proc.terminate()
    out = proc.communicate(timeout=60)[0]
    samples = []
    for line in out.splitlines():
        try:
            stamp, mhz, watts = (f.strip() for f in line.split(","))
            samples.append((datetime.strptime(
                stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp(), int(mhz),
                float(watts)))
        except ValueError:
            continue
    return samples


def clock_window(samples, t0, t1) -> str:
    """The SM clock range and the peak power among the samples in [t0,
    t1]."""
    window = [(mhz, watts) for t, mhz, watts in samples if t0 <= t <= t1]
    if not window:
        return "clock not sampled"
    return (f"SM clock {min(c for c, _ in window)}-"
            f"{max(c for c, _ in window)} MHz, power up to "
            f"{max(p for _, p in window):.0f} W")
