"""Auxiliary subsystems: timing, profiling, debug checks, structured
logging.  The counterpart of ``gpr_tpu/utils.py`` (the reference's aux
layer, SURVEY.md section 5):

  * ``timing``: wall-clock printf (lib/utils.ml:50-55), and
    ``profile_trace``, a ``torch.profiler`` trace of a region (JAX's
    ``jax.profiler`` hook);
  * debug-gated invariant checks (lib/utils.ml:34,118-192), cheap
    assertions toggled by ``config.debug``, and ``debug_nans``, PyTorch's
    anomaly mode (JAX's ``jax_debug_nans``);
  * structured (jsonl) iteration logs for the training callbacks;
  * ``to_bf16_stochastic``, unbiased bf16 quantization with the noise bits
    drawn from a ``torch.Generator`` (JAX's takes a key).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from .config import config


@contextlib.contextmanager
def timing(label: str, stream=sys.stderr):
    """Wall-clock timing context (reference Utils.timing, lib/utils.ml:50-55)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"{label}: {time.perf_counter() - t0:.3f}s", file=stream)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` around a region, the card's activity included
    where there is one; the trace lands in ``logdir/trace.json`` (Chrome
    trace format) and the profiler is yielded for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """PyTorch's anomaly mode (``torch.autograd.set_detect_anomaly``): a
    backward that produces NaN raises, naming the forward op that made it
    (SURVEY.md section 5's analogue of sanitizers)."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu()
    return np.asarray(a)


def check_finite(name: str, *arrays):
    """Debug-gated invariant check (on the host).  No-op unless
    config.debug, mirroring the reference's ``debug``-guarded sparse sanity
    checks (lib/utils.ml:118-192)."""
    if not config.debug:
        return
    for i, a in enumerate(arrays):
        a = _host(a)
        if not np.all(np.isfinite(a)):
            bad = np.argwhere(~np.isfinite(a))[:5]
            raise FloatingPointError(
                f"check_finite({name}): array {i} has non-finite entries at "
                f"{bad.tolist()}"
            )


def check_symmetric(name: str, a, tol=1e-8):
    """Debug-gated symmetry check for covariance matrices."""
    if not config.debug:
        return
    a = _host(a)
    err = np.abs(a - a.T).max()
    if err > tol * max(1.0, np.abs(a).max()):
        raise AssertionError(f"check_symmetric({name}): asymmetry {err:.3e}")


class JsonlLogger:
    """Structured training log: one json object per event.

    Plug into train() callbacks::

        log = JsonlLogger(path)
        train(..., report_trained_model=lambda iter, trained:
                  log.write(iter=iter, l=float(trained.l)))
    """

    def __init__(self, path_or_stream):
        if hasattr(path_or_stream, "write"):
            self._fh = path_or_stream
            self._own = False
        else:
            self._fh = open(path_or_stream, "a")
            self._own = True

    def write(self, **event):
        event.setdefault("ts", time.time())
        event = {
            k: (float(v) if isinstance(v, (torch.Tensor, np.floating)) else v)
            for k, v in event.items()
        }
        self._fh.write(json.dumps(event) + "\n")
        self._fh.flush()

    def close(self):
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _round_bits(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """bf16 of the f32 ``x`` after adding ``noise`` (integers in [0, 2^16))
    to its bit pattern and dropping the low 16 bits, in unsigned 32-bit
    arithmetic (carried in int64: torch has no uint32 add)."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = ((bits + noise.to(torch.int64)) & 0xFFFF0000)
    rounded = torch.where(rounded >= 2 ** 31, rounded - 2 ** 32, rounded)
    return rounded.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def to_bf16_stochastic(generator: torch.Generator | None, x) -> torch.Tensor:
    """Stochastically rounded bfloat16 quantization of an f32 tensor.

    For bf16 *storage* of very large inputs (half the bytes in memory).
    Stochastic rounding keeps the quantization unbiased: E[q(x)] = x, so
    data-sum statistics see noise, not bias, unlike round-to-nearest.

    The JAX package's bit-level construction: bf16 is f32 with the low 16
    mantissa bits dropped, so adding uniform random low bits before
    truncation rounds up with probability equal to the truncated fraction.
    The noise bits come from ``generator`` (on x's device).
    """
    x = torch.as_tensor(x).to(torch.float32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          device=x.device, dtype=torch.int64)
    return _round_bits(x, noise)
