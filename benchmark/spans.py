"""The program's spans over a traced window (``gpr_tpu_torch.tracing``),
for the per-layer readers that read them: the recording, counts and
summed durations, computed from the raw records.

A recording holds the spans since a span last found the profiler off; the
drivers' untraced warm-up ends the one before, so in a traced run it
covers the window.  A program without the module, an untraced run and a
recording without the spans asked for all read None (a data-parallel
cell's readers run in the parent process, which recorded nothing)."""

from __future__ import annotations


def recorded(ev) -> list | None:
    """The window's spans, or None where there are none to read."""
    if ev.get("trace") is None:
        return None
    try:
        from gpr_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.recorded() or None


def named(spans, *names) -> list:
    return [s for s in spans if s.name in names]


def total_ms(spans, *names) -> float:
    """Summed milliseconds of the spans called any of ``names``."""
    return sum(s.t1_ns - s.t0_ns for s in named(spans, *names)) * 1e-6


def less_ms(spans, name, *inner) -> float:
    """Summed milliseconds of the spans called ``name`` less those of the
    spans called any of ``inner`` beneath them (at any depth; ``inner``
    spans do not nest in one another)."""
    want = {s.seq for s in named(spans, name)}
    parent = {s.seq: s.parent for s in spans}
    total = total_ms(spans, name) * 1e6
    for s in named(spans, *inner):
        up = s.parent
        while up != -1 and up not in want:
            up = parent.get(up, -1)
        if up != -1:
            total -= s.t1_ns - s.t0_ns
    return total * 1e-6
