"""A traced run of one cell, as ``run.py --trace 1`` makes it, and what the
program's spans (``gpr_tpu_torch.tracing``) did in it:

    python3 benchmark/tracecheck.py --workload <name> --seed <n> \
        --seconds <s> [--out <file>]

It prints one JSON line: the seconds the trace's reduction took
(``harness.summarize``, the post-window cost that every span adds to) and,
with ``--again``, the same reduction of the same events timed once more
and without any ``gpr.`` host event, beside the longest host event in
each; the spans recorded, by name (count, summed and self milliseconds),
and how many were evaluations beside the window's evaluations; each
span's record against the profiler's own host event of the same name (the
start and end offsets in microseconds: the record's clock against the
profiler's); the names of device events that carry a ``gpr.`` name (a
span copied onto the device's timeline would read as busy); the window's
counters, the per-layer metrics and the labelled idle gaps.  On a checkout
whose program has no spans it reports the reduction alone.  ``--out``
writes the line to a file as well.  One card; a data-parallel cell's
ranks reduce in their own processes, so run the single-card cells."""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import harness  # noqa: E402
import run  # noqa: E402


def _spans():
    try:
        from gpr_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.recorded()


def _offsets(events, spans) -> dict:
    """Each span against the profiler's host event of its name that it
    lies closest to: microseconds from the event's start to the record's,
    and from the record's end to the event's."""
    by_name: dict = {}
    for e in events:
        if str(e.device_type()).endswith("CPU") and e.name().startswith(
                "gpr."):
            by_name.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for v in by_name.values():
        v.sort()
    starts, ends, unmatched = [], [], 0
    for s in spans:
        cands = by_name.get(s.name)
        if not cands:
            unmatched += 1
            continue
        i = bisect.bisect_left(cands, (s.t0_ns,))
        e0, e1 = min(cands[max(i - 1, 0):i + 1],
                     key=lambda c: abs(c[0] - s.t0_ns))
        starts.append((s.t0_ns - e0) * 1e-3)
        ends.append((e1 - s.t1_ns) * 1e-3)

    def stats(v):
        if not v:
            return None
        q = statistics.quantiles(v, n=100) if len(v) > 1 else v * 99
        return {"median": statistics.median(v), "p99": q[98],
                "min": min(v), "max": max(v)}

    return {"matched": len(starts), "unmatched": unmatched,
            "start_us": stats(starts), "end_us": stats(ends)}


def _by_span(spans) -> dict:
    """name -> [count, summed ms, self ms] (self: less what the span's
    direct children cover)."""
    out: dict = {}
    kids: dict = {}
    for s in spans:
        c = out.setdefault(s.name, [0, 0.0, 0.0])
        c[0] += 1
        c[1] += (s.t1_ns - s.t0_ns) * 1e-6
        kids.setdefault(s.parent, []).append((s.t0_ns, s.t1_ns))
    for s in spans:
        covered, end = 0, s.t0_ns
        for a, b in sorted(kids.get(s.seq, ())):
            a, b = max(a, end), min(b, s.t1_ns)
            if b > a:
                covered, end = covered + b - a, b
        out[s.name][2] += (s.t1_ns - s.t0_ns - covered) * 1e-6
    return out


class _Events:
    """A stand-in for a profiler whose trace holds ``events``."""

    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def _reduce_s(events, drop) -> float:
    kept = [e for e in events if not (
        str(e.device_type()).endswith("CPU") and drop(e.name()))]
    t0 = time.perf_counter()
    harness.summarize(_Events(kept))
    return time.perf_counter() - t0


def _longest_ms(events, drop) -> float:
    """The longest host event under a second that the reduction keeps
    (``harness.summarize`` scans back that far for each idle gap)."""
    return max((e.duration_ns() for e in events
                if str(e.device_type()).endswith("CPU")
                and not drop(e.name()) and e.duration_ns() < 10**9
                and not e.name().startswith(harness.SPAN_PREFIX)),
               default=0) * 1e-6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    p.add_argument("--again", action="store_true")
    a = p.parse_args(argv)
    manifest = harness.load_json(Path.cwd() / "BENCHMARK.json")
    seen: dict = {}
    reduce = harness.summarize

    def timed(prof):
        t0 = time.perf_counter()
        out = reduce(prof)
        seen["reduce_s"] = time.perf_counter() - t0
        events = prof.profiler.kineto_results.events()
        seen["device_gpr"] = sorted({
            e.name() for e in events
            if not str(e.device_type()).endswith("CPU")
            and "gpr." in e.name()})
        spans = _spans()
        if spans is not None:
            seen["offsets"] = _offsets(events, spans)
        if a.again:
            harness.summarize = reduce
            seen["reduce_again_s"] = {
                "all": _reduce_s(events, lambda n: False),
                "no_gpr": _reduce_s(events, lambda n: n.startswith("gpr.")),
            }
            seen["longest_host_ms"] = {
                "all": _longest_ms(events, lambda n: False),
                "no_gpr": _longest_ms(events, lambda n: n.startswith("gpr.")),
            }
        return out

    harness.summarize = timed
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed),
                      "--seconds", str(a.seconds), "--trace", "1"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = run.run_cell(manifest, args, t_start=T_START)
    counted = json.loads(buf.getvalue().strip().splitlines()[-1])["launches"]
    spans = _spans()
    result = {
        "workload": a.workload, "seed": a.seed, "card": harness.card_line(),
        "correct": line["correct"], "reduce_s": seen.get("reduce_s"),
        "device_events_named_gpr": seen.get("device_gpr"),
        "reduce_again_s": seen.get("reduce_again_s"),
        "longest_host_ms": seen.get("longest_host_ms"),
        "counted": {k: v for k, v in counted.items()
                    if k in ("evals", "iters", "requests", "points")},
        "spans": None if spans is None else len(spans),
        "eval_spans": None if spans is None else sum(
            s.name == "gpr.optim.eval" for s in spans),
        "by_span": None if spans is None else _by_span(spans),
        "offsets": seen.get("offsets"),
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "busy_s": line["device"].get("busy_s"),
        "window_s": line["device"].get("window_s"),
        "breakdown": line.get("breakdown"),
    }
    text = json.dumps(result)
    print(text, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
