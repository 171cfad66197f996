"""What every cell shares: the manifest and its files found by name, the
chip check, the device trace and its reduction, the per-layer readers, the
comparison's report and the result line."""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded: the JAX stack and the
#: JAX package the program was ported from (compared whole, so the
#: program's own ``gpr_tpu_torch`` is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpr_tpu")
#: benchmark spans in the device trace
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One run of one workload: its manifest entry, configuration and
    traffic, and the run's arguments."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    chips: int
    t_start: float  # unix time at process start
    device: str = "cuda"

    @property
    def name(self) -> str:
        return self.workload["name"]


def resolve(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of ``workload``, each file
    found by its name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(HERE.parent / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return w, cfg, traffic


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def driver(name: str):
    """The traffic's driver module ``drivers/<name>.py``, imported by its
    name (a driver's ranks import it again by that name)."""
    import importlib

    if not (HERE / "drivers" / f"{name}.py").is_file():
        raise SystemExit(f"benchmark/drivers/{name}.py is missing")
    return importlib.import_module(f"drivers.{name}")


def reader(metric: str):
    """The per-layer metric's reader ``metrics/<metric>.py``: its
    ``read(evidence)`` returns the value or None where the run gave it
    nothing to read."""
    return _load(HERE / "metrics" / f"{metric}.py",
                 "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def _load(path: Path, modname: str):
    if modname in sys.modules:
        return sys.modules[modname]
    if not path.is_file():
        raise SystemExit(f"{path.relative_to(HERE.parent)} is missing")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ comparison

@dataclasses.dataclass
class Check:
    """One number compared with its limit; ``at_least`` for a number that
    has to reach the limit, else it may not pass it."""

    name: str
    value: float
    limit: float
    at_least: bool = False

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.value >= self.limit if self.at_least \
            else self.value <= self.limit

    def line(self) -> str:
        op = ">=" if self.at_least else "<="
        return (f"check {self.name} = {self.value!r} (limit {op} "
                f"{self.limit!r}): {'ok' if self.ok else 'FAILED'}")


def check_report(checks: list[Check]) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit,
                     "holds": ">=" if c.at_least else "<="} for c in checks}


# ------------------------------------------------------------ outcome

@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the counts, the end-to-end values, what
    the per-layer readers read (``evidence``), the comparison and the
    device readings."""

    attempted: int
    failed: int
    e2e: dict
    evidence: dict
    checks: list
    memory_peak_bytes: int
    window_s: float
    t_window: float  # unix time at the window's start
    busy_s: float | None = None
    breakdown: dict | None = None
    launches: dict | None = None
    kind: str = ""
    count: int = 1


def launch_counters() -> dict:
    """The program's kernel launch counters by wrapper name."""
    from gpr_tpu_torch.ops import fused_stats, gemm_chain

    return {
        "se_iso_stream_stats_fused_acc":
            fused_stats.se_iso_stream_stats_fused_acc,
        "se_iso_stream_stats_fused": fused_stats.se_iso_stream_stats_fused,
        "se_iso_stream_bwd_fused": fused_stats.se_iso_stream_bwd_fused,
        "gemm_chain": gemm_chain,
    }


def reset_launches() -> None:
    for w in launch_counters().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in launch_counters().items()}


# ------------------------------------------------------------ the trace

class DeviceTrace:
    """``torch.profiler`` over the window when ``enabled``: the device's
    operations (kernels, copies, sets), their time by name, the busy time
    and the idle gaps labelled by what the host was doing.  The window is
    the ``bench.window`` span the driver opens inside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self.prof)
            self.prof = None
        return False


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """Reduce the profiler's events to the window's device time: busy
    seconds, time and launches by operation name, idle gaps by host
    activity."""
    events = prof.profiler.kineto_results.events()
    dev, host, spans = [], [], []
    w0 = w1 = None
    for e in events:
        kind = str(e.device_type())
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        if kind.endswith("CUDA"):
            # the device's copy of a host span is no device work
            if not name.startswith(SPAN_PREFIX):
                dev.append((s, s + d, name))
        else:
            if name == WINDOW_SPAN:
                w0, w1 = s, s + d
            elif name.startswith(SPAN_PREFIX):
                spans.append((s, s + d, name))
            elif d < 10**9:
                host.append((s, s + d, name))
    if w0 is None:
        raise RuntimeError("the trace holds no bench.window span")
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev
           if e > w0 and s < w1]
    by_name: dict = {}
    for s, e, n in dev:
        key = short_name(n)
        t, c = by_name.get(key, (0.0, 0))
        by_name[key] = (t + (e - s) * 1e-9, c + 1)
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # idle gaps inside the window, the longest labelled by the host
    gaps = []
    prev = w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    longest_host = max((h[1] - h[0] for h in host), default=0)
    spans.sort()
    span_starts = [h[0] for h in spans]
    labelled: dict = {}
    for g0, g1 in gaps[:4000]:
        mid = (g0 + g1) // 2
        label = _covering(host, starts, mid, longest_host)
        outer = _covering(spans, span_starts, mid, None)
        name = f"{outer or 'no span'}: {label}"
        labelled[name] = labelled.get(name, 0.0) + (g1 - g0) * 1e-9
    top_ops = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "by_name": by_name,
        "device_ops": [[n, t] for n, (t, _) in top_ops[:10]],
        "idle_gaps": sorted(([n, t] for n, t in labelled.items()),
                            key=lambda kv: kv[1], reverse=True)[:10],
    }


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip()
    return name.strip()


def _covering(events, starts, t, longest):
    """The innermost event that covers time t, else 'after <the last one
    that ended before t>'."""

    i = bisect.bisect_right(starts, t)
    best = None
    last_before = None
    j = i - 1
    while j >= 0:
        s, e, n = events[j]
        if longest is not None and t - s > longest:
            break
        if e >= t:
            if best is None or (e - s) < (best[1] - best[0]):
                best = events[j]
        elif last_before is None or e > last_before[1]:
            last_before = events[j]
        j -= 1
        if longest is None and best is not None:
            break
    if best is not None:
        return best[2]
    if last_before is not None:
        return f"after {last_before[2]}"
    return None


def kernel_stats(by_name: dict, *fragments) -> tuple[float, int]:
    """Summed seconds and launches of the device operations whose name
    holds any of ``fragments``."""
    t, c = 0.0, 0
    for name, (secs, count) in by_name.items():
        if any(f in name for f in fragments):
            t += secs
            c += count
    return t, c


# ------------------------------------------------------------ the result

def device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards (a card below its
    700 W runs slower under load)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def per_layer(manifest: dict, cell: Cell, evidence: dict) -> dict:
    """The per-layer metrics of this cell that its readers found."""
    out = {}
    for m in manifest["per_layer"]:
        if not _reports(manifest, m, cell.name):
            continue
        value = reader(m["name"]).read(evidence)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _reports(manifest, metric: dict, cell: str) -> bool:
    cells = metric.get("workloads")
    if cells is not None:
        return cell in cells
    moves = metric.get("moves")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    if moves in e2e:
        return _reports(manifest, e2e[moves], cell)
    return True


def end_to_end(manifest: dict, cell: Cell, values: dict) -> dict:
    """The cell's end-to-end metrics from the driver's values.  A metric
    named ``<base>.<variant>`` is the driver's ``<base>`` in the cells the
    manifest gives the variant, under a bound of its own."""
    out = {}
    for m in manifest["end_to_end"]:
        if not _reports(manifest, m, cell.name):
            continue
        name = m["name"]
        value = values.get(name, values.get(name.split(".", 1)[0]))
        if value is None:
            raise RuntimeError(f"the driver gave no {name}")
        out[name] = {"value": value, "unit": m["unit"]}
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def now() -> float:
    return time.time()
