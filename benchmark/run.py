"""The benchmark of gpr_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The workload, its configuration and its
traffic are found by name through ``BENCHMARK.json``; the traffic names
its driver (``benchmark/drivers/<driver>.py``), and each per-layer metric
has its reader (``benchmark/metrics/<metric>.py``).  With ``--trace 0``
the result line holds the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read from a ``torch.profiler`` trace of the window.
The last line of standard output is the result as JSON; the numbers
compared with the plain reference, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the benchmark's modules, and the program in the checkout beside it
sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(manifest, cell, out: harness.Outcome, setup_s: float) -> dict:
    correct = all(c.ok for c in out.checks)
    if cell.trace:
        metrics = harness.per_layer(manifest, cell, out.evidence)
    else:
        metrics = harness.end_to_end(manifest, cell,
                                     {**out.e2e, "setup_s": setup_s})
    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": out.kind or harness.device_name(), "count": out.count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if cell.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if cell.trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = harness.check_report(out.checks)
    return line


def run_cell(manifest: dict, args, *, device: str = "cuda",
             t_start: float = T_START, shrink: dict | None = None) -> dict:
    """Everything after the look for a chip: set-up, the window, the
    comparison and the result line.  The tests enter here on the CPU, with
    ``shrink`` overriding sizes of the configuration and the traffic."""
    w, cfg, traffic = harness.resolve(manifest, args.workload)
    if shrink:
        cfg = {**cfg, **shrink.get("config", {})}
        traffic = {**traffic, **shrink.get("traffic", {})}
    cell = harness.Cell(workload=w, config=cfg, traffic=traffic,
                        seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), chips=w["chips"],
                        t_start=t_start, device=device)
    drv = harness.driver(traffic["driver"])
    limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")
    out = drv.run(cell, limits)
    setup_s = out.t_window - t_start
    line = result(manifest, cell, out, setup_s)
    print(json.dumps({"launches": out.launches, "setup_s": setup_s,
                      "card": harness.card_line() if device == "cuda"
                      else device}), flush=True)
    for c in out.checks:
        harness.log(c.line())
    return line


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").is_file():
        harness.log("run from the root of a checkout: no BENCHMARK.json")
        return 2
    manifest = harness.load_json(root / "BENCHMARK.json")
    w = next((w for w in manifest["workloads"]
              if w["name"] == args.workload), None)
    if w is None:
        harness.log(f"no workload {args.workload!r}")
        return 2
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < w["chips"]:
        harness.log(f"{args.workload} needs {w['chips']} cards, have "
                    f"{torch.cuda.device_count()}")
        return 2
    line = run_cell(manifest, args)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded modules of the JAX stack or package: "
                    f"{found}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
