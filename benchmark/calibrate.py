"""Readings from which the limits of ``benchmark/limits/<cell>.json`` are
set: for each seed, the numbers compared for the program as it is (sound
runs, short windows) and for the controls and planted faults put in its
place, at the cell's own size, all in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 \
        --seconds 5

Training cells (read on one card; the data-parallel cell's states come
from the same loop through ``optim.fit`` over all its rows, and its
exchange fault is rank 0's un-reduced evidence):

* ``control_tf32``: the reference computed in TF32 (the lower-precision
  control); ``program_tf32``: the program with its own TF32 switch
  (``config.matmul_precision = "high"``);
* ``half_batch``: the program's objective over every other row, the mean
  taken over them;
* ``altered``: the program's answer with the log_sf2 gradient zeroed;
* ``no_exchange`` (configs with ``ranks``): each rank's statistics left
  un-reduced, rank 0's value, the ranks' gradients averaged;
* ``unchanged``: a fit that does not move reads first_chunk_drop 0 by
  construction and needs no run.

Serving: ``control_tf32`` (reference conditioned and predicting in TF32),
``program_tf32``, ``half_batch`` (conditioned on every other row),
``altered`` (the last hundredth of each request's means zeroed).

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import torch  # noqa: E402

import data  # noqa: E402
import fitloop  # noqa: E402
import harness  # noqa: E402
from reference import gp  # noqa: E402


class tf32_program:
    """The program's own TF32 switch, on inside."""

    def __enter__(self):
        from gpr_tpu_torch.config import config

        self.saved = config.matmul_precision
        config.matmul_precision = "high"

    def __exit__(self, *exc):
        from gpr_tpu_torch.config import config

        config.matmul_precision = self.saved


def program_fg(cfg, pack):
    """(x, X, y, scale) -> the program's (value, gradient) of the scaled
    negative streaming evidence."""
    from gpr_tpu_torch.models.streaming import streaming_log_evidence
    from gpr_tpu_torch.optim import value_and_grad

    def f(x, X, y, scale):
        k, z, s2 = pack.unpack(x)
        return -streaming_log_evidence(
            k, z, s2, X, y, variational=cfg["variational"],
            block_size=cfg["block"]) * scale

    return value_and_grad(f)


def train_readings(cell, limits, which):
    from drivers import fit as fit_driver

    cfg, tr = cell.config, cell.traffic
    X, y, start, chunk_fn = fit_driver.setup(cell)
    chunks, secs = fitloop.run_window(chunk_fn, start, tr, cell.seconds)
    n = cfg["n"]
    pack, _ = start("calibrate")
    fg = program_fg(cfg, pack)
    sf2 = dict(fitloop.groups(cfg))["log_sf2"]

    def tf32_ref(x):
        return gp.neg_mean_evidence(cfg, x, X, y, precision="tf32",
                                    block=cfg["block"])

    def tf32_prog(x):
        with tf32_program():
            return fg(x, X, y, 1.0 / n)

    def half(x):
        return fg(x, X[::2].contiguous(), y[::2].contiguous(),
                  1.0 / X[::2].shape[0])

    def altered(x):
        f, g = fg(x, X, y, 1.0 / n)
        g = g.clone()
        g[sf2] = 0.0
        return f, g

    def no_exchange(x):
        p = cfg["ranks"]
        rows = -(-n // p)
        parts = [fg(x, X[r * rows:(r + 1) * rows], y[r * rows:(r + 1) * rows],
                    1.0 / n) for r in range(p)]
        return parts[0][0], sum(g for _, g in parts) / p

    answers = {"program": None, "control_tf32": tf32_ref,
               "program_tf32": tf32_prog, "half_batch": half,
               "altered": altered}
    if "ranks" in cfg:
        answers["no_exchange"] = no_exchange
    out = {"evals": sum(c.evals for c in chunks),
           "iters": sum(c.iters for c in chunks), "window_s": secs}
    for name, fn in answers.items():
        if which and name not in which and name != "program":
            continue
        t0 = time.perf_counter()
        checks, info = fitloop.compare(cfg, tr, limits, cell.seed, chunks,
                                       X, y, block=cfg["block"], program=fn)
        out[name] = {c.name: c.value for c in checks}
        out[name]["groups"] = info["grad_gap_groups"]
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def serve_readings(cell, limits, which):
    from drivers import serve

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    X, y = data.regression(cfg, cell.seed, dev)
    hp = serve.hypers(cfg, tr, cell.seed, X)
    server = serve.Server(cfg, hp, X, y, tr["block"])
    pool, reqs = serve.requests(cfg, tr, cell.seed, dev)
    kept, t0, largest = [], time.perf_counter(), (-1, None)
    for off, size, keep in reqs:
        xt = pool[off:off + size]
        mu, var = server.means(xt).cpu(), server.variances(xt).cpu()
        if keep:
            kept.append((off, size, mu, var))
        if size > largest[0]:
            largest = (size, (off, size, mu, var))
        if time.perf_counter() - t0 >= cell.seconds:
            break
    if largest[1][0] not in {k[0] for k in kept}:
        kept.append(largest[1])
    with tf32_program():
        server32 = serve.Server(cfg, hp, X, y, tr["block"])
    half_server = serve.Server(cfg, hp, X[::2].contiguous(),
                               y[::2].contiguous(), tr["block"])
    post32 = gp.condition(cfg, data.pack_vector(cfg, hp), X, y,
                          precision="tf32", block=cfg["block"])

    def prog32(xt):
        with tf32_program():
            return server32.means(xt), server32.variances(xt)

    def altered(xt):
        mu = server.means(xt).clone()
        mu[-max(1, mu.shape[0] // 100):] = 0.0
        return mu, server.variances(xt)

    answers = {
        "program": None,
        "control_tf32": lambda xt: gp.predict(post32, xt,
                                              block=cfg["block"]),
        "program_tf32": prog32,
        "half_batch": lambda xt: (half_server.means(xt),
                                  half_server.variances(xt)),
        "altered": altered,
    }
    out = {"requests_compared": len(kept)}
    for name, fn in answers.items():
        if which and name not in which and name != "program":
            continue
        t0 = time.perf_counter()
        checks = serve.compare(cfg, hp, X, y, pool, kept, limits,
                               answers=fn)
        out[name] = {c.name: c.value for c in checks}
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--only", default="",
                   help="comma-separated readings beside the program's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the readings are the card's")
        return 2
    manifest = harness.load_json(Path.cwd() / "BENCHMARK.json")
    w, cfg, traffic = harness.resolve(manifest, args.workload)
    limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")
    which = set(filter(None, args.only.split(",")))
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(workload=w, config=cfg, traffic=traffic,
                            seed=seed, seconds=args.seconds, trace=False,
                            chips=1, t_start=time.time())
        reading = (serve_readings if traffic["driver"] == "serve"
                   else train_readings)(cell, limits, which)
        print(json.dumps({"workload": w["name"], "seed": seed, **reading}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
