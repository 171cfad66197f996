"""Data-parallel training: the closed loop of ``fitloop`` through
``parallel.sharded.fit_sharded`` on a 1-D mesh of ranks spawned by
``parallel.spmd.run_spmd`` (NCCL, one card a rank, where the machine has a
card for each).  Every rank draws the whole data from the seed on its own
card (nothing is pickled but the arguments) and keeps its block of rows;
the L-BFGS runs in lock step on every rank, and rank 0 decides when the
window closes and tells the others with one broadcast a chunk.  Rank 0
compares with the reference over all the rows once the window is done."""

from __future__ import annotations

import time

import torch

import counts
import data
import fitloop
from harness import DeviceTrace, Outcome, read_launches, reset_launches


def _rank(mesh, cell, limits):
    """One rank's run; rank 0 returns the outcome."""
    import torch.distributed as dist

    from gpr_tpu_torch.parallel.sharded import fit_sharded

    cfg, tr = cell.config, cell.traffic
    dev = mesh.device
    X, y = data.regression(cfg, cell.seed, dev)
    start = fitloop.starts(cfg, cell.seed, X)

    def chunk_fn(pack, st, max_iter):
        return fit_sharded(mesh, X, y, pack, variational=cfg["variational"],
                           block_size=cfg["block"], max_iter=max_iter,
                           dispatch_iters=tr["chunk_iters"],
                           epsabs=tr["epsabs"],
                   init_state=st)[3]

    def agree(stop):
        flag = torch.tensor(float(stop), device=dev)
        return bool(mesh.broadcast(flag) > 0)

    pack, _ = start("warm")
    chunk_fn(pack, None, tr["warm_iters"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reset_launches()
    dist.barrier()
    t_window = time.time()
    with DeviceTrace(cell.trace) as trace:
        chunks, secs = fitloop.run_window(chunk_fn, start, tr, cell.seconds,
                                          agree)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    mine = {"peak": peak, "launches": read_launches(),
            "busy_s": trace.summary["busy_s"] if trace.summary else None}
    every = [None] * mesh.size
    dist.all_gather_object(every, mine)
    if mesh.rank != 0:
        return None
    tot = fitloop.totals(chunks)
    checks, _ = fitloop.compare(cfg, tr, limits, cell.seed, chunks, X, y,
                                block=cfg["block"])
    e2e = {"train_eval_ms": 1e3 * secs / tot["evals"]}
    rows = -(-cfg["n"] // mesh.size)
    busy = [e["busy_s"] for e in every]
    evidence = {
        "kind": "train", "window_s": secs, "chips": mesh.size,
        "evals": tot["evals"], "iters": tot["iters"],
        "flops_per_eval": counts.eval_flops(cfg["family"], cfg["n"],
                                            cfg["d"], cfg["m"]),
        "rows_per_launch": rows, "config": cfg,
        "trace": trace.summary, "launches": mine["launches"],
    }
    return Outcome(
        attempted=tot["chunks"], failed=tot["failed"], e2e=e2e,
        evidence=evidence, checks=checks,
        memory_peak_bytes=max(e["peak"] for e in every),
        window_s=trace.summary["window_s"] if trace.summary else secs,
        t_window=t_window,
        busy_s=(sum(busy) / len(busy) if all(b is not None for b in busy)
                else None),
        breakdown=({k: trace.summary[k] for k in ("device_ops", "idle_gaps")}
                   if trace.summary else None),
        launches={"ranks": [e["launches"] for e in every],
                  **{k: tot[k] for k in ("evals", "iters", "chunks", "fits")}},
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=mesh.size)


def run(cell, limits: dict) -> Outcome:
    from gpr_tpu_torch.parallel.spmd import run_spmd

    platform = "cuda" if cell.device == "cuda" else "cpu"
    return run_spmd(_rank, cell.chips, cell, limits, platform=platform,
                    timeout=300.0)
