"""Training on one card: the closed loop of ``fitloop`` through
``gpr_tpu_torch.optim.fit`` on the streaming evidence (the default route:
the CUDA statistics kernels for SE-iso in f32, the plain loop for every
other family)."""

from __future__ import annotations

import time

import torch

import counts
import data
import fitloop
from harness import (
    DeviceTrace,
    Outcome,
    log,
    read_launches,
    reset_launches,
)


def setup(cell):
    """The data, the starts and the chunk function, warmed up on a start
    of its own at the cell's shapes."""
    from gpr_tpu_torch.optim import fit

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    X, y = data.regression(cfg, cell.seed, dev)
    start = fitloop.starts(cfg, cell.seed, X)

    def chunk_fn(pack, st, max_iter):
        return fit(X, y, pack, variational=cfg["variational"],
                   streaming_block_size=cfg["block"], max_iter=max_iter,
                   dispatch_iters=tr["chunk_iters"],
                   epsabs=tr["epsabs"], init_state=st)[3]

    pack, _ = start("warm")
    chunk_fn(pack, None, tr["warm_iters"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return X, y, start, chunk_fn


def run(cell, limits: dict) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    X, y, start, chunk_fn = setup(cell)
    reset_launches()
    t_window = time.time()
    with DeviceTrace(cell.trace) as trace:
        chunks, secs = fitloop.run_window(chunk_fn, start, tr, cell.seconds)
    cuda = X.is_cuda
    peak = torch.cuda.max_memory_allocated(X.device) if cuda else 0
    launches = read_launches()
    tot = fitloop.totals(chunks)
    log("chunks, ms an evaluation / evaluations: "
        + fitloop.chunk_times(chunks))
    checks, _ = fitloop.compare(cfg, tr, limits, cell.seed, chunks, X, y,
                                block=cfg["block"])
    e2e = {"train_eval_ms": 1e3 * secs / tot["evals"]}
    evidence = {
        "kind": "train", "window_s": secs, "chips": 1,
        "evals": tot["evals"], "iters": tot["iters"],
        "flops_per_eval": counts.eval_flops(cfg["family"], cfg["n"],
                                            cfg["d"], cfg["m"]),
        "rows_per_launch": cfg["n"], "config": cfg,
        "trace": trace.summary, "launches": launches,
    }
    return Outcome(
        attempted=tot["chunks"], failed=tot["failed"], e2e=e2e,
        evidence=evidence, checks=checks, memory_peak_bytes=peak,
        window_s=trace.summary["window_s"] if trace.summary else secs,
        t_window=t_window,
        busy_s=trace.summary["busy_s"] if trace.summary else None,
        breakdown=({k: trace.summary[k] for k in ("device_ops", "idle_gaps")}
                   if trace.summary else None),
        launches={**launches, **{k: tot[k] for k in
                                 ("evals", "iters", "chunks", "fits")}},
        count=1)
