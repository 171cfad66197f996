"""Serving on one card: set-up conditions the model once
(``models.streaming.streaming_trained``); the window is a closed loop of
one client whose every request asks for the means and the variances
(``predict_means_blocked``, ``predict_variances_blocked``: the command
line's ``-cmd test -with-stddev``) of a block of test points drawn ahead on
the card, and ends when both are in host memory."""

from __future__ import annotations

import time

import numpy as np
import torch

import data
import fitloop
from harness import (
    WINDOW_SPAN,
    Check,
    DeviceTrace,
    Outcome,
    log,
    read_launches,
    reset_launches,
)
from reference import gp


class Server:
    """The program's conditioned model and its two predictors."""

    def __init__(self, cfg, hp, X, y, block):
        from gpr_tpu_torch.models.streaming import streaming_trained

        self.kernel = fitloop.make_kernel(cfg, hp, X.device)
        self.z = hp["z"]
        self.sigma2 = torch.tensor(hp["sigma2"], dtype=torch.float32,
                                   device=X.device)
        self.block = block
        tr = streaming_trained(self.kernel, self.z, self.sigma2, X, y,
                               variational=cfg["variational"],
                               block_size=cfg["block"])
        self.coeffs = tr.coeffs
        self.chol_km = tr.model.inducing.chol_km
        self.r_mat = tr.model.r_mat

    def means(self, xt):
        from gpr_tpu_torch.models.streaming import predict_means_blocked

        return predict_means_blocked(self.kernel, self.z, self.coeffs, xt,
                                     block_size=self.block)

    def variances(self, xt):
        from gpr_tpu_torch.models.streaming import predict_variances_blocked

        return predict_variances_blocked(self.kernel, self.z, self.chol_km,
                                         self.r_mat, xt, self.sigma2,
                                         predictive=False,
                                         block_size=self.block)


def requests(cfg, tr, seed, dev):
    """The pool of test points on the card, and each request's (offset,
    size) and whether the comparison samples it, in order."""
    pool_n = tr["pool_points"]
    pool = torch.randn((pool_n, cfg["d"]), generator=data.generator(
        seed, "pool", device=dev), device=dev, dtype=torch.float32)
    count = tr["max_requests"]
    sizes = data.request_sizes(tr, seed, count)
    g = data.generator(seed, "offsets")
    u = torch.rand((count,), generator=g, dtype=torch.float64).tolist()
    offsets = [int(v * (pool_n - s)) for v, s in zip(u, sizes)]
    keep = (torch.rand((count,), generator=data.generator(seed, "sample"),
                       dtype=torch.float64) < tr["check_rate"]).tolist()
    return pool, list(zip(offsets, sizes, keep))


def hypers(cfg, tr, seed, X):
    hp = data.start(cfg, seed, "serve", X)
    hp["sigma2"] = float(tr["sigma2"])
    return hp


def run(cell, limits: dict) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    X, y = data.regression(cfg, cell.seed, dev)
    hp = hypers(cfg, tr, cell.seed, X)
    server = Server(cfg, hp, X, y, tr["block"])
    pool, reqs = requests(cfg, tr, cell.seed, dev)
    cuda = dev.type == "cuda"
    # warm-up: the largest request and a ragged one
    for size in (tr["points"][1], tr["points"][0] + 1):
        server.means(pool[:size]).cpu()
        server.variances(pool[:size]).cpu()
    if cuda:
        torch.cuda.synchronize(dev)
    reset_launches()
    lat, points, kept, events = [], 0, [], []
    largest = (-1, None)
    t_window = time.time()
    with DeviceTrace(cell.trace) as trace:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            for i, (off, size, keep) in enumerate(reqs):
                xt = pool[off:off + size]
                r0 = time.perf_counter()
                with torch.profiler.record_function("bench.request"):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(3)] if cuda else None
                    if cuda:
                        ev[0].record()
                    mu = server.means(xt)
                    if cuda:
                        ev[1].record()
                    var = server.variances(xt)
                    if cuda:
                        ev[2].record()
                    mu_h, var_h = mu.cpu(), var.cpu()
                lat.append(time.perf_counter() - r0)
                points += size
                if cuda:
                    events.append((ev, size))
                if keep:
                    kept.append((off, size, mu_h, var_h))
                if size > largest[0]:
                    largest = (size, (off, size, mu_h, var_h))
                if time.perf_counter() - t0 >= cell.seconds:
                    break
            else:
                raise RuntimeError("the window outlasted max_requests")
            secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = read_launches()
    means_ms = sum(e[0].elapsed_time(e[1]) for e, _ in events)
    var_ms = sum(e[1].elapsed_time(e[2]) for e, _ in events)
    if largest[1] is not None and largest[1][0] not in {k[0] for k in kept}:
        kept.append(largest[1])
    del server
    checks = compare(cfg, hp, X, y, pool, kept, limits)
    slow = sorted(lat)[-max(1, len(lat) // 100):]
    log(f"latency ms: median {1e3 * float(np.median(lat)):.3f}, max "
        f"{1e3 * max(lat):.3f}; the slowest 1% took {sum(slow):.3f} s "
        f"of the window's {secs:.3f}")
    e2e = {"predict_mpts_per_s": points / secs / 1e6,
           "predict_p95_ms": 1e3 * float(np.percentile(lat, 95))}
    evidence = {
        "kind": "serve", "window_s": secs, "chips": 1,
        "requests": len(lat), "points": points,
        "means_ms": means_ms if cuda else None,
        "variances_ms": var_ms if cuda else None,
        "config": cfg, "trace": trace.summary, "launches": launches,
    }
    return Outcome(
        attempted=len(lat), failed=0, e2e=e2e, evidence=evidence,
        checks=checks, memory_peak_bytes=peak,
        window_s=trace.summary["window_s"] if trace.summary else secs,
        t_window=t_window,
        busy_s=trace.summary["busy_s"] if trace.summary else None,
        breakdown=({k: trace.summary[k] for k in ("device_ops", "idle_gaps")}
                   if trace.summary else None),
        launches={**launches, "requests": len(lat), "points": points},
        count=1)


def compare(cfg, hp, X, y, pool, kept, limits, *, precision="f64",
            answers=None):
    """The sampled requests' means and variances against the reference's,
    conditioned anew in f64 from X, y and the hypers:

    * means_gap: relative 2-norm error of a request's means;
    * var_gap: relative 2-norm error of its variances.

    ``answers(xt) -> (means, variances)``, where given, stands in for the
    program's answers (the control)."""
    x = data.pack_vector(cfg, hp)
    post = gp.condition(cfg, x, X, y, precision="f64", block=cfg["block"])
    mg, vg = 0.0, 0.0
    for off, size, mu, var in kept:
        xt = pool[off:off + size]
        if answers is not None:
            mu, var = (t.cpu() for t in answers(xt))
        mr, vr = gp.predict(post, xt, block=cfg["block"])
        mr, vr = mr.cpu(), vr.cpu()
        mg = max(mg, float(torch.linalg.norm(mu.double() - mr)
                           / torch.linalg.norm(mr)))
        vg = max(vg, float(torch.linalg.norm(var.double() - vr)
                           / torch.linalg.norm(vr)))
    log(f"compared {len(kept)} requests, "
        f"{sum(k[1] for k in kept)} points")
    if not kept:
        return [Check("requests_compared", 0, 1, at_least=True)]
    return [Check("means_gap", mg, limits["means_gap"]),
            Check("var_gap", vg, limits["var_gap"])]
