"""The closed loop of L-BFGS fits that the training cells drive, and the
comparison of what its window produced with the plain reference.

A fit runs in chunks of ``chunk_iters`` iterations through the library's
own resume (``init_state``) up to ``max_iter``, with the traffic's
gradient tolerance ``epsabs`` on the mean NLL.  It ends, and a new seeded
start begins, when the library's chunk driver would stop it: the gradient
under that tolerance, a failed line search, a non-finite objective,
``max_iter``, or a chunk that gains no more than ten noise amplitudes
(``optim.lbfgs_device._chunk_loop``'s rule, with its f32 noise amplitude
5e-7).  The window closes at the first chunk boundary after the run's
seconds.
"""

from __future__ import annotations

import dataclasses
import time

import torch

import data
from harness import WINDOW_SPAN, Check, log
from reference import gp

F_NOISE = 5e-7  # the library's f32 default (optim.fit)


@dataclasses.dataclass
class Chunk:
    fit: int
    index: int  # the chunk's number within its fit
    x_start: torch.Tensor
    x_end: torch.Tensor
    f: float
    g: torch.Tensor
    evals: int
    iters: int
    finite: bool
    secs: float = 0.0  # the chunk's host-clock seconds, its host reads in


def make_kernel(cfg: dict, hp: dict, device):
    """The program's kernel module for the start ``hp``, in f32."""
    from gpr_tpu_torch.kernels.se_fat import SeFat
    from gpr_tpu_torch.kernels.se_iso import SeIso

    kw = {"device": device, "dtype": torch.float32}
    if cfg["family"] == "se_iso":
        return SeIso(hp["log_ell"], hp["log_sf2"], **kw)
    return SeFat(cfg["d_proj"], hp["log_sf2"], tproj=hp["tproj"],
                 log_hetero_skedasticity=hp["log_hetero_skedasticity"],
                 log_multiscales_m05=hp["log_multiscales_m05"], **kw)


def starts(cfg: dict, seed: int, X):
    """fit number -> (the program's pack, the benchmark's own x0)."""
    from gpr_tpu_torch.optim import make_pack

    def start(i):
        hp = data.start(cfg, seed, i, X)
        pack = make_pack(make_kernel(cfg, hp, X.device), hp["z"],
                         hp["sigma2"])
        x0 = data.pack_vector(cfg, hp)
        gap = float(torch.max(torch.abs(pack.x0 - x0)))
        if pack.x0.shape != x0.shape or gap > 1e-6:
            raise RuntimeError(f"the program packs the start otherwise than "
                               f"its documented layout ({gap})")
        return pack, x0

    return start


def run_window(chunk_fn, start, traffic: dict, seconds: float,
               agree=lambda stop: stop):
    """Drive fits until ``seconds`` have passed; returns (chunks, seconds
    the window took).  ``chunk_fn(pack, state, max_iter)`` runs one chunk
    and returns the new state; ``agree`` turns this process's wish to stop
    into the decision every rank takes."""
    chunk_iters, max_iter = traffic["chunk_iters"], traffic["max_iter"]
    eps = traffic["epsabs"]
    chunks: list[Chunk] = []
    fit, st, k, f_prev = 0, None, 0, None
    with torch.profiler.record_function(WINDOW_SPAN):
        t0 = time.perf_counter()
        while True:
            if st is None:
                # a new fit: its start's evaluation alone (max_iter 0), so
                # that its answer there is in hand, then its chunks
                pack, x0 = start(fit)
                x_start, k, f_prev = x0, 0, None
                before, target = (0, 0), 0
            else:
                x_start = st.x
                before = (st.n_evals, st.n_iter)
                target = min(before[1] + chunk_iters, max_iter)
            c0 = time.perf_counter()
            with torch.profiler.record_function("bench.chunk"):
                st = chunk_fn(pack, st, target)
            f = float(st.f)
            finite = all(bool(torch.isfinite(t).all())
                         for t in (st.f, st.x, st.g))
            chunks.append(Chunk(fit, k, x_start.detach(),
                                st.x.detach().clone(), f,
                                st.g.detach().clone(),
                                st.n_evals - before[0], st.n_iter - before[1],
                                finite, time.perf_counter() - c0))
            done = (st.n_iter >= max_iter or st.failed or not finite
                    or float(torch.linalg.norm(st.g)) < eps
                    or (f_prev is not None and f_prev - f <= 10.0 * F_NOISE))
            f_prev = f
            k += 1
            if done:
                fit, st = fit + 1, None
            if agree(time.perf_counter() - t0 >= seconds):
                break
        secs = time.perf_counter() - t0
    return chunks, secs


def chunk_times(chunks) -> str:
    """Each chunk's milliseconds an evaluation, in order: a host stall
    shows as one chunk far above the others."""
    return " ".join(f"{1e3 * c.secs / max(c.evals, 1):.1f}/{c.evals}"
                    for c in chunks)


def totals(chunks) -> dict:
    evals = sum(c.evals for c in chunks)
    iters = sum(c.iters for c in chunks)
    return {"evals": evals, "iters": iters, "chunks": len(chunks),
            "fits": len({c.fit for c in chunks}),
            "failed": sum(not c.finite for c in chunks)}


def groups(cfg: dict) -> list[tuple[str, slice]]:
    """The packed vector's gradient groups (reference.gp.unpack's
    layout)."""
    m, dz, d = cfg["m"], cfg.get("d_proj", cfg["d"]), cfg["d"]
    sizes = {"log_ell": 1, "log_sf2": 1, "log_hetero_skedasticity": m,
             "log_multiscales_m05": m * dz, "tproj": d * dz}
    out, at = [("log_sigma2", slice(0, 1))], 1
    for name in cfg["packed_fields"]:
        out.append((name, slice(at, at + sizes[name])))
        at += sizes[name]
    out.append(("z", slice(at, at + m * dz)))
    return out


def compare(cfg: dict, traffic: dict, limits: dict, seed: int, chunks,
            X, y, *, block: int = 8192, program=None
            ) -> tuple[list[Check], dict]:
    """The window's answers against the reference, on fits drawn from the
    seed among those whose first chunk the window finished: the program's
    value and gradient at the fit's start (its first evaluation), at the
    end of its first chunk and at the end of one more chunk drawn at
    random.

    * nll_gap: |program - reference| of the mean negative log evidence;
    * grad_gap: per gradient group, the 2-norm of program - reference over
      the reference's norm of that group at the fit's start (where the
      gradient is far above f32's rounding of it);
    * first_chunk_drop: the reference's fall of the objective over the
      fit's first chunk (a fit that does not move reads 0).

    ``program(x) -> (f, g)``, where given, answers in the program's place
    (a control, or a planted fault)."""
    fits = sorted({c.fit for c in chunks if c.index == 1})
    g = data.generator(seed, "check")
    order = torch.randperm(len(fits), generator=g).tolist()
    sampled = [fits[i] for i in order[:traffic["check_fits"]]]
    ref_at = {}

    def ref(x):
        key = x.data_ptr()
        if key not in ref_at:
            ref_at[key] = gp.neg_mean_evidence(cfg, x, X, y, block=block)
        return ref_at[key]

    nll_gap, grad_gap, drops, worst = 0.0, 0.0, [], {}
    for fit in sampled:
        mine = [c for c in chunks if c.fit == fit]
        at_start, first = mine[0], mine[1]
        extra = mine[1 + int(torch.randint(len(mine) - 1, (),
                                           generator=g))]
        _, g0r = ref(at_start.x_end)
        for c in {id(c): c for c in (at_start, first, extra)}.values():
            fr, gr = ref(c.x_end)
            fp, gp_ = (c.f, c.g) if program is None else program(c.x_end)
            nll_gap = max(nll_gap, abs(float(fp) - float(fr)))
            for name, sl in groups(cfg):
                scale = float(torch.linalg.norm(g0r[sl]))
                e = float(torch.linalg.norm(gp_[sl].to(gr) - gr[sl])) \
                    / max(scale, 1e-300)
                worst[name] = max(worst.get(name, 0.0), e)
                grad_gap = max(grad_gap, e)
        drops.append(float(ref(at_start.x_end)[0])
                     - float(ref(first.x_end)[0]))
    checks = [
        Check("nll_gap", nll_gap, limits["nll_gap"]),
        Check("grad_gap", grad_gap, limits["grad_gap"]),
        Check("first_chunk_drop", min(drops) if drops else float("nan"),
              limits["first_chunk_drop"], at_least=True),
    ]
    log(f"compared fits {sampled}: grad_gap by group {worst}, "
        f"first_chunk_drop each {drops}")
    return checks, {"fits": sampled, "grad_gap_groups": worst,
                    "drops": drops}
