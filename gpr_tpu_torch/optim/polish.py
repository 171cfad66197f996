"""f64 finishing step for f32 large-n training (the "polish"): the
counterpart of ``gpr_tpu/optim/polish.py``.

After the f32 phase (``fit`` / ``fit_restarts``) picks a basin,
:func:`polish` drives the SAME objective (``optim.train.make_objective``)
to a stationary point in f64 with the host L-BFGS (``optim.lbfgs``), and
:func:`evaluate_f64` scores candidate vectors in f64.  The JAX package runs
both in a child process because a TPU has no f64 and x64 must be set before
its backend starts; in PyTorch f64 is a tensor dtype, so both run in this
process, on the device of the caller's data (the card's native FP64 there).
Cost is bounded by a uniform row ``subsample`` (an unbiased estimate of the
same mean-NLL objective) and ``max_iter``; with ``n <= block_size`` the
objective is the dense engine (the same math on one tile, cheaper).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels.base import hyper_leaves, kernel_with
from .lbfgs import minimize_lbfgs
from .pack import make_pack
from .train import make_objective

F64 = torch.float64


@dataclasses.dataclass
class PolishReport:
    """What the f64 phase did: objective and gradient norm before and after
    (on the polish objective, mean-NLL scale), iteration and evaluation
    counts, wall time."""

    f0: float
    f: float
    gnorm0: float
    gnorm: float
    n_iter: int
    n_evals: int
    n_rows: int
    wall_s: float
    converged: bool


def _subsample(X, y, subsample, seed):
    if subsample is not None and subsample < X.shape[0]:
        idx = np.random.default_rng(seed).choice(X.shape[0], subsample,
                                                 replace=False)
        idx = torch.as_tensor(idx, device=X.device)
        X, y = X[idx], y[idx]
    return X.to(F64), y.to(F64)


def _pack64(pack, x, n_hypers):
    """The pack rebuilt in f64 around the hypers ``x`` unpacks to, with the
    caller's layout options; raises if its vector length is not
    ``n_hypers`` (a layout that cannot be rebuilt)."""
    with torch.no_grad():
        kernel, z, sigma2 = pack.unpack(x.to(F64).to(pack.x0.device))
    names, hypers = hyper_leaves(kernel)
    kernel64 = kernel_with(kernel, {name: t.detach().to(F64)
                                    for name, t in zip(names, hypers)})
    pack64 = make_pack(kernel64, z.detach().to(F64),
                       torch.as_tensor(sigma2).detach().to(F64),
                       learn_sigma2=pack.learn_sigma2,
                       learn_inducing=pack.learn_inducing, fixed=pack.fixed)
    if pack64.n_hypers != int(n_hypers):
        raise RuntimeError(
            f"f64 polish: the rebuilt pack has n_hypers={pack64.n_hypers}, "
            f"the caller's vectors {n_hypers} (a non-default layout?)"
        )
    return pack64


def _objective(X, y, pack64, variational, block_size, normalize,
               value_only=False):
    if block_size is not None and X.shape[0] <= block_size:
        block_size = None  # one tile: the dense engine is the same math
    return make_objective(X, y, pack64, variational=variational,
                          normalize=normalize, block_size=block_size,
                          value_only=value_only)[0]


def polish(X, y, pack, x, *, variational: bool = False,
           subsample: int | None = 100_000, seed: int = 0,
           max_iter: int = 40, epsabs: float = 1e-2, step: float = 0.1,
           tol: float = 0.1, block_size: int | None = 8192,
           timeout_s: float = 900.0):
    """Polish a trained hyper vector ``x`` in f64, on the device of ``X``.

    Returns ``(kernel, z, sigma2, x_polished, PolishReport)`` in the pack's
    dtype and device, ready for predictors or further work.  ``epsabs``
    applies to the mean-NLL gradient norm.  ``subsample`` bounds the cost;
    None uses every row.  Raises ``RuntimeError`` when the pack cannot be
    rebuilt in f64 or the run outlasts ``timeout_s`` (checked between
    iterations).
    """
    X64, y64 = _subsample(X, y, subsample, seed)
    x = torch.as_tensor(x).detach()
    pack64 = _pack64(pack, x, pack.n_hypers)
    fg = _objective(X64, y64, pack64, variational, block_size, True)
    evals = [0]

    def counted(xv):
        evals[0] += 1
        f, g = fg(torch.as_tensor(xv, dtype=F64, device=X64.device))
        return float(f), g.cpu().numpy()

    x0 = pack64.x0.cpu().numpy()
    f0, g0 = counted(x0)
    t0 = time.perf_counter()

    def deadline(*_):
        if time.perf_counter() - t0 > timeout_s:
            raise RuntimeError(f"f64 polish timed out after {timeout_s} s")

    res = minimize_lbfgs(counted, x0, step=step, tol=tol, epsabs=epsabs,
                         max_iter=max_iter, callback=deadline)
    wall = time.perf_counter() - t0
    rep = PolishReport(
        f0=f0, f=float(res.f), gnorm0=float(np.linalg.norm(g0)),
        gnorm=float(np.linalg.norm(res.g)), n_iter=int(res.n_iter),
        n_evals=evals[0], n_rows=int(X64.shape[0]), wall_s=wall,
        converged=bool(res.converged),
    )
    x_f = torch.as_tensor(res.x, dtype=pack.x0.dtype, device=pack.x0.device)
    kernel, z, sigma2 = pack.unpack(x_f)
    return kernel, z, sigma2, x_f, rep


def evaluate_f64(X, y, pack, xs, *, variational: bool = False,
                 subsample: int | None = 20_000, seed: int = 0,
                 block_size: int | None = 8192, timeout_s: float = 600.0,
                 normalize: bool = True):
    """The objective at each packed vector of ``xs`` in f64 on the device
    of ``X``, on one shared row subsample (so a ranking by it is
    consistent).  ``normalize`` selects the mean-NLL scale.  Returns a list
    of floats, ``inf`` where an evaluation failed or was not finite.
    Raises ``RuntimeError`` when the pack cannot be rebuilt in f64 or the
    evaluations outlast ``timeout_s``."""
    X64, y64 = _subsample(X, y, subsample, seed)
    xs64 = torch.stack([torch.as_tensor(v).detach().to(F64).cpu()
                        for v in xs])
    pack64 = _pack64(pack, xs64[0], xs64.shape[1])
    f_of = _objective(X64, y64, pack64, variational, block_size, normalize,
                      value_only=True)
    t0 = time.perf_counter()
    fs = []
    for xv in xs64:
        if time.perf_counter() - t0 > timeout_s:
            raise RuntimeError(f"f64 evaluation timed out after {timeout_s} s")
        try:
            f = float(f_of(xv.to(X64.device)))
        except Exception:  # noqa: BLE001 -- rank a dead point last
            f = float("inf")
        fs.append(f if np.isfinite(f) else float("inf"))
    return fs
