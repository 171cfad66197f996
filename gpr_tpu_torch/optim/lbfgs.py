"""L-BFGS with a strong-Wolfe line search on the host: the counterpart of
``gpr_tpu/optim/lbfgs.py`` (the reference's GSL ``VECTOR_BFGS2``).

The two-loop recursion and the zoom line search run in numpy between
objective calls; each call is one value-and-gradient of the objective on its
device, so the host work is negligible.  The code is the JAX package's, kept
here as the port's own copy (it is numpy only), so both walk the same
iterates.  ``step`` sizes the first trial along the normalized
steepest-descent direction; ``tol`` is the curvature (Wolfe c2) accuracy of
the line search.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class LBFGSResult:
    x: np.ndarray
    f: float
    g: np.ndarray
    n_iter: int
    converged: bool


@dataclasses.dataclass
class LBFGSHostState:
    """Complete optimizer state of the host loop: resuming from this
    reproduces the uninterrupted trajectory exactly (same curvature history,
    same incumbent, same iteration count).  The reference's GSL state is
    opaque and unsaveable (SURVEY.md section 5: training resume doesn't
    exist); this is the rebuild's addition."""

    x: np.ndarray
    f: float
    g: np.ndarray
    s_hist: list  # list of (n,) arrays, oldest first
    y_hist: list
    rho_hist: list  # list of floats
    n_iter: int


def _strong_wolfe(fg, x, f0, g0, p, alpha0, c1=1e-4, c2=0.1, max_evals=25):
    """Line search satisfying the strong Wolfe conditions (zoom algorithm,
    Nocedal & Wright alg. 3.5/3.6).  ``fg`` returns (f, g); minimization."""
    dphi0 = float(np.dot(g0, p))
    if dphi0 >= 0:  # not a descent direction; bail to tiny step
        return None
    phi_prev, alpha_prev = f0, 0.0
    alpha = alpha0
    g_alpha = None

    def phi(a):
        return fg(x + a * p)

    def zoom(lo, hi, phi_lo, phi_hi, dphi_lo, evals):
        for _ in range(max_evals - evals):
            a = 0.5 * (lo + hi)
            f_a, g_a = phi(a)
            dphi_a = float(np.dot(g_a, p))
            if not np.isfinite(f_a) or f_a > f0 + c1 * a * dphi0 or f_a >= phi_lo:
                hi, phi_hi = a, f_a
            else:
                if abs(dphi_a) <= -c2 * dphi0:
                    return a, f_a, g_a
                if dphi_a * (hi - lo) >= 0:
                    hi, phi_hi = lo, phi_lo
                lo, phi_lo, dphi_lo = a, f_a, dphi_a
            if abs(hi - lo) < 1e-14 * max(1.0, abs(lo)):
                break
        return (lo, phi_lo, None) if phi_lo < f0 else None

    for i in range(max_evals):
        f_a, g_alpha = phi(alpha)
        dphi_a = float(np.dot(g_alpha, p))
        if not np.isfinite(f_a) or f_a > f0 + c1 * alpha * dphi0 or (
            i > 0 and f_a >= phi_prev
        ):
            z = zoom(alpha_prev, alpha, phi_prev, f_a, dphi0, i + 1)
            if z is None:
                return None
            a, f_z, g_z = z
            if g_z is None:
                f_z, g_z = phi(a)
            return a, f_z, g_z
        if abs(dphi_a) <= -c2 * dphi0:
            return alpha, f_a, g_alpha
        if dphi_a >= 0:
            z = zoom(alpha, alpha_prev, f_a, phi_prev, dphi_a, i + 1)
            if z is None:
                return None
            a, f_z, g_z = z
            if g_z is None:
                f_z, g_z = phi(a)
            return a, f_z, g_z
        alpha_prev, phi_prev = alpha, f_a
        alpha = 2.0 * alpha
    return None


def minimize_lbfgs(
    fg: Callable[[np.ndarray], tuple[float, np.ndarray]],
    x0: np.ndarray,
    *,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int | None = None,
    history: int = 10,
    callback: Callable[[int, np.ndarray, float, np.ndarray], None] | None = None,
    init_state: LBFGSHostState | None = None,
    state_callback: Callable[[LBFGSHostState], None] | None = None,
) -> LBFGSResult:
    """Minimize fg, stopping when |g| < epsabs (the reference's outer loop
    criterion, fitc_gp.ml:1657-1671) or max_iter.

    ``callback(iter, x, f, g)`` fires after every accepted step and may raise
    to interrupt — exceptions propagate (the reference's Bailout/
    Optim_exception tunneling; callers catch and keep the best model).

    ``state_callback(LBFGSHostState)`` fires after every accepted step with
    the full optimizer state; pass a saved state back as ``init_state`` to
    continue an interrupted run on the SAME objective — the trajectory then
    matches the uninterrupted one exactly.  ``max_iter`` counts total
    (cumulative) iterations.
    """
    if init_state is not None:
        x = np.asarray(init_state.x, dtype=np.float64)
        f, g = float(init_state.f), np.asarray(init_state.g, np.float64)
        s_hist = [np.asarray(s, np.float64) for s in init_state.s_hist]
        y_hist = [np.asarray(y, np.float64) for y in init_state.y_hist]
        rho_hist = [float(r) for r in init_state.rho_hist]
        n_iter = int(init_state.n_iter)
    else:
        x = np.asarray(x0, dtype=np.float64)
        f, g = fg(x)
        if not np.isfinite(f):
            raise FloatingPointError("optimization function returned nan")
        s_hist = []
        y_hist = []
        rho_hist = []
        n_iter = 0
    max_iter = max_iter if max_iter is not None else 10_000

    if callback is not None:
        callback(n_iter, x, f, g)

    while np.linalg.norm(g) >= epsabs and n_iter < max_iter:
        # two-loop recursion
        q = g.copy()
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist), reversed(rho_hist)):
            a = rho * np.dot(s, q)
            alphas.append(a)
            q -= a * y
        if y_hist:
            gamma = np.dot(s_hist[-1], y_hist[-1]) / np.dot(y_hist[-1], y_hist[-1])
            q *= gamma
        for (s, y, rho), a in zip(
            zip(s_hist, y_hist, rho_hist), reversed(alphas)
        ):
            b = rho * np.dot(y, q)
            q += (a - b) * s
        p = -q

        gnorm = np.linalg.norm(g)
        alpha0 = 1.0 if y_hist else min(1.0, step / max(gnorm, 1e-30))
        ls = _strong_wolfe(fg, x, f, g, p, alpha0, c2=tol)
        if ls is None and not y_hist:
            # Strong Wolfe failed even along steepest descent (typical on
            # ill-conditioned starts where the curvature test is
            # unsatisfiable at f64 resolution): fall back to plain Armijo
            # backtracking — any decrease keeps the optimization alive,
            # matching GSL BFGS2's grind-through behavior.
            a = alpha0
            for _ in range(40):
                f_a, g_a = fg(x + a * p)
                if np.isfinite(f_a) and f_a < f:
                    ls = (a, f_a, g_a)
                    break
                a *= 0.5
        if ls is None:
            # failed along the quasi-Newton direction; restart from steepest
            # descent once, then give up
            if not y_hist:
                break
            s_hist.clear()
            y_hist.clear()
            rho_hist.clear()
            continue
        alpha, f_new, g_new = ls
        s = alpha * p
        yv = g_new - g
        sy = float(np.dot(s, yv))
        if sy > 1e-12 * np.linalg.norm(s) * np.linalg.norm(yv):
            s_hist.append(s)
            y_hist.append(yv)
            rho_hist.append(1.0 / sy)
            if len(s_hist) > history:
                s_hist.pop(0)
                y_hist.pop(0)
                rho_hist.pop(0)
        x = x + s
        f, g = f_new, g_new
        n_iter += 1
        if callback is not None:
            callback(n_iter, x, f, g)
        if state_callback is not None:
            state_callback(LBFGSHostState(
                x=x.copy(), f=f, g=g.copy(),
                s_hist=list(s_hist), y_hist=list(y_hist),
                rho_hist=list(rho_hist), n_iter=n_iter,
            ))

    return LBFGSResult(
        x=x, f=f, g=g, n_iter=n_iter, converged=bool(np.linalg.norm(g) < epsabs)
    )
