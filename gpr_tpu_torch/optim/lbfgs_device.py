"""L-BFGS with the JAX package's device semantics: the counterpart of
``gpr_tpu/optim/lbfgs_device.py``.

There the loop, the curvature history and the strong-Wolfe line search are
``lax`` control flow under one ``jit``.  Here they are Python loops over
tensors that stay on the objective's device; each branch reads one scalar
back, and every objective evaluation already synchronises once (the
forward kernel's wrapper reads its scalars), so the host loop adds no
round trip that matters.  The arithmetic, the acceptance rules and the
counters are the JAX package's, so the two give the same iterates in f64.

Semantics: minimize, stop on |g| < epsabs or max_iter, strong Wolfe
(c1 = 1e-4, c2 = tol) with a secant zoom, ``f_noise`` slack, a best-point
fallback, and history clearing on a failed line search.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch


class LBFGSDeviceState(NamedTuple):
    x: torch.Tensor  # (k,)
    f: torch.Tensor  # scalar
    g: torch.Tensor  # (k,)
    s_hist: torch.Tensor  # (h, k)
    y_hist: torch.Tensor  # (h, k)
    rho: torch.Tensor  # (h,)  0 marks an empty slot
    head: int  # next write position
    n_iter: int
    failed: bool  # line search gave up with no history to drop
    # objective (value + grad) evaluations so far: line-search efficiency
    # is n_evals / n_iter
    n_evals: int


def _two_loop(g, s_hist, y_hist, rho, head, history):
    """Two-loop recursion over a circular buffer; empty slots (rho == 0)
    pass through untouched."""
    q = g
    alphas = torch.zeros(history, dtype=g.dtype, device=g.device)
    for j in range(history):
        idx = (head - 1 - j) % history
        valid = rho[idx] > 0.0
        a = torch.where(valid, rho[idx] * torch.dot(s_hist[idx], q), 0.0)
        q = q - a * y_hist[idx]
        alphas[idx] = a
    # gamma scaling from the most recent pair
    last = (head - 1) % history
    have = rho[last] > 0.0
    yy = torch.dot(y_hist[last], y_hist[last])
    sy = torch.dot(s_hist[last], y_hist[last])
    gamma = torch.where(have & (yy > 0), sy / torch.clamp(yy, min=1e-30), 1.0)
    q = q * gamma
    for j in range(history):
        idx = (head + j) % history
        valid = rho[idx] > 0.0
        b = torch.where(valid, rho[idx] * torch.dot(y_hist[idx], q), 0.0)
        q = q + torch.where(valid, alphas[idx] - b, 0.0) * s_hist[idx]
    return -q


def _wolfe_zoom(fg, x, f0, g0, p, alpha0, c1, c2, max_evals, f_noise=0.0):
    """Strong-Wolfe line search: bracket by doubling, then zoom with a
    secant step on the line derivative (bisection safeguard).  Acceptance
    is sufficient decrease with ``f_noise`` slack plus |dphi(a)| <=
    -c2 dphi(0).  Returns (alpha, f, g, ok, n_evals); a non-finite
    objective value counts as an Armijo failure (step too long)."""
    dphi0 = torch.dot(g0, p)

    def phi(a):
        f, g = fg(x + a * p)
        return f, g, torch.dot(g, p)

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    stage = 0  # 0 = bracketing (doubling), 1 = zooming (secant / bisect)
    a_lo, phi_lo, dphi_lo = zero, f0, dphi0
    a_hi, dphi_hi = zero, zero
    a = torch.as_tensor(alpha0, dtype=x.dtype, device=x.device)
    f_a, g_a = f0, g0
    evals, ok = 0, False
    best_a = a
    best_f = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    # Zoom invariant: a_lo passed Armijo and still descends, a_hi failed
    # Armijo or overshot, so the minimum stays bracketed.
    while not ok and evals < max_evals:
        f_a, g_a, dphi_a = phi(a)
        bad = not bool(torch.isfinite(f_a))
        armijo_fail = bad or bool(f_a > f0 + c1 * a * dphi0 + f_noise) or (
            evals > 0 and stage == 0 and bool(f_a >= phi_lo + f_noise))
        # the strong-Wolfe window, two-sided: below it the step still
        # descends (advance a_lo), above it the step overshot (shrink a_hi)
        curv_ok = bool((dphi_a >= c2 * dphi0) & (dphi_a <= -c2 * dphi0))
        overshoot = not armijo_fail and bool(dphi_a > -c2 * dphi0)
        accept = not armijo_fail and curv_ok
        too_far = armijo_fail or overshoot
        to_zoom = stage == 0 and too_far
        shrink = stage == 1 and too_far
        if not too_far and not accept:
            a_lo, phi_lo, dphi_lo = a, f_a, dphi_a
        if to_zoom or shrink:
            a_hi, dphi_hi = a, dphi_a
        if to_zoom:
            stage = 1
        evals += 1
        ok = accept
        if accept or bool(f_a < best_f):
            best_a = a
        best_f = torch.minimum(best_f, torch.full_like(best_f, float("inf"))
                               if bad else f_a)
        if ok:
            break
        if stage == 0:
            a = 2.0 * a
        else:
            # secant for the root of dphi between (a_lo, dphi_lo) and
            # (a_hi, dphi_hi), kept inside the bracket, else bisection
            w = a_hi - a_lo
            secant = a_lo - dphi_lo * w / (dphi_hi - dphi_lo)
            use_secant = bool(torch.isfinite(secant)
                              & (secant >= a_lo + 0.1 * w)
                              & (secant <= a_hi - 0.1 * w))
            a = secant if use_secant else a_lo + 0.5 * w
    # Without Wolfe acceptance, fall back to the best finite point seen
    # (sufficient decrease only), else fail.  On acceptance (f, g) at the
    # step are already in hand; the fallback evaluates at best_a.
    if ok:
        return a, f_a, g_a, True, evals
    fallback_ok = bool(torch.isfinite(best_f)) and bool(best_f < f0 + f_noise)
    f_f, g_f, _ = phi(best_a)
    return best_a, f_f, g_f, fallback_ok, evals + 1


def _fresh_state(x0, f0, g0, history):
    k = x0.shape[0]
    z = torch.zeros(history, k, dtype=x0.dtype, device=x0.device)
    return LBFGSDeviceState(
        x=x0, f=f0, g=g0, s_hist=z, y_hist=z.clone(),
        rho=torch.zeros(history, dtype=x0.dtype, device=x0.device),
        head=0, n_iter=0, failed=False, n_evals=1,
    )


def _lbfgs_step(fg, st, *, step, tol, history, max_ls_evals, f_noise):
    p = _two_loop(st.g, st.s_hist, st.y_hist, st.rho, st.head, history)
    # not a descent direction: restart with steepest descent
    if not bool(torch.dot(p, st.g) < 0):
        p = -st.g
    one = torch.ones((), dtype=st.x.dtype, device=st.x.device)
    if bool(st.rho[(st.head - 1) % history] == 0.0):
        gnorm = torch.linalg.norm(st.g)
        alpha0 = torch.minimum(one, step / torch.clamp(gnorm, min=1e-30))
    else:
        alpha0 = one
    a, f_new, g_new, ok, ls_evals = _wolfe_zoom(
        fg, st.x, st.f, st.g, p, alpha0, 1e-4, tol, max_ls_evals, f_noise)

    s = a * p
    yv = g_new - st.g
    sy = torch.dot(s, yv)
    good_pair = ok and bool(
        sy > 1e-12 * torch.linalg.norm(s) * torch.linalg.norm(yv))
    s_hist, y_hist, rho, head = st.s_hist, st.y_hist, st.rho, st.head
    if good_pair:
        h = head % history
        s_hist, y_hist, rho = s_hist.clone(), y_hist.clone(), rho.clone()
        s_hist[h] = s
        y_hist[h] = yv
        rho[h] = 1.0 / torch.clamp(sy, min=1e-30)
        head = (head + 1) % history
    # A line-search failure along a quasi-Newton direction drops the
    # curvature history (retry from steepest descent); only a failure with
    # empty history is terminal.
    have_hist = bool(torch.any(st.rho > 0.0))
    if not ok and have_hist:
        s_hist, y_hist = torch.zeros_like(s_hist), torch.zeros_like(y_hist)
        rho, head = torch.zeros_like(rho), 0
    return LBFGSDeviceState(
        x=st.x + s if ok else st.x,
        f=f_new if ok else st.f,
        g=g_new if ok else st.g,
        s_hist=s_hist, y_hist=y_hist, rho=rho, head=head,
        n_iter=st.n_iter + 1,
        failed=not ok and not have_hist,
        n_evals=st.n_evals + ls_evals,
    )


def minimize_lbfgs_device(
    fg: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    *,
    step: float = 0.1,
    tol: float = 0.1,
    epsabs: float = 0.1,
    max_iter: int = 100,
    history: int = 10,
    max_ls_evals: int = 30,
    f_noise: float = 0.0,
    init_state: LBFGSDeviceState | None = None,
    dispatch_iters: int | None = None,
) -> LBFGSDeviceState:
    """Minimize ``fg(x) -> (f, g)`` from ``x0``.

    ``f_noise`` is the objective's evaluation-noise amplitude (approximate
    Wolfe at the noise floor).  ``init_state`` resumes a previous run (x,
    gradient and curvature history); ``dispatch_iters`` caps the
    iterations of this call while ``n_iter`` / ``max_iter`` stay
    cumulative, as the JAX package chunks its device dispatches.
    """
    st = (_fresh_state(x0, *fg(x0), history) if init_state is None
          else init_state)
    start = st.n_iter
    while (bool(torch.linalg.norm(st.g) >= epsabs)
           and st.n_iter < max_iter and not st.failed
           and bool(torch.isfinite(st.f))
           and (dispatch_iters is None
                or st.n_iter - start < dispatch_iters)):
        st = _lbfgs_step(fg, st, step=step, tol=tol, history=history,
                         max_ls_evals=max_ls_evals, f_noise=f_noise)
    return st


def value_and_grad(f):
    """``fg_of(x, *data) -> (f, grad)`` for :func:`fit_packed_objective`
    from a scalar objective ``f(x, *data)``: the counterpart of
    ``jax.value_and_grad(f)``.  Autograd runs inside whatever the caller's
    grad mode is; the value comes back detached."""

    def fg_of(x, *data):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            val = f(x, *data)
            (g,) = torch.autograd.grad(val, x)
        return val.detach(), g

    return fg_of


def _make_fg(pack, variational, streaming_block_size, scale, log_prior,
             objective="evidence"):
    """(x, X, y) -> (f, grad) of the packed, scaled negative objective (+
    optional prior): the streaming evidence with ``streaming_block_size``,
    else the dense engine (whitened Cholesky factorization).  ``objective``
    "loo" is the closed-form LOO pseudo-likelihood (``models/loo.py``),
    which needs the materialized Knm: no streaming, and variational does
    not apply.  fit and fit_restarts both build their objective here."""
    from ..models.fitc import calc_model, calc_trained
    from ..models.loo import loo_objective
    from ..models.streaming import streaming_log_evidence

    if objective not in ("evidence", "loo"):
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "loo" and streaming_block_size is not None:
        raise ValueError(
            "objective='loo' needs the materialized n x m cross-covariance "
            "(models/loo.py); drop streaming_block_size"
        )

    def f(x, X, y):
        kernel, z, sigma2 = pack.unpack(x)
        if objective == "loo":
            l = loo_objective(kernel, z, sigma2, X, y, factorization="chol")
        elif streaming_block_size is not None:
            l = streaming_log_evidence(kernel, z, sigma2, X, y,
                                       variational=variational,
                                       block_size=streaming_block_size)
        else:
            model = calc_model(kernel, X, z, sigma2, variational=variational,
                               factorization="chol")
            l = calc_trained(model, y).l
        if log_prior is not None:
            l = l + log_prior(kernel, z, sigma2)
        return -l * scale

    return value_and_grad(f)


def _chunk_loop(chunk, st, X, y, max_iter, epsabs, f_noise,
                state_callback=None):
    """Drive chunks of iterations with noise-floor stall detection: net
    progress over a chunk below a few noise amplitudes ends the run (in f32
    at degenerate hyper regions the gradient is conditioning noise while f
    is flat).  Chunk-level detection is robust where a per-iteration
    counter is not: L-BFGS plateaus for a few iterations while rebuilding
    history, then accelerates."""
    f_prev = float(st.f)
    while True:
        st = chunk(st, X, y)
        if state_callback is not None:
            state_callback(st)
        if (st.n_iter >= max_iter or st.failed
                or not bool(torch.isfinite(st.f))
                or float(torch.linalg.norm(st.g)) < epsabs):
            break
        f_now = float(st.f)
        if f_prev - f_now <= 10.0 * f_noise:
            break  # noise-floor stall: no chunk-level progress
        f_prev = f_now
    return st


def fit_packed_objective(fg_of, pack, data, *, step: float = 0.1,
                         tol: float = 0.1, epsabs: float = 0.1,
                         max_iter: int = 100, history: int = 10,
                         f_noise: float = 0.0, dispatch_iters: int = 50,
                         init_state: LBFGSDeviceState | None = None,
                         state_callback=None) -> LBFGSDeviceState:
    """Drive the chunked L-BFGS over a packed objective ``fg_of(x, *data)
    -> (f, grad)`` from ``pack.x0`` (or ``init_state``); returns the final
    state."""

    def chunk(st, *_):
        return minimize_lbfgs_device(
            lambda x: fg_of(x, *data), st.x, step=step, tol=tol,
            epsabs=epsabs, max_iter=max_iter, history=history,
            f_noise=f_noise, init_state=st, dispatch_iters=dispatch_iters,
        )

    if init_state is not None:
        if int(init_state.s_hist.shape[0]) != history:
            raise ValueError(
                f"history={history} does not match the checkpointed "
                f"curvature buffers ({int(init_state.s_hist.shape[0])})"
            )
        st = init_state._replace(failed=False)
    else:
        st = _fresh_state(pack.x0, *fg_of(pack.x0, *data), history)
    return _chunk_loop(chunk, st, None, None, max_iter, epsabs, f_noise,
                       state_callback=state_callback)


def fit(X, y, pack, *, variational: bool = False, step: float = 0.1,
        tol: float = 0.1, epsabs: float = 0.1, max_iter: int = 100,
        history: int = 10, normalize: bool = True,
        streaming_block_size: int | None = None,
        f_noise: float | None = None, dispatch_iters: int = 50,
        log_prior=None, objective: str = "evidence",
        init_state: LBFGSDeviceState | None = None, state_callback=None):
    """Train a sparse GP: the packed negative streaming evidence under
    L-BFGS, in chunks of ``dispatch_iters`` iterations.  Returns (kernel,
    z, sigma2, LBFGSDeviceState).

    The JAX ``fit(family, X, y, pack, ...)`` minus ``family``: the pack's
    kernel class is the family.  ``normalize`` (default on) optimizes the
    mean NLL, which f32 training at large n needs; ``epsabs`` then applies
    to mean-scale gradient norms.  ``streaming_block_size`` switches the
    objective to the streaming evidence; without it the dense engine runs
    (``objective="loo"``, the LOO pseudo-likelihood, takes the dense engine
    only).  ``f_noise``
    defaults to a few f32 ulps of a unit-scale objective for f32 data, 0
    for f64.  ``log_prior(kernel, z, sigma2)`` makes it MAP estimation
    (``optim.priors``).  ``init_state`` resumes a previous run (``max_iter``
    then counts its iterations too); ``state_callback(st)`` fires after
    every chunk.
    """
    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == torch.float32 else 0.0
    fg_of = _make_fg(pack, variational, streaming_block_size, scale,
                     log_prior, objective)
    st = fit_packed_objective(
        fg_of, pack, (X, y), step=step, tol=tol, epsabs=epsabs,
        max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, init_state=init_state,
        state_callback=state_callback,
    )
    kernel, z, sigma2 = pack.unpack(st.x)
    return kernel, z, sigma2, st


class ProbeReport(list):
    """Probe objectives (a plain list) plus per-phase line-search counters:
    ``probe_evals`` / ``probe_iters`` sum over all starts, ``cont_evals`` /
    ``cont_iters`` cover the continuation alone, so evaluations per
    iteration show per phase.  ``winner`` is the index in ``x0s`` of the
    start that continued (the port's addition)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.probe_evals = 0
        self.probe_iters = 0
        self.cont_evals = 0
        self.cont_iters = 0
        self.rescored_f64 = None  # set when fit_restarts(rescore_f64=...)
        self.winner = None


def _rank_key(f, failed):
    """Healthy (finite, line search alive) before failed before diverged; a
    NaN objective never wins a "<" against a finite one."""
    bad = 2 if not math.isfinite(f) else (1 if failed else 0)
    return (bad, f if math.isfinite(f) else math.inf)


def fit_restarts(X, y, pack, x0s, *, probe_iters: int = 15,
                 variational: bool = False, step: float = 0.1,
                 tol: float = 0.1, epsabs: float = 0.1, max_iter: int = 100,
                 history: int = 10, normalize: bool = True,
                 streaming_block_size: int | None = None,
                 f_noise: float | None = None, dispatch_iters: int = 50,
                 log_prior=None, objective: str = "evidence",
                 probe_subsample: int | None = None, probe_seed: int = 0,
                 rescore_f64: int | None = None):
    """Multi-start training: a short L-BFGS probe (``probe_iters``
    iterations) from each packed start in ``x0s``, then the best probe
    (lowest objective) continues to ``max_iter`` total iterations with its
    curvature history intact.  Returns (kernel, z, sigma2, final_state,
    ProbeReport).  The JAX ``fit_restarts(family, ...)`` minus ``family``.

    ``probe_subsample``: run the probes on a random row subsample of this
    size (``np.random.default_rng(probe_seed)``); the winner then restarts
    on the full data from its probed x with fresh curvature history, and
    ``max_iter`` bounds the full-data iterations alone.

    ``rescore_f64``: rank the finished probes by the f64 objective on a
    shared row subsample of this size (``optim.polish.evaluate_f64``, in
    process on the data's device) instead of their raw objectives, which an
    f32 run can inflate in degenerate basins.  Requires
    ``objective="evidence"`` and ``log_prior=None``; the values land in
    ``ProbeReport.rescored_f64``.  If every rescore is non-finite, the raw
    ranking is used, with a warning.
    """
    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == torch.float32 else 0.0
    fg_of = _make_fg(pack, variational, streaming_block_size, scale,
                     log_prior, objective)
    if rescore_f64 is not None and (objective != "evidence"
                                    or log_prior is not None):
        raise ValueError(
            "rescore_f64 requires objective='evidence' and log_prior=None "
            "(the f64 rescoring evaluates the plain library objective)"
        )

    subsampled = probe_subsample is not None and probe_subsample < X.shape[0]
    if subsampled:
        idx = torch.as_tensor(np.random.default_rng(probe_seed).choice(
            X.shape[0], probe_subsample, replace=False), device=X.device)
        Xp, yp = X[idx], y[idx]
        fg_probe = _make_fg(
            pack, variational,
            None if streaming_block_size is None
            else min(streaming_block_size, probe_subsample),
            1.0 / probe_subsample if normalize else 1.0, log_prior, objective,
        )
    else:
        Xp, yp = X, y
        fg_probe = fg_of

    def probe_chunk(st, X, y):
        return minimize_lbfgs_device(
            lambda x: fg_probe(x, X, y), st.x, step=step, tol=tol,
            epsabs=epsabs, max_iter=probe_iters, history=history,
            f_noise=f_noise, init_state=st,
            dispatch_iters=min(dispatch_iters, probe_iters),
        )

    def chunk(st, X, y):
        return minimize_lbfgs_device(
            lambda x: fg_of(x, X, y), st.x, step=step, tol=tol,
            epsabs=epsabs, max_iter=max_iter, history=history,
            f_noise=f_noise, init_state=st, dispatch_iters=dispatch_iters,
        )

    states = []
    report = ProbeReport()
    for x0 in x0s:
        x0 = torch.as_tensor(x0, dtype=pack.x0.dtype, device=pack.x0.device)
        st = _fresh_state(x0, *fg_probe(x0, Xp, yp), history)
        st = _chunk_loop(probe_chunk, st, Xp, yp, probe_iters, epsabs,
                         f_noise)
        report.append(float(st.f))
        report.probe_evals += st.n_evals
        report.probe_iters += st.n_iter
        states.append(st)
    if not states:
        raise ValueError("x0s is empty")

    raw = [_rank_key(float(st.f), st.failed) for st in states]
    if rescore_f64 is not None:
        from .polish import evaluate_f64

        f64s = evaluate_f64(
            X, y, pack, [st.x for st in states], variational=variational,
            subsample=rescore_f64, seed=probe_seed,
            block_size=streaming_block_size, normalize=normalize,
        )
        report.rescored_f64 = list(f64s)
        if all(not math.isfinite(f) for f in f64s):
            warnings.warn(
                "rescore_f64: all candidates evaluated non-finite in f64; "
                "falling back to raw-f32 probe ranking",
                stacklevel=2,
            )
            keys = raw
        else:
            keys = [_rank_key(f, st.failed) for st, f in zip(states, f64s)]
    else:
        keys = raw
    report.winner = min(range(len(states)), key=keys.__getitem__)
    best = states[report.winner]
    if subsampled:
        # the subsample's curvature pairs and (f, g) do not carry to the
        # full objective: restart from the probed x
        best = _fresh_state(best.x, *fg_of(best.x, X, y), history)
    else:
        # a cleared failed flag lets a probe that ended in a line-search
        # failure retry from steepest descent in the continuation
        best = best._replace(failed=False)
    evals0, iters0 = best.n_evals, best.n_iter
    st = _chunk_loop(chunk, best, X, y, max_iter, epsabs, f_noise)
    report.cont_evals = st.n_evals - evals0
    report.cont_iters = st.n_iter - iters0
    kernel, z, sigma2 = pack.unpack(st.x)
    return kernel, z, sigma2, st, report
