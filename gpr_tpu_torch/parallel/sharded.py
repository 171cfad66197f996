"""Data-parallel evidence, training and serving over a 1-D mesh of ranks:
the counterpart of ``gpr_tpu/parallel/sharded.py``.

Every global quantity of the FITC algebra is either per row (r, s, is) or
a sum over rows (the m x m whitened Gram, the m-vector u and four scalars
of ``models.streaming.StreamStats``), so sharding the rows is exact: each
rank streams its own rows through ``stream_stats`` (the SE-iso kernels #1
and #3 on f32 cards, the plain loop otherwise), the ranks sum the
m^2 + m + 4 accumulators in one all-reduce, and every rank runs the O(m^3)
epilogue.  Nothing n-sized crosses between ranks.

The port runs one process per rank (``parallel.spmd``): functions that
take a mesh run on every rank of it, in lock step.  Those that evaluate an
objective take the rank's own rows, as ``shard_batch`` returns them (the
JAX package's ``P(DATA_AXIS)`` layout: padded globally to a multiple of P,
rank j holding rows [j n/P, (j+1) n/P)); ``make_sharded_objective``,
``fit_sharded``, ``probe_starts_sharded``, ``fit_restarts_sharded`` and the
predictors take the whole data and shard it themselves, as the JAX
package's do.  Outputs that the JAX package returns as a global array come
back gathered in host row order on every rank.  Where the JAX package
takes ``(family, ..., params)`` the port takes a kernel module.  On a 2-D
mesh (``spmd.Mesh2D``) ``pad_to_shards``, ``local_rows`` and
``shard_batch`` split the rows over its data axis, and
``fit_restarts_sharded`` continues on ``mesh2d.fit_sharded_2d``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.fitc import LOG_2PI, calc_inducing
from ..models.streaming import (
    evidence_from_stats,
    predict_means_blocked,
    predict_variances_blocked,
    stream_stats,
)
from ..numerics.linalg import (
    log_det_tri,
    matmul,
    qr_r_positive,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)
from .spmd import (
    DATA_AXIS,
    DataMesh,
    allsum_fields,
    make_mesh,
    sharded_value_and_grad,
)

__all__ = [
    "DATA_AXIS",
    "fit_restarts_sharded",
    "fit_sharded",
    "make_mesh",
    "make_sharded_objective",
    "pad_to_shards",
    "probe_starts_sharded",
    "shard_batch",
    "sharded_log_evidence",
    "sharded_log_evidence_tsqr",
    "sharded_pitc_log_evidence",
    "sharded_predict_means",
    "sharded_predict_variances",
    "sharded_warped_log_evidence",
]


def _row_mesh(mesh):
    """The mesh the rows split over: a 2-D mesh's data axis."""
    return getattr(mesh, "data", mesh)


def pad_to_shards(mesh, X, y):
    """Pad (X, y) to a row count divisible by the mesh size (on a 2-D
    mesh, its data axis's); returns (X, y, mask) with mask marking real
    rows (in X's dtype)."""
    n = X.shape[0]
    pad = (-n) % _row_mesh(mesh).size
    mask = torch.ones(n, dtype=X.dtype, device=X.device)
    if pad:
        X = torch.cat([X, X.new_zeros(pad, X.shape[1])])
        y = torch.cat([y, y.new_zeros((pad,) + y.shape[1:])])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    return X, y, mask


def local_rows(mesh, t):
    """This rank's contiguous block of the rows of ``t``, whose row count
    the mesh size divides, on the rank's device (on a 2-D mesh, its data
    member's block)."""
    mesh = _row_mesh(mesh)
    n = t.shape[0] // mesh.size
    return t[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)


def shard_batch(mesh, X, y):
    """This rank's rows of the padded (X, y, mask) (``pad_to_shards``; on
    a 2-D mesh its data member's)."""
    return tuple(local_rows(mesh, t) for t in pad_to_shards(mesh, X, y))


def gather_rows(mesh: DataMesh, t, n: int):
    """The ranks' blocks of ``t`` in host row order, trimmed to ``n``."""
    return mesh.all_gather(t)[:n]


def sharded_log_evidence(kernel, mesh: DataMesh, z, sigma2, X, y,
                         mask=None, *, variational: bool = False,
                         block_size: int = 8192,
                         jitter: float | None = None):
    """The exact distributed evidence, on every rank.  ``X`` (n/P, d),
    ``y`` and ``mask`` are this rank's rows (``shard_batch``); the kernel,
    ``z`` and ``sigma2`` are replicated.

    Per rank: ``stream_stats`` over the local rows on its default route,
    then one all-reduce of every statistic, then the replicated m^3
    epilogue.  Its gradient is ``spmd.sharded_value_and_grad``'s (or
    ``spmd.sharded_grad``'s)."""
    inducing = calc_inducing(kernel, z, jitter)
    stats = stream_stats(kernel, inducing, sigma2, X, y,
                         block_size=min(block_size, X.shape[0]), mask=mask)
    stats = allsum_fields(mesh, stats)
    return evidence_from_stats(inducing, stats, variational=variational)


def sharded_log_evidence_tsqr(kernel, mesh: DataMesh, z, sigma2, X, y,
                              mask=None, *, variational: bool = False,
                              jitter: float | None = None):
    """Distributed evidence by tall-skinny QR, the most stable path: each
    rank QR-factors its block of diag(sqrt is) Knm, the m x m R factors
    are all-gathered (P m^2 numbers), and one QR of [R_1; ...; R_P; U]
    gives the global stacked QR's R without forming the normal equations.
    Costs one materialized (n/P, m) block per rank."""
    if mask is None:
        mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    inducing = calc_inducing(kernel, z, jitter)
    knm = kernel.k_cross(X, inducing.z)
    v = solve_tri_right(knm, inducing.chol_km)
    r = kernel.k_diag(X) - rows_sqr_norm(v)
    live = mask > 0
    s = torch.where(live, r + sigma2, 1.0)
    is_ = mask / s
    sqrt_is = torch.where(live, torch.sqrt(torch.where(live, is_, 1.0)),
                          0.0)
    a1 = knm * sqrt_is[:, None]
    r_local = torch.linalg.qr(a1, mode="reduced").R
    m = z.shape[0]
    # a block of fewer than m rows has a (rows, m) R: pad it to (m, m)
    if r_local.shape[0] < m:
        r_local = torch.cat([r_local, r_local.new_zeros(
            m - r_local.shape[0], m)])
    r_mat = qr_r_positive(torch.cat([mesh.all_gather(r_local),
                                     inducing.chol_km]))
    sums = mesh.allsum(torch.stack([
        torch.sum(torch.where(live, torch.log(s), 0.0)),
        torch.sum(mask),
        torch.sum(is_ * y * y),
        torch.sum(is_ * r),
    ]))
    log_det_s, n_live, y_is_y, is_r = sums.unbind()
    u_vec = mesh.allsum(matmul(knm.T, is_ * y))
    l1 = -0.5 * (log_det_tri(r_mat) - inducing.log_det_km + log_det_s
                 + n_live * LOG_2PI)
    if variational:
        l1 = l1 - 0.5 * is_r
    t = solve_tri(r_mat, u_vec, trans=True)
    # quad >= 0 mathematically; clamp the f32 cancellation overshoot
    l2 = -0.5 * torch.clamp(y_is_y - torch.dot(t, t), min=0.0)
    return l1 + l2


def sharded_warped_log_evidence(kernel, mesh: DataMesh, warp_params, z,
                                sigma2, X, y, mask=None, *,
                                variational: bool = False,
                                block_size: int = 8192,
                                jitter: float | None = None):
    """Distributed warped evidence (``models/warped.py`` over the mesh):
    the warp is elementwise in y and its Jacobian term a masked row sum,
    so the regression path's data parallelism carries over.
    Differentiable in the kernel's hypers, ``warp_params``, ``z`` and
    ``sigma2``."""
    from ..models.warped import warp, warp_deriv

    if mask is None:
        mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    l = sharded_log_evidence(kernel, mesh, z, sigma2, X,
                             warp(warp_params, y), mask,
                             variational=variational, block_size=block_size,
                             jitter=jitter)
    # g' >= 1, so the log is finite on padded rows too; the mask removes
    # their contribution
    return l + mesh.allsum(torch.sum(mask * torch.log(
        warp_deriv(warp_params, y))))


def sharded_pitc_log_evidence(kernel, mesh: DataMesh, z, sigma2, X, y,
                              mask=None, *, block_size: int = 256,
                              jitter: float | None = None,
                              block_jitter: float = 0.0):
    """Distributed PITC evidence (``models/pitc.py`` over the mesh).  The
    partition is each rank's local ``block_size`` blocks: the
    single-device one where the rank's row count is a multiple of
    ``block_size``, otherwise another, equally valid, PITC partition."""
    from ..models.pitc import pitc_stream_stats

    inducing = calc_inducing(kernel, z, jitter)
    stats = pitc_stream_stats(kernel, inducing, sigma2, X, y,
                              block_size=min(block_size, X.shape[0]),
                              mask=mask, jitter=block_jitter)
    stats = allsum_fields(mesh, stats)
    return evidence_from_stats(inducing, stats, variational=False)


def _local_padded(mesh, X):
    """This rank's rows of X padded to a multiple of the mesh size (on a
    2-D mesh, of its data axis)."""
    pad = (-X.shape[0]) % _row_mesh(mesh).size
    if pad:
        X = torch.cat([X, X.new_zeros(pad, X.shape[1])])
    return local_rows(mesh, X)


@torch.no_grad()
def sharded_predict_means(kernel, mesh: DataMesh, z, coeffs, X, *,
                          block_size: int = 8192):
    """Batch means with the rows of ``X`` (all of them) split over the
    ranks: local products only, then one gather; every rank gets the (n,)
    means in row order."""
    xs = _local_padded(mesh, X)
    out = predict_means_blocked(kernel, z, coeffs, xs, block_size=block_size)
    return gather_rows(mesh, out, X.shape[0])


@torch.no_grad()
def sharded_predict_variances(kernel, mesh: DataMesh, z, chol_km, r_mat, X,
                              sigma2, *, predictive: bool = True,
                              block_size: int = 8192):
    """Batch marginal variances with the rows of ``X`` split over the
    ranks: local solves against the replicated factors, then one
    gather."""
    xs = _local_padded(mesh, X)
    out = predict_variances_blocked(kernel, z, chol_km, r_mat, xs, sigma2,
                                    predictive=predictive,
                                    block_size=block_size)
    return gather_rows(mesh, out, X.shape[0])


def _neg_evidence(mesh, pack, variational, block_size, scale, log_prior):
    """x, X, y, mask -> the scaled negative sharded evidence (+ prior)."""

    def f(x, X, y, mask):
        kernel, z, sigma2 = pack.unpack(x)
        l = sharded_log_evidence(kernel, mesh, z, sigma2, X, y, mask,
                                 variational=variational,
                                 block_size=block_size)
        if log_prior is not None:
            l = l + log_prior(kernel, z, sigma2)
        return -l * scale

    return f


def make_sharded_objective(mesh: DataMesh, X, y, pack, *,
                           variational: bool = False,
                           block_size: int = 8192):
    """x -> (value, gradient) of the negative sharded evidence over a
    packed hyper vector: the distributed training step.  ``X`` and ``y``
    are the whole data; each rank keeps its own rows."""
    data = shard_batch(mesh, X, y)
    f = _neg_evidence(mesh, pack, variational, block_size, 1.0, None)
    return lambda x: sharded_value_and_grad(mesh, f, x, *data)


def fit_sharded(mesh: DataMesh, X, y, pack, *, variational: bool = False,
                block_size: int = 8192, normalize: bool = True,
                step: float = 0.1, tol: float = 0.1, epsabs: float = 0.1,
                max_iter: int = 100, history: int = 10,
                f_noise: float | None = None, dispatch_iters: int = 50,
                log_prior=None, init_state=None, state_callback=None):
    """Data-parallel training: the chunked device L-BFGS
    (``optim.fit_packed_objective``) over the sharded evidence, on every
    rank in lock step.  Every line-search probe runs the distributed
    evidence and gradient (one all-reduce of ~m^2 statistics forward, one
    backward, one of the gradient).  Semantics are ``optim.fit``'s;
    returns (kernel, z, sigma2, LBFGSDeviceState), the same on every
    rank."""
    from ..optim.lbfgs_device import fit_packed_objective

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == torch.float32 else 0.0
    f = _neg_evidence(mesh, pack, variational, block_size, scale, log_prior)
    st = fit_packed_objective(
        functools.partial(sharded_value_and_grad, mesh, f), pack,
        shard_batch(mesh, X, y), step=step, tol=tol, epsabs=epsabs,
        max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, init_state=init_state,
        state_callback=state_callback)
    kernel, z, sigma2 = pack.unpack(st.x)
    return kernel, z, sigma2, st


def _state_row(st):
    """One LBFGSDeviceState as a flat f64 row (its integers and flag are
    exact in f64)."""
    return torch.cat([
        t.reshape(-1).to(torch.float64) for t in (
            st.x, st.g, st.s_hist, st.y_hist, st.rho, st.f,
            torch.tensor([st.head, st.n_iter, float(st.failed),
                          st.n_evals], dtype=torch.float64,
                         device=st.x.device))])


def _state_of_row(row, like):
    """The LBFGSDeviceState that ``_state_row`` flattened, in ``like``'s
    dtype."""
    from ..optim.lbfgs_device import LBFGSDeviceState

    k, h = like.x.shape[0], like.rho.shape[0]
    dt = like.x.dtype
    at = 0

    def take(n, shape):
        nonlocal at
        out = row[at:at + n].reshape(shape).to(dt)
        at += n
        return out

    x, g = take(k, (k,)), take(k, (k,))
    s_hist, y_hist = take(h * k, (h, k)), take(h * k, (h, k))
    rho, f = take(h, (h,)), take(1, ())
    head, n_iter, failed, n_evals = (int(v) for v in row[at:at + 4])
    return LBFGSDeviceState(x=x, f=f, g=g, s_hist=s_hist, y_hist=y_hist,
                            rho=rho, head=head, n_iter=n_iter,
                            failed=bool(failed), n_evals=n_evals)


def probe_starts_sharded(mesh: DataMesh, X, y, pack, x0s, *,
                         probe_iters: int = 15, variational: bool = False,
                         streaming_block_size: int | None = None,
                         normalize: bool = True, step: float = 0.1,
                         tol: float = 0.1, epsabs: float = 0.1,
                         history: int = 10, f_noise: float | None = None,
                         dispatch_iters: int = 50, log_prior=None):
    """S independent L-BFGS probes split over the ranks: every rank holds
    the whole (X, y), takes its contiguous share of the starts (padded to
    a multiple of P with copies of the last) and runs them one after
    another on the single-device objective, bounded by ``probe_iters``.
    Returns the list of S final LBFGSDeviceStates, the same on every
    rank."""
    from ..optim.lbfgs_device import (
        _fresh_state,
        _make_fg,
        minimize_lbfgs_device,
    )

    scale = 1.0 / X.shape[0] if normalize else 1.0
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == torch.float32 else 0.0
    fg_of = _make_fg(pack, variational, streaming_block_size, scale,
                     log_prior)
    X, y = X.to(mesh.device), y.to(mesh.device)
    x0s = [torch.as_tensor(x, dtype=pack.x0.dtype, device=mesh.device)
           for x in x0s]
    if not x0s:
        raise ValueError("x0s is empty")
    n_starts = len(x0s)
    x0s = x0s + [x0s[-1]] * ((-n_starts) % mesh.size)
    per = len(x0s) // mesh.size
    chunk = min(dispatch_iters, probe_iters)

    def fg(x):
        return fg_of(x, X, y)

    rows = []
    for x0 in x0s[mesh.rank * per:(mesh.rank + 1) * per]:
        st = _fresh_state(x0, *fg(x0), history)
        while (bool(torch.linalg.norm(st.g) >= epsabs)
               and st.n_iter < probe_iters and not st.failed
               and bool(torch.isfinite(st.f))):
            st = minimize_lbfgs_device(
                fg, st.x, step=step, tol=tol, epsabs=epsabs,
                max_iter=probe_iters, history=history, f_noise=f_noise,
                init_state=st, dispatch_iters=chunk)
        rows.append(_state_row(st))
    like = _fresh_state(x0s[0], x0s[0].new_zeros(()), x0s[0], history)
    gathered = mesh.all_gather(torch.stack(rows))
    return [_state_of_row(r, like) for r in gathered[:n_starts]]


def fit_restarts_sharded(mesh, X, y, pack, x0s, *,
                         probe_iters: int = 15, variational: bool = False,
                         block_size: int = 8192, normalize: bool = True,
                         step: float = 0.1, tol: float = 0.1,
                         epsabs: float = 0.1, max_iter: int = 100,
                         history: int = 10, f_noise: float | None = None,
                         dispatch_iters: int = 50, log_prior=None,
                         probe_subsample: int | None = None,
                         probe_seed: int = 0, state_callback=None):
    """Multi-start data-parallel training: the probes split over the ranks
    (``probe_starts_sharded``; on a 2-D mesh over all D M of them), then
    the best start continues on the row-sharded L-BFGS (``fit_sharded``;
    on a 2-D mesh with a model axis above 1, the tensor-parallel
    ``mesh2d.fit_sharded_2d``, else ``fit_sharded`` over its data axis).
    Semantics are
    ``optim.fit_restarts``'s: probes rank by (healthy, f); with
    ``probe_subsample`` they score a seeded row subsample and the winner
    restarts on the full data with fresh curvature history, else its
    history carries into the continuation.  Returns (kernel, z, sigma2,
    final_state, ProbeReport)."""
    from ..optim.lbfgs_device import ProbeReport, _rank_key

    if isinstance(mesh, DataMesh):
        continue_on = fit_sharded
    elif mesh.model.size > 1:
        from .mesh2d import fit_sharded_2d as continue_on
    else:
        continue_on, mesh = fit_sharded, _row_mesh(mesh)
    if f_noise is None:
        f_noise = 5e-7 if X.dtype == torch.float32 else 0.0
    subsampled = probe_subsample is not None and probe_subsample < X.shape[0]
    if subsampled:
        idx = torch.as_tensor(np.random.default_rng(probe_seed).choice(
            X.shape[0], probe_subsample, replace=False), device=X.device)
        Xp, yp = X[idx], y[idx]
    else:
        Xp, yp = X, y
    # the probes score the streaming evidence the continuation optimizes,
    # unsharded on the probe rows
    sbs = min(block_size, int(Xp.shape[0]))
    states = probe_starts_sharded(
        getattr(mesh, "all", mesh), Xp, yp, pack, x0s,
        probe_iters=probe_iters, variational=variational,
        streaming_block_size=sbs, normalize=normalize, step=step, tol=tol,
        epsabs=epsabs, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, log_prior=log_prior)
    report = ProbeReport(float(st.f) for st in states)
    report.probe_evals = sum(st.n_evals for st in states)
    report.probe_iters = sum(st.n_iter for st in states)
    report.winner = min(range(len(states)), key=lambda i: _rank_key(
        float(states[i].f), states[i].failed))
    best = states[report.winner]
    if subsampled:
        cont_pack = dataclasses.replace(pack, x0=best.x)
        init_state = None
    else:
        cont_pack, init_state = pack, best._replace(failed=False)
    kernel, z, sigma2, st = continue_on(
        mesh, X, y, cont_pack, variational=variational,
        block_size=block_size, normalize=normalize, step=step, tol=tol,
        epsabs=epsabs, max_iter=max_iter, history=history, f_noise=f_noise,
        dispatch_iters=dispatch_iters, log_prior=log_prior,
        init_state=init_state, state_callback=state_callback)
    report.cont_evals = st.n_evals - (0 if subsampled else best.n_evals)
    report.cont_iters = st.n_iter - (0 if subsampled else best.n_iter)
    return kernel, z, sigma2, st, report

