"""Online (incremental) posterior updates with fixed hyperparameters.  The
counterpart of ``gpr_tpu/models/online.py``.

For fixed (kernel hypers, Z, sigma2) the FITC posterior and evidence depend
on the data only through the O(m^2) sufficient statistics of
``models/streaming.py``, which are sums over rows.  Adding (or removing) a
batch of b rows is an O(b m^2) statistics update plus the O(m^3) whitened
epilogue: the online posterior equals the batch posterior on the
concatenated data to roundoff.

The state carries Knuth two-sum compensation terms (``stats_lo``), so an
add-then-remove round trip cancels to about an ulp of the surviving data
even in f32.

``online_update(..., block_size=)`` takes the statistics from
``stream_stats`` with its default ``grad_impl="custom"``, so that SE-iso in
f32 on the card takes the forward-statistics kernel; the JAX package asks
for ``grad_impl="ad"`` there, which in the port would force the plain loop
(the statistics are the same).
"""

from __future__ import annotations

import dataclasses

import torch

from ..numerics.linalg import inv_tri_upper, matmul, rows_sqr_norm
from .fitc import InducingState, calc_inducing
from .stream_grad import _two_sum
from .streaming import (
    StreamStats,
    _dewhiten,
    _whitened_solve,
    evidence_from_stats,
    stream_stats,
)


@dataclasses.dataclass(frozen=True)
class OnlineState:
    """Inducing quantities and the running sufficient statistics: ``stats``
    the running (hi) sums, ``stats_lo`` their two-sum compensation."""

    inducing: InducingState
    u_inv: torch.Tensor  # (m, m) upper, U^-1 (computed once)
    sigma2: torch.Tensor
    stats: StreamStats
    stats_lo: StreamStats


def _leaves(stats: StreamStats):
    return [getattr(stats, f.name) for f in dataclasses.fields(StreamStats)]


def _zero_stats(m, dtype, device) -> StreamStats:
    z = {"dtype": dtype, "device": device}
    return StreamStats(
        gram=torch.zeros((m, m), **z), u_vec=torch.zeros((m,), **z),
        log_det_s=torch.zeros((), **z), y_is_y=torch.zeros((), **z),
        is_r_sum=torch.zeros((), **z), n=torch.zeros((), **z),
    )


def online_init(kernel, z, sigma2, *, jitter=None) -> OnlineState:
    """Empty posterior (the prior) over the given inducing representation."""
    inducing = calc_inducing(kernel, z, jitter)
    m, dt = inducing.z.shape[0], inducing.km.dtype
    return OnlineState(
        inducing=inducing,
        u_inv=inv_tri_upper(inducing.chol_km),
        sigma2=torch.as_tensor(sigma2, dtype=dt, device=z.device),
        stats=_zero_stats(m, dt, z.device),
        stats_lo=_zero_stats(m, dt, z.device),
    )


def _folded_stats(st: OnlineState) -> StreamStats:
    """hi + lo: one final rounding instead of one per update."""
    return StreamStats(*(h + l for h, l in zip(_leaves(st.stats),
                                               _leaves(st.stats_lo))))


def _batch_stats(kernel, st: OnlineState, X, y) -> StreamStats:
    """Sufficient statistics of one batch as a single tile (``block_size``
    streams a large one)."""
    knm = kernel.k_cross(X, st.inducing.z)
    kd = kernel.k_diag(X)
    v = matmul(knm, st.u_inv)
    r = kd - rows_sqr_norm(v)
    s = r + st.sigma2
    is_ = 1.0 / s
    a = v * torch.sqrt(is_)[:, None]
    return StreamStats(
        gram=matmul(a.T, a),
        u_vec=matmul(v.T, is_ * y),
        log_det_s=torch.sum(torch.log(s)),
        y_is_y=torch.sum(is_ * y * y),
        is_r_sum=torch.sum(is_ * r),
        n=torch.as_tensor(float(X.shape[0]), dtype=st.sigma2.dtype,
                          device=X.device),
    )


def _apply_batch(st: OnlineState, batch: StreamStats, sign) -> OnlineState:
    """Compensated (hi, lo) += sign * batch, leaf by leaf: the two-sum
    keeps the rounding error of every add and subtract in ``stats_lo``."""
    pairs = [_two_sum(hi, lo, sign * b.to(hi.dtype)) for hi, lo, b in zip(
        _leaves(st.stats), _leaves(st.stats_lo), _leaves(batch))]
    return dataclasses.replace(
        st, stats=StreamStats(*(p[0] for p in pairs)),
        stats_lo=StreamStats(*(p[1] for p in pairs)))


def _stats_of(kernel, st, X, y, block_size):
    if block_size is not None:
        return stream_stats(kernel, st.inducing, st.sigma2, X, y,
                            block_size=block_size)
    return _batch_stats(kernel, st, X, y)


def online_update(kernel, st: OnlineState, X, y, *,
                  block_size: int | None = None) -> OnlineState:
    """Fold a batch of observations into the posterior: O(b m^2)."""
    return _apply_batch(st, _stats_of(kernel, st, X, y, block_size), 1.0)


def online_downdate(kernel, st: OnlineState, X, y, *,
                    block_size: int | None = None) -> OnlineState:
    """Remove a previously added batch (exact algebra, compensated)."""
    return _apply_batch(st, _stats_of(kernel, st, X, y, block_size), -1.0)


def online_log_evidence(st: OnlineState, *, variational=False):
    return evidence_from_stats(st.inducing, _folded_stats(st),
                               variational=variational)


def online_predictors(st: OnlineState):
    """(MeanPredictor, CoVariancePredictor) of the current posterior, for
    ``models.predict``."""
    from .predict import CoVariancePredictor, MeanPredictor

    r_tilde, t = _whitened_solve(st.inducing, _folded_stats(st))
    coeffs, r_mat = _dewhiten(st.inducing, r_tilde, t)
    return (
        MeanPredictor(z=st.inducing.z, coeffs=coeffs),
        CoVariancePredictor(z=st.inducing.z, chol_km=st.inducing.chol_km,
                            r_mat=r_mat),
    )
