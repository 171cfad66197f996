"""Streaming (blockwise) FITC evidence, conditioning and prediction.

The counterpart of ``gpr_tpu/models/streaming.py``.  One pass over the rows
reduces them to O(m^2) sufficient statistics (``StreamStats``): the
*whitened* Gram G = sum (V sqrt(is))' (V sqrt(is)) with V = Knm U^-1, the
m-vector u = V' (is y) and four scalars.  The factorization target is then
I + G, whose eigenvalues are >= 1, and log|B| - log|Km| = log|I + G|.

The pass runs one of three implementations (``impl``):

* ``"fused_acc"`` -- the CUDA kernel behind
  :func:`gpr_tpu_torch.ops.se_iso_stream_stats_fused_acc` (the counterpart
  of the JAX package's ``impl="pallas"``);
* ``"fused"`` -- the per-block-partials kernel behind
  :func:`gpr_tpu_torch.ops.se_iso_stream_stats_fused`;
* ``"reference"`` -- the plain blocked loop of ``stream_grad._forward_scan``
  (the JAX package's default ``impl="scan"``).

With ``impl=None`` an SE-iso kernel on f32 CUDA tensors with a scalar
sigma2 takes ``"fused_acc"`` (``ops.fused_stats.default_route``): the
forward kernel where it fits the device (m up to about 5,980 at any d on an
H100), and, when a gradient will be taken, the backward kernel too (m up to
about 2,870).  Everything else takes the plain loop: the other families
(the combinators, ``sum(se_iso,...)`` included: the test goes by name),
CPU tensors, f64 on the card, per-row sigma2, and an (m, d) past those
limits.  The two kernel impls compute the SE-iso kernel with a scalar
sigma2 only: asked for otherwise they raise, as the JAX package's Pallas
path does.

``sigma2`` is the scalar noise variance, or an (n,) vector of per-row
noise variances (the heteroskedastic evidence): a vector streams through
the plain loop under autograd (``grad_impl="ad"``, taken by itself, as in
the JAX package), blocked like y, and the result is differentiable with
respect to it.

Gradients (``grad_impl``): ``"custom"`` (the default) is the hand VJP of
``stream_grad.StreamStatsFn``, whose backward runs the backward kernel
:func:`gpr_tpu_torch.ops.se_iso_stream_bwd_fused` for the kernel impls and
``stream_grad._backward_scan`` for ``"reference"``; ``"ad"`` is plain
autograd through the reference loop, kept as its cross-check.  The serving
functions run under ``torch.no_grad()``.

Accumulators take the model's dtype (that of ``z``): f32 models accumulate
in compensated f32, f64 models in f64.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.base import hyper_leaves
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from ..tracing import span
from .fitc import LOG_2PI, InducingState, calc_inducing
from .stream_grad import StreamStatsFn, _forward_scan, _pad_blocks

IMPLS = ("fused_acc", "fused", "reference")
GRAD_IMPLS = ("custom", "ad")


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Sufficient statistics of one pass over the data (the n axis is
    reduced away, so memory is O(m^2))."""

    gram: torch.Tensor  # (m, m)  whitened: U^-T Knm' diag(is) Knm U^-1
    u_vec: torch.Tensor  # (m,)    whitened: U^-T Knm' (is * y)
    log_det_s: torch.Tensor  # sum log s
    y_is_y: torch.Tensor  # y' diag(is) y
    is_r_sum: torch.Tensor  # sum(is * r)   (variational correction)
    n: torch.Tensor  # number of (real) rows


def _resolve_impl(impl, X, kernel, grad_impl="custom", *, z=None,
                  per_row=False, grad=True):
    """The statistics' implementation for ``impl`` (None: the default
    route; see the module docstring).  ``z``, the inducing points, gives
    the default route its m; ``per_row`` says that sigma2 is a vector;
    ``grad`` that a gradient will be taken through the statistics."""
    if grad_impl not in GRAD_IMPLS:
        raise ValueError(
            f"unknown grad_impl {grad_impl!r}; valid: {GRAD_IMPLS}"
        )
    if per_row:
        if impl not in (None, "reference"):
            raise ValueError(
                f"per-row sigma2 streams on impl='reference' only, got "
                f"impl={impl!r}"
            )
        return "reference"
    if grad_impl == "ad":
        # the kernels have no autograd of their own: their gradient is the
        # hand VJP
        if impl not in (None, "reference"):
            raise ValueError(
                f"grad_impl='ad' differentiates the plain loop; "
                f"impl={impl!r} needs grad_impl='custom'"
            )
        return "reference"
    se_iso = getattr(kernel, "name", None) == "se_iso"
    if impl is None:
        if not (se_iso and X.is_cuda):
            return "reference"
        # imported here: ops.fused_stats imports this package
        from ..ops.fused_stats import default_route

        return default_route(z.shape[0], X.shape[1], X.dtype,
                             torch.cuda.get_device_properties(X.device),
                             grad=grad)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; valid: {IMPLS}")
    if impl != "reference" and not se_iso:
        raise ValueError(
            f"impl={impl!r} supports the se_iso kernel only, got "
            f"{getattr(kernel, 'name', kernel)}; use impl='reference'"
        )
    if impl != "reference" and not X.is_cuda:
        raise ValueError(
            f"impl={impl!r} is a CUDA kernel and X is on {X.device}; use "
            f"impl='reference' for CPU tensors"
        )
    return impl


def stream_stats(kernel, inducing: InducingState, sigma2, X, y, *,
                 block_size: int = 8192, mask=None,
                 impl: str | None = None,
                 grad_impl: str = "custom") -> StreamStats:
    """One pass over row blocks accumulating StreamStats.

    V tiles are formed as ``knm_tile @ U^-1`` against the inverse Cholesky
    factor, computed once.  ``mask`` (n,) of 0/1 weights excludes rows.
    ``sigma2`` is the scalar noise variance or an (n,) vector of per-row
    ones.  Differentiable with respect to the kernel's hypers, ``z``,
    ``sigma2`` and ``y`` (see the module docstring for ``impl`` and
    ``grad_impl``).
    """
    with span("gpr.step.stats", rows=X.shape[0]):
        z = inducing.z
        per_row = torch.as_tensor(sigma2).ndim == 1
        leaves = hyper_leaves(kernel)[1]
        grad = torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in (inducing.chol_km, sigma2, X, y, *leaves))
        impl = _resolve_impl(impl, X, kernel, grad_impl, z=z,
                             per_row=per_row, grad=grad)
        u_inv = inv_tri_upper(inducing.chol_km)
        if grad_impl == "ad" or per_row:
            xb, yb, maskb = _pad_blocks(X, y, mask, block_size)
            if per_row:  # blocked like y, zero (and masked) past the rows
                sigma2 = _pad_blocks(
                    X, torch.as_tensor(sigma2, device=z.device), mask,
                    block_size)[1]
            return StreamStats(*_forward_scan(kernel, z, u_inv, sigma2, xb,
                                              yb, maskb, z.dtype, per_row))
        sigma2 = torch.as_tensor(sigma2, dtype=z.dtype, device=z.device)
        if impl != "reference":
            # the kernels take row-major data (solve_triangular's result on
            # CUDA is column-major); no copy where it already is
            if mask is not None:
                mask = mask.to(X.dtype)
            z, u_inv, X, y, mask = (None if t is None else t.contiguous()
                                    for t in (z, u_inv, X, y, mask))
        return StreamStats(*StreamStatsFn.apply(
            kernel, block_size, impl, z, u_inv, sigma2, X, y, mask,
            *leaves))


def _whitened_factor(inducing, stats):
    """Upper R~ with R~'R~ = I + G (G the whitened Gram).  Eigenvalues of the
    target are >= 1, so this Cholesky cannot fail: no extra jitter."""
    m = stats.gram.shape[0]
    bt = torch.eye(m, dtype=stats.gram.dtype, device=stats.gram.device)
    bt = bt + stats.gram
    return cholesky_upper(bt.to(inducing.km.dtype), jitter=0.0)


def _whitened_solve(inducing, stats: StreamStats):
    """(r_tilde, t): the shared core of every whitened epilogue."""
    r_tilde = _whitened_factor(inducing, stats)
    t = solve_tri(r_tilde, stats.u_vec.to(inducing.km.dtype), trans=True)
    return r_tilde, t


def _evidence_terms(stats: StreamStats, r_tilde, t, *, variational):
    """(l1, l2) in the accumulator dtype; log|B| - log|Km| = log|I + G|."""
    acc = stats.gram.dtype
    l1 = -0.5 * (
        log_det_tri(r_tilde).to(acc) + stats.log_det_s + stats.n * LOG_2PI
    )
    if variational:
        l1 = l1 - 0.5 * stats.is_r_sum
    # quad = y' (S + V V')^-1 y = y_is_y - t't >= 0 mathematically; in f32 a
    # near-singular I + G can make t't overshoot by cancellation and inflate
    # the evidence, so clamp at the mathematical bound.
    l2 = -0.5 * torch.clamp(stats.y_is_y - torch.dot(t, t).to(acc), min=0.0)
    return l1, l2


def _dewhiten(inducing, r_tilde, t):
    """(coeffs, r_mat): R = R~ U, coeffs = U^-1 R~^-1 t."""
    coeffs = solve_tri(inducing.chol_km, solve_tri(r_tilde, t))
    r_mat = matmul(r_tilde, inducing.chol_km)
    return coeffs, r_mat


def evidence_from_stats(inducing, stats: StreamStats, *,
                        variational: bool = False) -> torch.Tensor:
    """l = l1 + l2 from the reduced statistics: the O(m^3) epilogue."""
    with span("gpr.step.epilogue"):
        r_tilde, t = _whitened_solve(inducing, stats)
        l1, l2 = _evidence_terms(stats, r_tilde, t, variational=variational)
        return (l1 + l2).to(inducing.km.dtype)


def streaming_log_evidence(kernel, z, sigma2, X, y, *,
                           variational: bool = False, block_size: int = 8192,
                           jitter: float | None = None,
                           impl: str | None = None,
                           grad_impl: str = "custom") -> torch.Tensor:
    """FITC (or variational) log evidence at large n, O(block m + m^2)
    memory.  ``sigma2`` is a scalar or an (n,) per-row vector.
    Differentiable with respect to the kernel's hypers, ``z``, ``sigma2``
    and ``y``: the custom backward recomputes each Knm tile."""
    inducing = calc_inducing(kernel, z, jitter)
    stats = stream_stats(kernel, inducing, sigma2, X, y,
                         block_size=block_size, impl=impl,
                         grad_impl=grad_impl)
    return evidence_from_stats(inducing, stats, variational=variational)


@dataclasses.dataclass(frozen=True)
class StreamingModelLite:
    """The O(m^2) slice of a trained streaming model that reporting and
    persistence need."""

    inducing: InducingState
    sigma2: torch.Tensor
    r_mat: torch.Tensor  # (m, m) upper, de-whitened
    l1: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StreamingTrained:
    """A model conditioned on its targets; ``means`` are the posterior means
    at the training inputs, computed blockwise."""

    model: StreamingModelLite
    y: torch.Tensor
    coeffs: torch.Tensor
    means: torch.Tensor
    l: torch.Tensor


@torch.no_grad()
def streaming_trained(kernel, z, sigma2, X, y, *, variational=False,
                      block_size=8192, jitter=None,
                      impl=None) -> StreamingTrained:
    """Condition on targets with O(block m + m^2) memory: evidence terms,
    de-whitened factor, coefficients and training-input means."""
    inducing = calc_inducing(kernel, z, jitter)
    stats = stream_stats(kernel, inducing, sigma2, X, y,
                         block_size=block_size, impl=impl)
    dt = inducing.km.dtype
    r_tilde, t = _whitened_solve(inducing, stats)
    l1, l2 = _evidence_terms(stats, r_tilde, t, variational=variational)
    coeffs, r_mat = _dewhiten(inducing, r_tilde, t)
    means = predict_means_blocked(kernel, inducing.z, coeffs, X,
                                  block_size=block_size)
    return StreamingTrained(
        model=StreamingModelLite(
            inducing=inducing,
            sigma2=torch.as_tensor(sigma2, dtype=dt, device=z.device),
            r_mat=r_mat,
            l1=l1.to(dt),
        ),
        y=y,
        coeffs=coeffs,
        means=means,
        l=(l1 + l2).to(dt),
    )


@torch.no_grad()
def streaming_coeffs(kernel, z, sigma2, X, y, *, block_size=8192,
                     jitter=None, impl=None):
    """Posterior mean coefficients R^-1 R^-T Knm'(is y) without
    materializing Knm; returns (inducing, r_mat, coeffs)."""
    inducing = calc_inducing(kernel, z, jitter)
    stats = stream_stats(kernel, inducing, sigma2, X, y,
                         block_size=block_size, impl=impl)
    r_tilde, t = _whitened_solve(inducing, stats)
    coeffs, r_mat = _dewhiten(inducing, r_tilde, t)
    return inducing, r_mat, coeffs


@torch.no_grad()
def predict_means_blocked(kernel, z, coeffs, X, *, block_size=8192):
    """Batch mean prediction, one (block, m) Ktm tile at a time."""
    with span("gpr.predict.means", root=True, points=X.shape[0]):
        out = torch.empty(X.shape[0], dtype=coeffs.dtype, device=X.device)
        for i in range(0, X.shape[0], block_size):
            x_b = X[i:i + block_size]
            out[i:i + block_size] = matmul(kernel.k_cross(x_b, z), coeffs)
        return out


@torch.no_grad()
def predict_variances_blocked(kernel, z, chol_km, r_mat, X, sigma2, *,
                              predictive=True, block_size=8192):
    """Batch variances kt_diag - rowsq(Ktm U^-1) + rowsq(Ktm R^-1), plus
    sigma2 when ``predictive``."""
    with span("gpr.predict.variances", root=True, points=X.shape[0]):
        with span("gpr.predict.inverses"):
            u_inv = inv_tri_upper(chol_km)
            r_inv = inv_tri_upper(r_mat)
        out = torch.empty(X.shape[0], dtype=r_mat.dtype, device=X.device)
        for i in range(0, X.shape[0], block_size):
            x_b = X[i:i + block_size]
            ktm = kernel.k_cross(x_b, z)
            v = (kernel.k_diag(x_b) - rows_sqr_norm(matmul(ktm, u_inv))
                 + rows_sqr_norm(matmul(ktm, r_inv)))
            out[i:i + block_size] = v + sigma2 if predictive else v
        return out
