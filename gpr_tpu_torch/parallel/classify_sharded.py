"""Data-parallel Laplace, EP and Student-t models over a 1-D mesh of ranks:
the counterpart of ``gpr_tpu/parallel/classify_sharded.py``.

Every cross-row quantity of a Newton step (``models/ift.py``), an EP
sweep or the heteroskedastic evidence is an m-vector, an m x m matrix or a
scalar sum over rows, so each function runs the port's single-device code
on this rank's rows with :meth:`DataMesh.allsum` as its ``allsum`` hook.
A Newton step all-reduces one m x m Gram, a few m-vectors and scalars;
nothing n-sized crosses between ranks.

Each function runs on every rank of ``mesh`` and takes this rank's rows
and mask (``parallel.sharded.shard_batch``); the kernel, ``z`` and the
likelihood's replicated parameters (a dispersion, cutpoints) are the same
on every rank.  Gradients come from ``spmd.sharded_value_and_grad`` or
``spmd.sharded_grad``.  Where the JAX package takes ``(family, ...,
params)`` the port takes a kernel module.
"""

from __future__ import annotations

import math

import torch

from ..models.classify import (
    _fitc_prior,
    latent_moments,
    logit_loglik,
    logit_parts,
    mackay_squash,
    newton_scan,
    prior_up,
)
from ..models.ift import W_FLOOR, laplace_evidence_core, tmatmul, up
from ..numerics.linalg import (
    cholesky_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)
from .sharded import _local_padded, gather_rows
from .spmd import DataMesh

__all__ = [
    "sharded_binomial_log_evidence",
    "sharded_classify_log_evidence",
    "sharded_classify_predict",
    "sharded_ep_log_evidence",
    "sharded_hetero_log_evidence",
    "sharded_multiclass_log_evidence",
    "sharded_negbin_log_evidence",
    "sharded_ordinal_log_evidence",
    "sharded_poisson_log_evidence",
    "sharded_t_moments",
]


def _mask(mask, X):
    if mask is None:
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    return mask


def _laplace(kernel, mesh, z, X, parts, loglik, lik, mask, newton_iters,
             jitter):
    """The dense Laplace evidence of one likelihood on this rank's rows."""
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    return laplace_evidence_core(parts, loglik, v, d, lik, _mask(mask, X),
                                 newton_iters=newton_iters,
                                 allsum=mesh.allsum)


def sharded_classify_log_evidence(kernel, mesh: DataMesh, z, X, y,
                                  mask=None, *, newton_iters: int = 15,
                                  jitter: float | None = None,
                                  block_size: int | None = None):
    """The distributed Laplace evidence, y in {-1, +1}.  ``block_size``
    streams each rank's Newton (``models/classify_stream.py``), so its
    memory is O(block m) in both n and n/P."""
    if block_size is not None:
        from ..models.classify_stream import stream_classify_log_evidence

        return stream_classify_log_evidence(
            kernel, z, X, y, block_size=block_size,
            newton_iters=newton_iters, jitter=jitter, mask=_mask(mask, X),
            allsum=mesh.allsum)
    return _laplace(kernel, mesh, z, X, logit_parts, logit_loglik, (y,),
                    mask, newton_iters, jitter)


@torch.no_grad()
def sharded_classify_predict(kernel, mesh: DataMesh, z, X, y, Xstar,
                             mask=None, *, newton_iters: int = 15,
                             jitter: float | None = None):
    """(prob, latent_mean, latent_var) at all of ``Xstar``, on every rank.
    The mode and the posterior's m-space factors reduce over the training
    rows (this rank's, with ``mask``); the test rows split over the ranks
    and come back gathered in their order."""
    mask = _mask(mask, X)
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    f_hat, a = newton_scan(v, d, y, mask, newton_iters=newton_iters,
                           allsum=mesh.allsum)
    pi = torch.sigmoid(f_hat)
    w = mask * torch.maximum(pi * (1.0 - pi), pi.new_tensor(W_FLOOR))
    d2inv = w / (1.0 + w * d)  # 1/(d + 1/w), exactly 0 on padding
    vs = v * (mask * torch.sqrt(torch.where(d2inv > 0.0, d2inv, 1.0))
              )[:, None]
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    rn = cholesky_upper(eye + mesh.allsum(tmatmul(vs, vs)), jitter=0.0)
    vta = mesh.allsum(tmatmul(v, a))
    mu, var = latent_moments(kernel, inducing, vta, rn,
                             _local_padded(mesh, Xstar))
    n_star = Xstar.shape[0]
    return tuple(gather_rows(mesh, t, n_star)
                 for t in (mackay_squash(mu, var), mu, var))


def sharded_ep_log_evidence(kernel, mesh: DataMesh, z, X, y, mask=None, *,
                            n_sweeps: int = 20, damping: float = 0.5,
                            jitter: float | None = None):
    """The distributed EP evidence (``models/classify_ep.py``): the sweep's
    site and cavity updates are per row, its cross-row objects an m x m
    Gram and a few m-vectors, one all-reduce set a sweep.  The gradient is
    the stationary one (the sites are constants to autograd)."""
    from ..models.classify_ep import ep_log_evidence_from_sites, ep_sweeps

    mask = _mask(mask, X)
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    with torch.no_grad():
        ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=n_sweeps,
                              damping=damping, allsum=mesh.allsum)
    return ep_log_evidence_from_sites(v, d, y, mask, ttau, tnu,
                                      allsum=mesh.allsum)


def sharded_poisson_log_evidence(kernel, mesh: DataMesh, z, X, y, mask=None,
                                 *, log_exposure=None,
                                 newton_iters: int = 20,
                                 jitter: float | None = None):
    """The distributed Poisson-Laplace evidence (``models/poisson.py``);
    ``log_exposure`` is this rank's rows of it."""
    from ..models.poisson import _exposure, pois_loglik, pois_parts

    return _laplace(kernel, mesh, z, X, pois_parts, pois_loglik,
                    (y, _exposure(y, log_exposure)), mask, newton_iters,
                    jitter)


def sharded_binomial_log_evidence(kernel, mesh: DataMesh, z, X, y, trials,
                                  mask=None, *, newton_iters: int = 15,
                                  jitter: float | None = None):
    """The distributed binomial-Laplace evidence (``models/binomial.py``);
    successes ``y`` and ``trials`` are this rank's rows."""
    from ..models.binomial import bin_loglik, bin_parts

    return _laplace(kernel, mesh, z, X, bin_parts, bin_loglik, (y, trials),
                    mask, newton_iters, jitter)


def sharded_negbin_log_evidence(kernel, mesh: DataMesh, z, X, y, r,
                                mask=None, *, log_exposure=None,
                                newton_iters: int = 20,
                                jitter: float | None = None):
    """The distributed NB2-Laplace evidence (``models/negbin.py``); the
    dispersion ``r`` is replicated and gets a gradient."""
    from ..models.negbin import _dispersion, nb_loglik, nb_parts
    from ..models.poisson import _exposure

    return _laplace(kernel, mesh, z, X, nb_parts, nb_loglik,
                    (y, _dispersion(r, X), _exposure(y, log_exposure)),
                    mask, newton_iters, jitter)


def sharded_multiclass_log_evidence(kernel, mesh: DataMesh, z, X, labels,
                                    n_classes: int, mask=None, *,
                                    newton_iters: int = 15,
                                    jitter: float | None = None,
                                    block_size: int | None = None):
    """The distributed softmax-Laplace evidence
    (``models/classify_multi.py``): integer ``labels``; a Newton step
    all-reduces C m x m Grams, C(C+1)/2 coupling blocks and a few (m, C)
    panels.  ``block_size`` streams each rank's Newton
    (``models/classify_multi_stream.py``)."""
    if block_size is not None:
        from ..models.classify_multi_stream import (
            stream_multiclass_log_evidence,
        )

        return stream_multiclass_log_evidence(
            kernel, z, X, labels, n_classes, block_size=block_size,
            newton_iters=newton_iters, jitter=jitter, mask=_mask(mask, X),
            allsum=mesh.allsum)
    from ..models.classify_multi import (
        evidence_from_mode,
        one_hot,
        softmax_mode,
    )

    _, v, d = prior_up(kernel, z, X, jitter)
    mask = up(_mask(mask, X))
    y1h = one_hot(labels, n_classes, v.dtype) * mask[:, None]
    f_hat, a = softmax_mode(v, d, y1h, mask, newton_iters=newton_iters,
                            allsum=mesh.allsum)
    return evidence_from_mode(v, d, f_hat, a, y1h, mask,
                              allsum=mesh.allsum).to(X.dtype)


def sharded_ordinal_log_evidence(kernel, mesh: DataMesh, z, X, y, cut_raw,
                                 mask=None, *, newton_iters: int = 20,
                                 jitter: float | None = None):
    """The distributed cumulative-probit Laplace evidence
    (``models/ordinal.py``); the cutpoint raws are replicated and get a
    gradient."""
    from ..models.ordinal import cutpoints_from_raw, ord_loglik, ord_parts

    return _laplace(kernel, mesh, z, X, ord_parts, ord_loglik,
                    (y, cutpoints_from_raw(cut_raw)), mask, newton_iters,
                    jitter)


def _hetero_factor(kernel, mesh, z, X, noise, mask, jitter):
    """(v, is, r_tilde, s, live): the whitened factor R~'R~ = I + A'A,
    A = V sqrt(is), of the evidence with per-row ``noise``."""
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    live = mask > 0.0
    s = torch.where(live, d + noise, 1.0)
    is_ = torch.where(live, 1.0 / s, 0.0)
    a = v * torch.sqrt(is_)[:, None]
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    r_tilde = cholesky_upper(eye + mesh.allsum(matmul(a.T, a)), jitter=0.0)
    return v, is_, r_tilde, s, live


def sharded_hetero_log_evidence(kernel, mesh: DataMesh, z, noise, X, y,
                                mask=None, *, jitter: float | None = None):
    """The distributed Gaussian evidence with a per-row noise vector (this
    rank's rows of it): the M-step objective of the Student-t family
    (``models/robust.py``), log N(y; 0, V V' + diag(kn_diag - rowsq(V)) +
    diag(noise))."""
    mask = _mask(mask, X)
    v, is_, r_tilde, s, live = _hetero_factor(kernel, mesh, z, X, noise,
                                              mask, jitter)
    sums = mesh.allsum(torch.stack([
        torch.sum(torch.where(live, torch.log(s), 0.0)), torch.sum(mask),
        torch.dot(y, is_ * y)]))
    log_s, n_live, y_is_y = sums.unbind()
    # log|B| - log|Km| telescopes to log|B~| in the whitened form
    l1 = -0.5 * (log_det_tri(r_tilde) + log_s
                 + n_live * math.log(2.0 * math.pi))
    t = solve_tri(r_tilde, mesh.allsum(matmul(v.T, is_ * y)), trans=True)
    # quad >= 0 mathematically; clamp the f32 cancellation overshoot
    return l1 - 0.5 * torch.clamp(y_is_y - torch.dot(t, t), min=0.0)


@torch.no_grad()
def sharded_t_moments(kernel, mesh: DataMesh, z, sigma2, X, y, lam,
                      mask=None, *, jitter: float | None = None):
    """The Student-t E-step moments (``models/robust.py``
    ``t_posterior_moments`` over the mesh): the m-space factors reduce over
    the ranks, then each row's exact (mu, var) is local.  Returns this
    rank's rows of them."""
    mask = _mask(mask, X)
    noise = sigma2 / torch.where(mask > 0.0, lam, 1.0)
    v, is_, r_tilde, _, _ = _hetero_factor(kernel, mesh, z, X, noise, mask,
                                           jitter)
    u = mesh.allsum(matmul(v.T, is_ * y))
    # whitened coeffs B~^-1 u; the mean at row i is v_i . coeffs
    coeffs = solve_tri(r_tilde, solve_tri(r_tilde, u, trans=True))
    mu = y - noise * (is_ * (y - matmul(v, coeffs)))
    w2 = rows_sqr_norm(solve_tri_right(v, r_tilde))
    s_inv_diag = is_ * (1.0 - is_ * w2)
    var = torch.clamp(noise * (1.0 - noise * s_inv_diag), min=1e-12)
    return mu, var
