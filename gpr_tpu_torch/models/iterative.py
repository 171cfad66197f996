"""Iterative exact GP: Nystrom/FITC-preconditioned conjugate gradients.
The counterpart of ``gpr_tpu/models/iterative.py``.

``models/exact.py`` ends where the dense Cholesky of K stops fitting (n ~
20,000 in f64).  This module takes EXACT inference past that point:

  * ``A v = (K + sigma2 I) v`` is computed in row blocks: each
    ``K(X_block, X)`` tile is formed with one ``k_cross`` product and
    folded into the result at once, so K is never materialized (memory is
    O(n block) transient and O(n rhs) persistent).  Under autograd each
    block runs under ``torch.utils.checkpoint``: the backward rebuilds the
    tile instead of keeping every (block, n) tile alive (at n = 100,000 and
    block 8,192 in f32 those are 13 tiles of 3.3 GB).
  * The solves use batched preconditioned CG.  The preconditioner is the
    FITC approximation itself, P = D + V V' with V = Knm U^-1 against m
    anchor rows of the data and D = diag(lambda) + sigma2, applied in O(nm)
    by Woodbury (Gardner et al. 2018; Wang et al. 2019).

Scope, as in the JAX package: posterior coefficients, means and variances
at large n, and UNBIASED stochastic gradients of the exact log evidence
(Hutchinson probes with the preconditioner as control variate) for SGD
hyper training.  The evidence VALUE at large n is not estimated.

The JAX package's ``lax.scan`` and ``lax.while_loop`` are host loops here:
CG reads ``max(relres) > tol`` from the device once an iteration.  Its
random draws (anchor rows, Rademacher probes) come from a
``torch.Generator`` (default ``torch.Generator(X.device).manual_seed(0)``)
instead of a key; ``iter_trained`` and ``evidence_grads_iter`` take JAX's
draws as ``X_sub=`` and ``probes=`` to reproduce its numbers.  The diagonal
correction subtracts each tile's own diagonal (the cross form's self-value
as the tile computed it) where JAX evaluates the cross form once more per
row; the operator's diagonal is k_diag + sigma2 either way.
``evidence_grads_iter`` applies the three matrices of its surrogate
([probes | alpha | D^-1 v]) in one blocked pass where JAX makes three, and
returns the kernel gradient as a dict by hyper name.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.base import cross_inputs, hyper_leaves, kernel_with
from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
    solve_tri,
)
from .fitc import _draw_rows


def _row_blocks(n: int, block_size: int):
    """(start, stop) of each row block; the last one may be short (a host
    loop needs no padding to a fixed shape, unlike JAX's ``_pad_rows``)."""
    return [(s, min(s + block_size, n)) for s in range(0, n, block_size)]


def _matvec_block(kernel, X, V, sigma2, start: int, stop: int):
    """Rows [start, stop) of (K + sigma2 I) V: one (block, n) tile times V,
    with the tile's diagonal entries replaced by k_diag + sigma2 (the exact
    model's operator: ``k_upper_inputs`` forces its diagonal to the prior
    variances, which differ from the cross form's self-value for se_fat)."""
    x_blk = X[start:stop]
    tile = cross_inputs(kernel, x_blk, X)  # (block, n)
    self_value = torch.diagonal(tile[:, start:stop])
    diag = kernel.k_diag(x_blk) - self_value + sigma2
    return matmul(tile, V) + diag[:, None] * V[start:stop]


def kernel_matvec(kernel, X, V, sigma2, *, block_size: int = 4096):
    """(K(X, X) + sigma2 I) @ V without materializing K.

    V may be (n,) or (n, r).  Each block forms one (block, n) tile and
    contracts it against V.  When autograd records, each block runs under
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so
    the backward recomputes the tile rather than keeping it.
    """
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    record = torch.is_grad_enabled()
    out = []
    for start, stop in _row_blocks(X.shape[0], block_size):
        args = (kernel, X, V, sigma2, start, stop)
        out.append(checkpoint(_matvec_block, *args, use_reentrant=False)
                   if record else _matvec_block(*args))
    out = torch.cat(out)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Preconditioner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NystromPrecond:
    """P = diag(d) + v v' applied by Woodbury in O(n m) per rhs.

    d = lambda + sigma2 (the FITC per-row residual variances), v = Knm U^-1
    whitened against an m-row SUBSET of the data (Nystrom on the data-side
    kernel).  P is a FITC prior covariance plus noise: the better the
    low-rank model fits, the tighter P approximates A and the fewer CG
    iterations the exact solve needs.
    """

    v: torch.Tensor  # (n, m) whitened cross-covariance
    d: torch.Tensor  # (n,)   lambda + sigma2 > 0
    chol_c: torch.Tensor  # (m, m) upper, C = I + v' diag(1/d) v

    def apply(self, r):
        """P^-1 r for r of shape (n,) or (n, r)."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        rd = r / self.d[:, None]
        w = matmul(self.v.T, rd)  # (m, r)
        w = solve_tri(self.chol_c, solve_tri(self.chol_c, w, trans=True))
        out = rd - matmul(self.v, w) / self.d[:, None]
        return out[:, 0] if squeeze else out


def nystrom_precond(kernel, X, sigma2, X_sub) -> NystromPrecond:
    """The Nystrom/FITC preconditioner anchored at the data rows ``X_sub``
    ((m, d), usually a random subset of X).  Everything is the DATA-side
    kernel (``cross_inputs``/``k_upper_inputs``), so P approximates the
    operator ``kernel_matvec`` applies for every family."""
    km = kernel.k_upper_inputs(X_sub)
    u_inv = inv_tri_upper(cholesky_upper(km, None))
    v = matmul(cross_inputs(kernel, X, X_sub), u_inv)  # (n, m)
    lam = torch.clamp(kernel.k_diag(X) - rows_sqr_norm(v), min=0.0)
    d = lam + sigma2
    c = torch.eye(v.shape[1], dtype=v.dtype, device=v.device) \
        + matmul(v.T, v / d[:, None])
    return NystromPrecond(v=v, d=d, chol_c=cholesky_upper(c, 0.0))


# ---------------------------------------------------------------------------
# Batched preconditioned CG
# ---------------------------------------------------------------------------


@torch.no_grad()
def pcg(matvec, b, *, precond=None, tol: float = 1e-6, max_iter: int = 200,
        colsum=None, replace_every: int | None = 50):
    """Batched preconditioned conjugate gradients for SPD systems.

    Solves ``A x = b`` for every column of ``b`` ((n,) or (n, r)) in one
    iteration: each step is ONE blocked matvec over all columns.  Stops
    when every column's relative residual is below ``tol`` (read on the
    host once an iteration) or at ``max_iter``.  Returns ``(x, info)`` with
    ``info = {"iters": k, "relres": (r,)}``; nothing is differentiated.

    ``precond`` may be an object with ``.apply`` (NystromPrecond) or a
    callable r -> P^-1 r.  ``colsum`` is the per-column reduction over the
    row axis: a distributed caller plugs in an all-reduced sum.

    ``replace_every`` applies Van der Vorst residual replacement: every
    that-many iterations the recursive residual is recomputed as
    ``b - matvec(x)`` (the JAX package measured the f32 recursive residual
    drifting from the true one at n >= 50,000 without it).  The final
    relres is always recomputed from the TRUE residual (one extra matvec).
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if precond is None:
        pre = lambda r: r  # noqa: E731
    else:
        pre = precond.apply if hasattr(precond, "apply") else precond
    if colsum is None:
        colsum = lambda t: torch.sum(t, dim=0)  # noqa: E731
    bnorm = torch.sqrt(torch.clamp(colsum(b * b), min=1e-60))

    x = torch.zeros_like(b)
    r = b
    z = pre(r)
    p = z
    rz = colsum(r * z)
    k = 0
    while k < max_iter and float(
            torch.max(torch.sqrt(colsum(r * r)) / bnorm)) > tol:
        ap = matvec(p)
        pap = colsum(p * ap)
        alpha = torch.where(pap > 0, rz / torch.clamp(pap, min=1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        if replace_every and (k + 1) % replace_every == 0:
            # re-sync the recursive residual with the true one (keeps the
            # search direction: a replacement, not a restart)
            r = b - matvec(x)
        z = pre(r)
        rz_new = colsum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = z + beta * p
        rz = rz_new
        k += 1
    r_true = b - matvec(x)
    relres = torch.sqrt(colsum(r_true * r_true)) / bnorm
    return (x[:, 0] if squeeze else x), {"iters": k, "relres": relres}


# ---------------------------------------------------------------------------
# Model surface (mirrors exact.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IterTrained:
    """Posterior coefficients of the exact GP, solved iteratively."""

    z: torch.Tensor  # (n, dz) training inputs in inducing representation
    sigma2: torch.Tensor
    alpha: torch.Tensor  # (n,) (K + sigma2 I)^-1 y
    iters: int
    relres: torch.Tensor


def _generator(generator, X):
    return (torch.Generator(X.device).manual_seed(0) if generator is None
            else generator)


def _anchors(X, n_inducing: int, generator):
    """min(n_inducing, n) distinct rows of X, drawn with ``generator``."""
    n = X.shape[0]
    return X[_draw_rows(_generator(generator, X), n, min(n_inducing, n),
                        X.device)]


def iter_trained(kernel, X, y, sigma2, *, n_inducing: int = 256,
                 X_sub=None, generator: torch.Generator | None = None,
                 tol: float = 1e-6, max_iter: int = 200,
                 block_size: int = 4096) -> IterTrained:
    """Solve alpha = (K + sigma2 I)^-1 y by Nystrom-preconditioned CG.

    ``X_sub`` ((m, d) anchor rows) overrides ``n_inducing``/``generator``;
    by default m = n_inducing distinct rows of X are drawn with
    ``generator``.
    """
    if X_sub is None:
        X_sub = _anchors(X, n_inducing, generator)
    with torch.no_grad():
        pre = nystrom_precond(kernel, X, sigma2, X_sub)

        def mv(v):
            return kernel_matvec(kernel, X, v, sigma2, block_size=block_size)

        alpha, info = pcg(mv, y, precond=pre, tol=tol, max_iter=max_iter)
        return IterTrained(
            z=kernel.inducing_from_inputs(X),
            sigma2=torch.as_tensor(sigma2, dtype=alpha.dtype,
                                   device=alpha.device),
            alpha=alpha, iters=info["iters"],
            relres=torch.max(info["relres"]),
        )


@torch.no_grad()
def predict_means_iter(kernel, trained: IterTrained, Xs, *,
                       block_size: int = 4096) -> torch.Tensor:
    """k(X*, X) alpha, blocked over test rows."""
    return torch.cat([
        matmul(kernel.k_cross(Xs[s:e], trained.z), trained.alpha)
        for s, e in _row_blocks(Xs.shape[0], block_size)])


@torch.no_grad()
def predict_variances_iter(kernel, trained: IterTrained, X, Xs, *,
                           predictive: bool = True,
                           precond: NystromPrecond | None = None,
                           tol: float = 1e-4, max_iter: int = 200,
                           block_size: int = 4096):
    """Pointwise posterior variance k*(x) - k*' A^-1 k*, each test column
    solved by the same batched PCG: O(n) per test point, so batch Xs
    accordingly (a few hundred to a few thousand columns a call).  Returns
    (var, info)."""
    ks = kernel.k_cross(Xs, trained.z).T  # (n, n*)

    def mv(v):
        return kernel_matvec(kernel, X, v, trained.sigma2,
                             block_size=block_size)

    w, info = pcg(mv, ks, precond=precond, tol=tol, max_iter=max_iter)
    var = torch.clamp(kernel.k_diag(Xs) - torch.sum(ks * w, dim=0), min=0.0)
    if predictive:
        var = var + trained.sigma2
    return var, info


# ---------------------------------------------------------------------------
# Stochastic exact-evidence gradients (training at large n)
# ---------------------------------------------------------------------------


def evidence_grads_iter(kernel, X, y, sigma2,
                        generator: torch.Generator | None = None, *,
                        n_probes: int = 8, n_inducing: int = 256,
                        tol: float = 1e-4, max_iter: int = 200,
                        block_size: int = 4096, probes=None, X_sub=None):
    """Unbiased stochastic gradient of the NEGATIVE exact log evidence
    w.r.t. (the kernel's hypers, sigma2).

    d(-log Z) = 1/2 (trace(A^-1 dA) - alpha' dA alpha),  alpha = A^-1 y.
    The alpha term is exact (one PCG solve).  The trace uses the
    preconditioner as a CONTROL VARIATE:

        trace(A^-1 dA) = trace(M dA) + E_z[((A^-1 - M) z)' dA z],  M = P^-1

    where trace(M dA) is deterministic through M's diagonal-plus-low-rank
    structure and only the small residual is Hutchinson-estimated with
    ``n_probes`` Rademacher probes.  One batched PCG solve against
    [y, z_1..z_p] gives alpha and the whitened probes; the gradient is
    autograd's of a surrogate that is linear in A(theta).

    ``probes`` ((n, p)) and ``X_sub`` ((m, d) anchor rows) replace the
    draws from ``generator``.  Returns ``((grads, g_sigma2), info)`` with
    ``grads`` a dict of the kernel's hyper gradients by field name.
    """
    n = X.shape[0]
    gen = _generator(generator, X)
    if probes is None:
        probes = (2 * torch.randint(0, 2, (n, n_probes), generator=gen,
                                    device=X.device) - 1).to(X.dtype)
    if X_sub is None:
        X_sub = _anchors(X, n_inducing, gen)
    names, leaves = hyper_leaves(kernel)
    hypers = [h.detach().requires_grad_(True) for h in leaves]
    s2 = torch.as_tensor(sigma2, dtype=X.dtype, device=X.device)\
        .detach().requires_grad_(True)

    with torch.no_grad():
        fixed = kernel_with(kernel, dict(zip(names, (h.detach()
                                                      for h in hypers))))
        pre = nystrom_precond(fixed, X, s2, X_sub)

        def mv(v):
            return kernel_matvec(fixed, X, v, s2, block_size=block_size)

        b = torch.cat([y[:, None], probes], dim=1)
        sol, info = pcg(mv, b, precond=pre, tol=tol, max_iter=max_iter)
        alpha, w = sol[:, 0], sol[:, 1:]
        # fixed M = P^-1 = D^-1 - Vd C^-1 Vd' with Vd = D^-1 v
        vd = pre.v / pre.d[:, None]  # (n, m)
        resid = w - pre.apply(probes)  # (A^-1 - M) z

    with torch.enable_grad():
        k = kernel_with(kernel, dict(zip(names, hypers)))
        p = probes.shape[1]
        # one blocked pass applies A to [probes | alpha | vd]
        a_all = kernel_matvec(k, X, torch.cat([probes, alpha[:, None], vd],
                                              dim=1), s2,
                              block_size=block_size)
        a_probes, a_alpha, a_vd = a_all[:, :p], a_all[:, p], a_all[:, p + 1:]
        # trace(M A): the diagonal part sum_i A_ii / d_i (the operator's
        # diagonal is k_diag + sigma2 by construction) minus the low-rank
        # part trace(C^-1 Vd' A Vd)
        tr_diag = torch.sum((k.k_diag(X) + s2) / pre.d)
        s = matmul(vd.T, a_vd)  # (m, m)
        tr_lowrank = torch.trace(
            solve_tri(pre.chol_c, solve_tri(pre.chol_c, s, trans=True)))
        tr_resid = torch.mean(torch.sum(resid * a_probes, dim=0))
        surrogate = 0.5 * (tr_diag - tr_lowrank + tr_resid
                           - torch.dot(alpha, a_alpha))
        # a field the data-side kernel never reads (se_fat's per-inducing-
        # point options) gets a zero gradient, as in JAX
        *g_hypers, g_s2 = torch.autograd.grad(
            surrogate, (*hypers, s2), allow_unused=True,
            materialize_grads=True)
    return (dict(zip(names, g_hypers)), g_s2), info


def sgd_update(kernel, sigma2, grads: dict, g_sigma2, step: int, n: int, *,
               eta0: float = 0.1, tau: float = 100.0, clip: float = 1.0):
    """One step of :func:`fit_iter`: rate eta0 tau / (tau + step), the
    gradients divided by n and clipped to ``clip``, the kernel's hypers
    moved in their own (log) coordinates and sigma2 in log space.  Returns
    (kernel, sigma2)."""
    eta = eta0 * tau / (tau + step)

    def clip_g(g):
        return torch.clamp(g / n, -clip, clip)

    names, leaves = hyper_leaves(kernel)
    kernel = kernel_with(kernel, {
        name: h.detach() - eta * clip_g(grads[name])
        for name, h in zip(names, leaves)})
    # descent in log space keeps sigma2 positive:
    # d(-logZ)/d log s2 = s2 * d(-logZ)/d s2
    sigma2 = sigma2 * torch.exp(-eta * clip_g(g_sigma2 * sigma2))
    return kernel, sigma2


def fit_iter(kernel0, X, y, sigma2_0, *,
             generator: torch.Generator | None = None, n_steps: int = 100,
             eta0: float = 0.1, tau: float = 100.0, n_probes: int = 8,
             n_inducing: int = 256, tol: float = 1e-3, max_iter: int = 200,
             block_size: int = 4096, clip: float = 1.0, callback=None):
    """SGD on the exact evidence at large n: stochastic gradients from
    ``evidence_grads_iter`` (fresh probes and anchors each step, drawn in
    turn from ``generator``), the reference SGD's decaying rate
    eta_k = eta0 tau / (tau + k) and log-space sigma2 update
    (lib/fitc_gp.ml:1737-1826), gradients divided by n (mean-NLL scale) so
    eta0 is shape-independent, and each coordinate clipped to ``clip``
    (:func:`sgd_update`).  Host loop: each step is one batched PCG solve
    and one differentiated matvec pass on the device.

    Returns ``(kernel, sigma2)``.  ``callback(step, kernel, sigma2, info)``
    if given.
    """
    n = X.shape[0]
    gen = _generator(generator, X)
    kernel = kernel0
    sigma2 = torch.as_tensor(sigma2_0, dtype=X.dtype, device=X.device)
    for step in range(n_steps):
        (grads, g_s2), info = evidence_grads_iter(
            kernel, X, y, sigma2, gen, n_probes=n_probes,
            n_inducing=n_inducing, tol=tol, max_iter=max_iter,
            block_size=block_size)
        kernel, sigma2 = sgd_update(kernel, sigma2, grads, g_s2, step, n,
                                    eta0=eta0, tau=tau, clip=clip)
        if callback is not None:
            callback(step, kernel, sigma2, info)
    return kernel, sigma2
