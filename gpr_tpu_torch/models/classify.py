"""Binary GP classification: the Laplace approximation over the FITC prior.
The counterpart of ``gpr_tpu/models/classify.py``.

A Bernoulli-logit likelihood over a latent sparse GP with the FITC prior

  f ~ N(0, K),   K = V V' + D,   V = Knm U^-1,  D = diag(kd - rowsq(V)),

its mode found by the stabilized Newton iteration of GPML algorithm 3.1
(``models/ift.py``): B = I + W^1/2 K W^1/2 inverts through an m x m
Woodbury factor, so a Newton step is a few (n, m) products and elementwise
work, and the evidence needs only diagonal sums and an m x m Cholesky:

  log|B| = sum log(1 + w_i d_i) + log|I_m + V' diag(w/(1+wd)) V|.

The hyper gradient is the implicit one of ``ift.LaplaceFixedPoint`` by
default (``grad_impl="unroll"`` differentiates through the iteration).
Prediction reuses the FITC predictive shape: the latent variance is
k** - rowsq(V*) + rowsq(V* R^-1) with R'R = I_m + S the posterior m-factor,
and the class probability is MacKay's probit approximation to the logistic
integral, p = sigma(mu / sqrt(1 + pi var / 8)).

V is materialized at (n, m); ``block_size`` takes the streaming Newton of
``models/classify_stream.py`` instead, where it never is.  Where the JAX
package takes ``(family, params)`` the port takes a kernel module.
"""

from __future__ import annotations

import math

import torch

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    matmul,
    rows_sqr_norm,
    solve_tri_right,
)
from .fitc import calc_inducing
from .ift import (
    W_FLOOR,
    laplace_evidence_core,
    newton_scan_generic,
    tmatmul,
    up,
)


def _fitc_prior(kernel, z, X, jitter=None, d_floor=1e-8):
    """(inducing, V, d): the low-rank + diagonal FITC prior
    K = V V' + diag(d)."""
    inducing = calc_inducing(kernel, z, jitter)
    u_inv = inv_tri_upper(inducing.chol_km)
    knm = kernel.k_cross(X, inducing.z)
    v = matmul(knm, u_inv)
    d = kernel.k_diag(X) - rows_sqr_norm(v)
    return inducing, v, torch.maximum(d, d.new_tensor(d_floor))


def prior_up(kernel, z, X, jitter=None):
    """``_fitc_prior`` with V and d cast to ``ift.MODE_DTYPE`` (casts
    autograd differentiates): the prior of the softmax Laplace, whose
    Newton steps and m-space algebra run in f64 on the rows' V, and of
    EP's predictor."""
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    return inducing, up(v), up(d)


def log_sigmoid(t):
    return -torch.logaddexp(torch.zeros_like(t), -t)


def logit_parts(f, lik, mask):
    """(dl/df, W) of the Bernoulli-logit likelihood, elementwise; the
    ``ift`` parts convention, lik = (y,) with y in {-1, +1}."""
    (y,) = lik
    pi = torch.sigmoid(f)
    w = mask * torch.maximum(pi * (1.0 - pi), pi.new_tensor(W_FLOOR))
    return mask * (0.5 * (y + 1.0) - pi), w


def logit_loglik(f, lik):
    (y,) = lik
    return log_sigmoid(y * f)


def newton_scan(v, d, y, mask, *, newton_iters: int = 15,
                allsum=lambda x: x):
    """The Newton iteration over the rows of the FITC prior: the logit
    instance of ``ift.newton_scan_generic``.  ``mask`` zeroes padded rows.
    Returns (f_hat, a)."""
    return newton_scan_generic(logit_parts, v, d, (y,), mask,
                               newton_iters=newton_iters, allsum=allsum)


def laplace_mode(kernel, z, X, y, *, newton_iters: int = 15,
                 jitter: float | None = None):
    """Newton mode-finding for the Laplace approximation, ``y`` in
    {-1, +1}.  Returns (f_hat, a, inducing, v, d) with f_hat = K a."""
    inducing, v, d = _fitc_prior(kernel, z, X, jitter)
    f_hat, a = newton_scan(v, d, y, torch.ones_like(y),
                           newton_iters=newton_iters)
    return f_hat, a, inducing, v, d


def classify_log_evidence(kernel, z, X, y, *, newton_iters: int = 15,
                          jitter: float | None = None,
                          block_size: int | None = None,
                          grad_impl: str = "ift"):
    """Laplace marginal likelihood log q(y | X, hypers) (GPML eq. 3.32),
    differentiable in the kernel's hypers and ``z`` by ``grad_impl``.
    ``block_size`` takes the streaming Newton (``classify_stream.py``),
    with the same ``grad_impl``."""
    if block_size is not None:
        from .classify_stream import stream_classify_log_evidence

        return stream_classify_log_evidence(
            kernel, z, X, y, block_size=block_size,
            newton_iters=newton_iters, jitter=jitter, grad_impl=grad_impl)
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    return laplace_evidence_core(
        logit_parts, logit_loglik, v, d, (y,), torch.ones_like(y),
        newton_iters=newton_iters, grad_impl=grad_impl)


def mode_factor(v, d, w):
    """Upper Rn with Rn'Rn = I + V' diag(1/(d + 1/w)) V, the posterior
    m-factor at the mode's curvature ``w`` (floored, > 0)."""
    d2inv = w / (1.0 + w * d)  # 1/(d + 1/w) without dividing by w
    vs = v * torch.sqrt(d2inv)[:, None]
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return cholesky_upper(eye + tmatmul(vs, vs), jitter=0.0)


def latent_moments(kernel, inducing, vta, rn, Xstar):
    """(mu*, var*) of the latent posterior at Xstar from the m-space state
    vta = V'a and the mode's m-factor rn: mu* = V* vta and
    var* = k** - rowsq(V*) + rowsq(V* rn^-1)."""
    vstar = matmul(kernel.k_cross(Xstar, inducing.z),
                   inv_tri_upper(inducing.chol_km))
    mu = matmul(vstar, vta)
    quad = rows_sqr_norm(vstar) - rows_sqr_norm(solve_tri_right(vstar, rn))
    var = kernel.k_diag(Xstar) - quad
    return mu, torch.maximum(var, var.new_tensor(1e-10))


def mackay_squash(mu, var):
    """MacKay's probit approximation to the logistic-Gaussian integral."""
    return torch.sigmoid(mu / torch.sqrt(1.0 + math.pi * var / 8.0))


def classify_predict(kernel, z, X, y, Xstar, *, newton_iters: int = 15,
                     jitter: float | None = None,
                     block_size: int | None = None):
    """(prob, latent_mean, latent_var) at Xstar.  ``block_size`` streams
    the mode and the state (``classify_stream.py``)."""
    if block_size is not None:
        from .classify_stream import stream_classify_predict

        return stream_classify_predict(
            kernel, z, X, y, Xstar, block_size=block_size,
            newton_iters=newton_iters, jitter=jitter)
    f_hat, a, inducing, v, d = laplace_mode(
        kernel, z, X, y, newton_iters=newton_iters, jitter=jitter)
    pi = torch.sigmoid(f_hat)
    w = torch.maximum(pi * (1.0 - pi), pi.new_tensor(W_FLOOR))
    mu, var = latent_moments(kernel, inducing, tmatmul(v, a),
                             mode_factor(v, d, w), Xstar)
    return mackay_squash(mu, var), mu, var


def no_sigma2(pack, what: str):
    if pack.learn_sigma2:
        raise ValueError(
            f"{what} has no sigma2: build the pack with "
            "make_pack(..., learn_sigma2=False)")


def fit_laplace(objective, pack, data, normalize, n, mesh=None,
                **fit_kwargs):
    """The packed device L-BFGS over ``-scale * objective(x, *data)``
    (``optim.fit_packed_objective``); returns the final state.  With
    ``mesh`` the objective is a sharded one, replicated on every rank of
    the mesh, and its gradient ``parallel.spmd.sharded_value_and_grad``'s."""
    from ..optim.lbfgs_device import fit_packed_objective, value_and_grad

    scale = 1.0 / n if normalize else 1.0

    def neg(x, *data):
        return -scale * objective(x, *data)

    if mesh is None:
        fg = value_and_grad(neg)
    else:
        import functools

        from ..parallel.spmd import sharded_value_and_grad

        fg = functools.partial(sharded_value_and_grad, mesh, neg)
    return fit_packed_objective(fg, pack, data, **fit_kwargs)


def fit_classify(X, y, pack, *, newton_iters: int = 15,
                 jitter: float | None = None, normalize: bool = True,
                 mesh=None, block_size: int | None = None, **fit_kwargs):
    """Hyper and inducing training of the Laplace classifier with the
    device L-BFGS.  The JAX ``fit_classify(family, ...)`` minus ``family``:
    the pack's kernel class is it.  Build ``pack`` with
    ``learn_sigma2=False``.  ``block_size`` streams the Newton.  With
    ``mesh`` (a ``parallel.DataMesh``; call it on every rank) the rows
    shard over the mesh and the objective is
    ``parallel.sharded_classify_log_evidence``; both options compose.
    Returns (kernel, z, state)."""
    no_sigma2(pack, "classification")
    if mesh is None:
        def objective(x, X, y):
            kernel, z, _ = pack.unpack(x)
            return classify_log_evidence(kernel, z, X, y,
                                         newton_iters=newton_iters,
                                         jitter=jitter,
                                         block_size=block_size)

        data = (X, y)
    else:
        from ..parallel.classify_sharded import sharded_classify_log_evidence
        from ..parallel.sharded import shard_batch

        def objective(x, Xs, ys, mask):
            kernel, z, _ = pack.unpack(x)
            return sharded_classify_log_evidence(
                kernel, mesh, z, Xs, ys, mask, newton_iters=newton_iters,
                jitter=jitter, block_size=block_size)

        data = shard_batch(mesh, X, y)
    st = fit_laplace(objective, pack, data, normalize, X.shape[0],
                     mesh=mesh, **fit_kwargs)
    kernel, z, _ = pack.unpack(st.x)
    return kernel, z, st
