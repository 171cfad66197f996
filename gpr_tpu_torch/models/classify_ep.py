"""Binary GP classification by Expectation Propagation over the FITC prior.
The counterpart of ``gpr_tpu/models/classify_ep.py``.

The alternative to the Laplace route of ``models/classify.py`` (GPML ch.
3.6): a PROBIT likelihood Phi(y f), whose tilted moments EP computes in
closed form (GPML eq. 3.58).  Parallel EP with damping: every sweep updates
all sites from the current marginals (a handful of (n, m) products, where
the sequential site loop would be n serial rank-1 updates), and a fixed
number of sweeps keeps the sites a differentiable function of the prior.

Every n x n object collapses through K = V V' + diag(d).  With site
precisions ttau the posterior marginals come from the cancellation-free
double Woodbury

  Sigma = diag(d g) + Vt (I + V'QV)^-1 Vt',
  Vt = diag(g) V,  g = 1/(1 + ttau d),  Q = diag(q),  q = ttau g,

a sum of positive terms (K - KPK cancels below f32's rounding at 10^6
rows), and the evidence quadratic uses P = (K + diag(1/ttau))^-1 =
Q - QV(I + V'QV)^-1 V'Q: one m x m Cholesky a sweep.  The EP evidence, with
rows whose site precision underflows to 0 contributing their exact limit
(``ep_log_evidence_from_sites``):

  log Z_EP = sum_i [ log Phi(z_i)
                     + 1/2 (log1p(ttau_i s2_ni) - log1p(ttau_i d_i))
                     + (ttau_i mu_ni - tnu_i)^2
                       / (2 ttau_i (1 + ttau_i s2_ni)) ]
             - 1/2 log|I + V'QV| - 1/2 mu~' P mu~,    mu~ = tnu/ttau.

Gradients: ``grad_impl="stationary"`` (default) runs the sweeps without a
graph, since log Z_EP is stationary in the sites at a fixed point (GPML
section 5.5.2); ``"unroll"`` differentiates through the sweeps, each under
``torch.utils.checkpoint``.  The evidence runs in the rows' dtype, as in
the JAX package: unlike the Laplace Newton (``models/ift.py``), EP's f32
sweeps hold at bench's 10^6 rows, and f64 sweeps and evidence on the f32
V would not resolve the f32 log-lengthscale gradient either
(``chip_smoke.py``'s classify_ext phase).  The predictor (``ep_predict``,
``ep_posterior_state``) runs its sweeps and m-space algebra in
``ift.MODE_DTYPE`` on the rows' V (``classify.prior_up``) and returns in
the rows' dtype: in f32 its latent means lie 6e-4 and its variances
1.5e-4 off (2-norm; the same phase).  Products over the rows take
8,192-row partial sums (``ift.tmatmul``).  Where the JAX package takes
``(family, params)`` the port takes a kernel module.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..numerics.linalg import (
    cholesky_upper,
    inv_tri_upper,
    log_det_tri,
    matmul,
    rows_sqr_norm,
    solve_tri,
    solve_tri_right,
)
from .classify import _fitc_prior, fit_laplace, no_sigma2, prior_up
from .ift import _identity, tmatmul, up

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _max(x, c):
    """max(x, c) with the JAX package's gradient, split evenly at a tie
    (``torch.clamp`` passes all of it)."""
    return torch.maximum(x, x.new_tensor(c))


def _probit_moments(y, mu_n, s2_n):
    """(log Z_hat, dlZ, d2lZ) of the probit site as functions of the
    cavity (GPML eq. 3.58)."""
    denom = torch.sqrt(1.0 + s2_n)
    z = y * mu_n / denom
    lZ = torch.special.log_ndtr(z)
    # N(z)/Phi(z) as exp(log pdf - log cdf): 0 for z >> 0, not 0/0
    ratio = torch.exp(-0.5 * z * z - _HALF_LOG_2PI - lZ)
    dlZ = y * ratio / denom
    d2lZ = ratio * (z + ratio) / (1.0 + s2_n)
    return lZ, dlZ, d2lZ


def _sqrt_q(q):
    """sqrt(q) with the double where: all sites are 0 on the first sweep,
    where sqrt's cotangent is inf (and inf * 0 = NaN in the backward)."""
    pos = q > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, q, 1.0)), 0.0)


def _site_factor(v, q, allsum):
    """Upper R with R'R = I + V' diag(q) V."""
    vq = v * _sqrt_q(q)[:, None]
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return cholesky_upper(eye + allsum(tmatmul(vq, vq)), jitter=0.0)


def _msolve(r, t):
    return solve_tri(r, solve_tri(r, t, trans=True))


def _marginals(v, d, ttau, tnu, r, allsum):
    """(mu, sigma2) of N(mu, Sigma), Sigma = (K^-1 + diag(ttau))^-1 and
    mu = Sigma tnu, in the double-Woodbury form of the module docstring (at
    ttau = 0 exactly d + rowsq(V) = diag(K)); ``r`` the site factor."""
    g = 1.0 / (1.0 + ttau * d)
    vt = v * g[:, None]
    gt = allsum(tmatmul(v, g * tnu))  # Vt' tnu
    mu = d * g * tnu + matmul(vt, _msolve(r, gt))
    sigma2 = d * g + rows_sqr_norm(solve_tri_right(vt, r))
    return mu, sigma2


def _cavity(mu, sigma2, ttau, tnu):
    """(mu_n, s2_n) of the cavities; the clip keeps the first sweeps sane
    where a marginal is barely tighter than its own site."""
    tau_n = _max(1.0 / sigma2 - ttau, 1e-10)
    nu_n = mu / sigma2 - tnu
    return nu_n / tau_n, 1.0 / tau_n


def _sweep(v, d, y, mask, ttau, tnu, damping, allsum):
    """One damped parallel EP sweep; (ttau, tnu, rms site-precision
    change)."""
    q = ttau / (1.0 + ttau * d)
    r = _site_factor(v, q, allsum)
    mu, sigma2 = _marginals(v, d, ttau, tnu, r, allsum)
    mu_n, s2_n = _cavity(mu, sigma2, ttau, tnu)
    _, dlZ, d2lZ = _probit_moments(y, mu_n, s2_n)
    # new sites (GPML's stable form); d2lZ lies in (0, 1/s2_n) for probit
    den = _max(1.0 - s2_n * d2lZ, 1e-10)
    ttau_new = mask * _max(d2lZ / den, 0.0)
    tnu_new = mask * (dlZ + mu_n * d2lZ) / den
    ttau2 = (1.0 - damping) * ttau + damping * ttau_new
    tnu2 = (1.0 - damping) * tnu + damping * tnu_new
    live = _max(allsum(torch.sum(mask)), 1.0)
    delta = torch.sqrt(allsum(torch.sum((ttau2 - ttau) ** 2)) / live)
    return ttau2, tnu2, delta


def ep_sweeps(v, d, y, mask, *, n_sweeps: int = 20, damping: float = 0.5,
              allsum=_identity, trace: bool = False):
    """Parallel EP over the rows of the FITC prior K = V V' + diag(d).

    ``y`` in {-1, +1}; ``mask`` zeroes padded rows (their sites stay exactly
    (0, 0)).  ``allsum`` reduces the cross-row sums (identity on one
    device).  Returns (ttau, tnu) after ``n_sweeps`` damped sweeps from zero
    sites; with ``trace=True`` (ttau, tnu, deltas), deltas[k] the rms site
    precision change of sweep k (damped parallel EP has no monotone
    objective: watch the deltas shrink).  Where autograd records, each
    sweep runs under ``torch.utils.checkpoint``."""
    ttau = torch.zeros_like(y)
    tnu = torch.zeros_like(y)
    remat = torch.is_grad_enabled()
    deltas = []
    for _ in range(n_sweeps):
        if remat:
            ttau, tnu, delta = checkpoint(_sweep, v, d, y, mask, ttau, tnu,
                                          damping, allsum,
                                          use_reentrant=False)
        else:
            ttau, tnu, delta = _sweep(v, d, y, mask, ttau, tnu, damping,
                                      allsum)
        deltas.append(delta)
    if trace:
        return ttau, tnu, torch.stack(deltas)
    return ttau, tnu


def _ep_state(v, d, y, mask, ttau, tnu, allsum=_identity):
    """(q, R, pdot) at the final sites: the m-space factor shared by the
    evidence and the predictor, and x -> P x."""
    q = ttau / (1.0 + ttau * d)
    r = _site_factor(v, q, allsum)

    def pdot(x):
        qx = q * x
        return qx - q * matmul(v, _msolve(r, allsum(tmatmul(v, qx))))

    return q, r, pdot


def ep_log_evidence_from_sites(v, d, y, mask, ttau, tnu, allsum=_identity):
    """log Z_EP at the sites (ttau, tnu), robust to ttau_i = 0.

    Confident rows' site precisions underflow in f32 (d2lZ ~ exp(-z^2/2)),
    where the textbook formula takes log(0) twice; the two divergences
    cancel row by row, so they are folded: the site-normalizer variance
    term and the determinant's diagonal factor combine to
    1/2 [log1p(ttau s2_ni) - log1p(ttau d_i)] (exactly 0 at ttau = 0), and
    the site-mean quadratic becomes (ttau mu_ni - tnu)^2 /
    (2 ttau (1 + ttau s2_ni)), where-gated on ttau > 0.  Masked rows have
    (ttau, tnu) = (0, 0) and contribute exactly nothing."""
    _, r, pdot = _ep_state(v, d, y, mask, ttau, tnu, allsum)
    mu, sigma2 = _marginals(v, d, ttau, tnu, r, allsum)
    mu_n, s2_n = _cavity(mu, sigma2, ttau, tnu)
    lZ, _, _ = _probit_moments(y, mu_n, s2_n)

    active = ttau > 0.0
    ttau_s = torch.where(active, ttau, 1.0)
    site_terms = (
        lZ
        + 0.5 * (torch.log1p(ttau * s2_n) - torch.log1p(ttau * d))
        + torch.where(active, 0.5 * (ttau * mu_n - tnu) ** 2
                      / (ttau_s * (1.0 + ttau * s2_n)), 0.0))
    # what is left of log|K + S~| after the diagonal fold: log|I + V'QV|
    mu_t = torch.where(active, tnu / ttau_s, 0.0)
    quad = allsum(torch.sum(mu_t * pdot(mu_t)))
    return (allsum(torch.sum(mask * site_terms)) - 0.5 * log_det_tri(r)
            - 0.5 * quad)


def _sites(v, d, y, n_sweeps, damping, grad_impl):
    """The sites of ``ep_sweeps`` from zero: without a graph for
    "stationary", through the checkpointed sweeps for "unroll"."""
    mask = torch.ones_like(y)
    if grad_impl == "stationary":
        with torch.no_grad():
            ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=n_sweeps,
                                  damping=damping)
    elif grad_impl == "unroll":
        ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=n_sweeps,
                              damping=damping)
    else:
        raise ValueError(
            f"grad_impl must be 'stationary' or 'unroll', got {grad_impl}")
    return mask, ttau, tnu


def ep_log_evidence(kernel, z, X, y, *, n_sweeps: int = 20,
                    damping: float = 0.5, jitter: float | None = None,
                    grad_impl: str = "stationary"):
    """The EP marginal likelihood log Z_EP(y | X, hypers), ``y`` in
    {-1, +1}, differentiable in the kernel's hypers and ``z``.

    "stationary" (default) takes the explicit (V, d) dependence alone, the
    exact gradient at an EP fixed point (the sites are constants to
    autograd, so the backward never retraverses the sweeps); "unroll"
    differentiates through the sweeps.  Both are as accurate as the sites
    are converged."""
    _, v, d = _fitc_prior(kernel, z, X, jitter)
    mask, ttau, tnu = _sites(v, d, y, n_sweeps, damping, grad_impl)
    return ep_log_evidence_from_sites(v, d, y, mask, ttau, tnu)


def _mu_tilde(ttau, tnu):
    return torch.where(ttau > 0, tnu / _max(ttau, 1e-10), 0.0)


def ep_predict(kernel, z, X, y, Xstar, *, n_sweeps: int = 20,
               damping: float = 0.5, jitter: float | None = None):
    """(prob, latent_mean, latent_var) at Xstar under the EP posterior:
    mu* = k*' P mu~, var* = k** - k*' P k* (GPML eq. 3.60 with the low-rank
    P), and the probit predictive integral is exact, p = Phi(mu* /
    sqrt(1 + var*)) (GPML eq. 3.77)."""
    inducing, v, d = prior_up(kernel, z, X, jitter)
    y = up(y)
    mask = torch.ones_like(y)
    ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=n_sweeps, damping=damping)
    q, r, pdot = _ep_state(v, d, y, mask, ttau, tnu)

    u_inv = up(inv_tri_upper(inducing.chol_km))
    vstar = matmul(up(kernel.k_cross(Xstar, inducing.z)), u_inv)
    # k*_i = V v*_i (the FITC conditional), so k*' P x = v* V' P x
    mu = matmul(vstar, tmatmul(v, pdot(_mu_tilde(ttau, tnu))))
    # k*' P k* = v* M1 v*',  M1 = W - W (R'R)^-1 W,  W = V'QV
    w = tmatmul(v * q[:, None], v)
    m1 = w - matmul(w, _msolve(r, w))
    quad = torch.sum(matmul(vstar, m1) * vstar, dim=1)
    var = _max(up(kernel.k_diag(Xstar)) - quad, 1e-12)
    prob = torch.exp(torch.special.log_ndtr(mu / torch.sqrt(1.0 + var)))
    return tuple(t.to(Xstar.dtype) for t in (prob, mu, var))


def ep_posterior_state(kernel, z, X, y, *, n_sweeps: int = 20,
                       damping: float = 0.5, jitter: float | None = None):
    """The m-space EP predictor state in the standard artifact's shapes:
    (inducing, coeffs, R) with

      mu*  = K*m coeffs,   coeffs = U^-1 V' P mu~,
      var* = k** - rowsq(K*m U^-1) + rowsq(K*m (R U)^-1),

    since k*' P k* = v* (I - (I + W)^-1) v*': the Laplace posterior's
    collapse, so EP models serve through the shared predictors and only the
    squash differs (the exact probit predictive)."""
    inducing, v, d = prior_up(kernel, z, X, jitter)
    y = up(y)
    mask = torch.ones_like(y)
    ttau, tnu = ep_sweeps(v, d, y, mask, n_sweeps=n_sweeps, damping=damping)
    _, r, pdot = _ep_state(v, d, y, mask, ttau, tnu)
    coeffs = solve_tri(up(inducing.chol_km),
                       tmatmul(v, pdot(_mu_tilde(ttau, tnu))))
    return inducing, coeffs.to(X.dtype), r.to(X.dtype)


def fit_classify_ep(X, y, pack, *, n_sweeps: int = 20, damping: float = 0.5,
                    jitter: float | None = None, normalize: bool = True,
                    mesh=None, **fit_kwargs):
    """Hyper and inducing training on the EP evidence with the device
    L-BFGS: the JAX ``fit_classify_ep(family, ...)`` minus ``family`` (the
    pack's kernel class is it).  Build ``pack`` with ``learn_sigma2=False``.
    With ``mesh`` (a ``parallel.DataMesh``; call it on every rank) the rows
    shard over the mesh and the objective is
    ``parallel.sharded_ep_log_evidence``.  Returns (kernel, z, state)."""
    no_sigma2(pack, "classification")
    if mesh is None:
        def objective(x, X, y):
            kernel, z, _ = pack.unpack(x)
            return ep_log_evidence(kernel, z, X, y, n_sweeps=n_sweeps,
                                   damping=damping, jitter=jitter)

        data = (X, y)
    else:
        from ..parallel.classify_sharded import sharded_ep_log_evidence
        from ..parallel.sharded import shard_batch

        def objective(x, Xs, ys, mask):
            kernel, z, _ = pack.unpack(x)
            return sharded_ep_log_evidence(
                kernel, mesh, z, Xs, ys, mask, n_sweeps=n_sweeps,
                damping=damping, jitter=jitter)

        data = shard_batch(mesh, X, y)
    st = fit_laplace(objective, pack, data, normalize, X.shape[0],
                     mesh=mesh, **fit_kwargs)
    kernel, z, _ = pack.unpack(st.x)
    return kernel, z, st
