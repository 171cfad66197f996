"""Warped sparse GPs: a monotone observation warp learned jointly.  The
counterpart of ``gpr_tpu/models/warped.py`` (Snelson, Ghahramani &
Rasmussen 2004).

A latent sparse GP over t = g(y) with the tanh-sum warp

  g(y)  = y + sum_k a_k tanh(b_k (y + c_k)),          a_k, b_k >= 0,
  g'(y) = 1 + sum_k a_k b_k sech^2(b_k (y + c_k)) >= 1,

so log p(y) = log N(g(y); 0, cov) + sum_i log g'(y_i): the streaming
evidence of g(y) plus the Jacobian sum, differentiable in the warp alongside
the kernel's hypers, z and sigma2.  ``warped_log_evidence`` goes through
``streaming_log_evidence`` with its default route, so SE-iso in f32 on the
card takes the statistics kernels, and the warp's gradient arrives through
the backward kernel's y cotangent.

Prediction: the latent posterior at x* is Gaussian in t-space; ``warp_inv``
(a fixed bisection on the bracket [t - sum a, t + sum a], then Newton)
gives the median and any quantile; the mean and variance integrate g^-1
against the latent Gaussian by Gauss-Hermite quadrature.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np
import torch
from torch import nn

from ..kernels.base import set_hypers, view_of
from .streaming import streaming_log_evidence

WARP_FIELDS = ("log_a", "log_b", "c")  # JAX's ravel order


class WarpParams(nn.Module):
    """tanh-sum warp hypers, (k,) each; positivity via exp (log_a,
    log_b)."""

    def __init__(self, log_a, log_b, c, *, device="cuda", dtype=None):
        """On the card unless ``device`` says otherwise."""
        super().__init__()
        set_hypers(self, device, dtype, log_a=log_a, log_b=log_b, c=c)

    @classmethod
    def of(cls, log_a, log_b, c) -> "WarpParams":
        """A warp whose fields ARE these tensors, so gradients reach them."""
        return view_of(cls, log_a=log_a, log_b=log_b, c=c)


def default_warp_params(n_terms: int = 3, *, device="cuda",
                        dtype=torch.float64) -> WarpParams:
    """Near-identity start: tiny amplitudes, unit slopes, centres spread
    over [-1, 1] (targets are centred upstream)."""
    return WarpParams(np.full(n_terms, -3.0), np.zeros(n_terms),
                      np.linspace(-1.0, 1.0, n_terms), device=device,
                      dtype=dtype)


def warp(wp: WarpParams, y):
    a = torch.exp(wp.log_a)
    b = torch.exp(wp.log_b)
    return y + torch.sum(a * torch.tanh(b * (y[..., None] + wp.c)), dim=-1)


def warp_deriv(wp: WarpParams, y):
    a = torch.exp(wp.log_a)
    b = torch.exp(wp.log_b)
    sech2 = 1.0 / torch.cosh(b * (y[..., None] + wp.c)) ** 2
    return 1.0 + torch.sum(a * b * sech2, dim=-1)


@torch.no_grad()
def warp_inv(wp: WarpParams, t, *, bisect_iters: int = 60,
             newton_iters: int = 3):
    """y with g(y) = t, elementwise: ``bisect_iters`` halvings of the
    bracket [t - sum a, t + sum a] (g' >= 1 keeps bisection safe), then
    ``newton_iters`` Newton steps.  A serving function: no gradient."""
    amp = torch.sum(torch.exp(wp.log_a))
    lo, hi = t - amp, t + amp
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        too_low = warp(wp, mid) < t
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    y = 0.5 * (lo + hi)
    for _ in range(newton_iters):
        y = y - (warp(wp, y) - t) / warp_deriv(wp, y)
    return y


def warped_log_evidence(kernel, wp: WarpParams, z, sigma2, X, y, *,
                        variational: bool = False, block_size: int = 8192,
                        jitter: float | None = None, **stream_kwargs):
    """Sparse-GP evidence of the warped targets plus the warp's Jacobian,
    differentiable in the kernel's hypers, ``wp``, ``z`` and ``sigma2``."""
    l = streaming_log_evidence(kernel, z, sigma2, X, warp(wp, y),
                               variational=variational,
                               block_size=block_size, jitter=jitter,
                               **stream_kwargs)
    return l + torch.sum(torch.log(warp_deriv(wp, y)))


def warped_predict_median(wp: WarpParams, latent_means):
    """The predictive median: g^-1 of the latent mean."""
    return warp_inv(wp, latent_means)


def warped_predict_quantile(wp: WarpParams, latent_means, latent_variances,
                            q: float):
    """Predictive q-quantile: g^-1(mu + Phi^-1(q) s)."""
    zq = NormalDist().inv_cdf(q)
    return warp_inv(wp, latent_means + zq * torch.sqrt(latent_variances))


def _hermite_nodes(wp, latent_means, latent_variances, n_nodes):
    """(g^-1 at the Gauss-Hermite nodes of N(mu, s2), weights)."""
    xs, ws = np.polynomial.hermite.hermgauss(n_nodes)
    kw = {"dtype": latent_means.dtype, "device": latent_means.device}
    xs = torch.as_tensor(xs, **kw)
    ws = torch.as_tensor(ws / np.sqrt(np.pi), **kw)
    s = torch.sqrt(latent_variances)
    nodes = latent_means[..., None] + math.sqrt(2.0) * s[..., None] * xs
    return warp_inv(wp, nodes), ws


def warped_predict_mean(wp: WarpParams, latent_means, latent_variances, *,
                        n_nodes: int = 20):
    """E[y*] = int g^-1(t) N(t; mu, s2) dt by Gauss-Hermite quadrature."""
    inv, ws = _hermite_nodes(wp, latent_means, latent_variances, n_nodes)
    return torch.sum(ws * inv, dim=-1)


def warped_predict_moments(wp: WarpParams, latent_means, latent_variances, *,
                           n_nodes: int = 20):
    """(E[y*], Var[y*]) of g^-1(t), t ~ N(mu, s2), by Gauss-Hermite
    quadrature: pass the predictive t-space variance (latent + sigma2) for
    observation moments, the latent variance for function moments."""
    inv, ws = _hermite_nodes(wp, latent_means, latent_variances, n_nodes)
    m1 = torch.sum(ws * inv, dim=-1)
    m2 = torch.sum(ws * inv * inv, dim=-1)
    return m1, torch.clamp(m2 - m1 * m1, min=0.0)


def make_warped_pack(pack, wp0: WarpParams):
    """Extend an ``optim.make_pack`` HyperPack with the warp: ``pack_w.x0``
    is ``[pack.x0 | log_a | log_b | c]`` (JAX's layout), and ``unpack_w(x)
    -> (kernel, z, sigma2, wp)``."""
    k = pack.x0.shape[0]
    sizes = [getattr(wp0, f).numel() for f in WARP_FIELDS]
    wflat = torch.cat([getattr(wp0, f).detach().reshape(-1)
                       for f in WARP_FIELDS]).to(pack.x0)
    pack_w = dataclasses.replace(pack, x0=torch.cat([pack.x0, wflat]),
                                 n_hypers=k + wflat.shape[0])

    def unpack_w(x):
        kernel, z, sigma2 = pack.unpack(x[:k])
        return (kernel, z, sigma2,
                WarpParams.of(*torch.split(x[k:], sizes)))

    return pack_w, unpack_w


def fit_warped(X, y, pack, wp0: WarpParams, *, variational: bool = False,
               block_size: int = 8192, jitter: float | None = None,
               normalize: bool = True, **fit_kwargs):
    """Joint (kernel hypers, inducing, sigma2, warp) training with the
    packed device L-BFGS (``normalize`` optimizes the mean NLL).  The JAX
    ``fit_warped(family, ...)`` minus ``family``: the pack's kernel class
    is it.  Returns (kernel, z, sigma2, wp, state)."""
    from ..optim.lbfgs_device import fit_packed_objective, value_and_grad

    pack_w, unpack_w = make_warped_pack(pack, wp0)
    scale = 1.0 / X.shape[0] if normalize else 1.0

    def neg(x, X, y):
        kernel, z, sigma2, wp = unpack_w(x)
        return -scale * warped_log_evidence(
            kernel, wp, z, sigma2, X, y, variational=variational,
            block_size=block_size, jitter=jitter)

    st = fit_packed_objective(value_and_grad(neg), pack_w, (X, y),
                              **fit_kwargs)
    kernel, z, sigma2, wp = unpack_w(st.x)
    return kernel, z, sigma2, wp, st
