"""Rational-quadratic covariance family (isotropic) as an ``nn.Module``.

  k(d2) = sf2 (1 + d2 / (2 alpha ell^2))^(-alpha)

The counterpart of ``gpr_tpu/kernels/rq.py``: a scale mixture of squared
exponentials (alpha -> infinity recovers se_iso), with the hyper fields
log_alpha, log_ell and log_sf2 and the hand pullback ``k_cross_vjp`` the
streaming VJP uses.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import set_hypers, sqdist, sqdist_cotangent_reduce, view_of


class RatQuad(nn.Module):
    name = "rq"
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("log_alpha", "log_ell", "log_sf2")
    #: the JAX ``Params`` declaration order (``base.declared_names``)
    declared_names = ("log_ell", "log_sf2", "log_alpha")
    static_names = ()
    optional_names = ()
    learn_inducing_default = True

    def __init__(self, log_ell=0.0, log_sf2=0.0, log_alpha=0.0, *,
                 device="cuda", dtype=None):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work)."""
        super().__init__()
        set_hypers(self, device, dtype, log_ell=log_ell, log_sf2=log_sf2,
                   log_alpha=log_alpha)

    @classmethod
    def of(cls, log_alpha: torch.Tensor, log_ell: torch.Tensor,
           log_sf2: torch.Tensor) -> "RatQuad":
        """A kernel whose hypers ARE the given tensors."""
        return view_of(cls, log_alpha=log_alpha, log_ell=log_ell,
                       log_sf2=log_sf2)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "RatQuad":
        """All three hypers 0 on X's device and dtype; nothing is drawn."""
        return cls(0.0, 0.0, 0.0, device=X.device, dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _k_of_d2(self, d2: torch.Tensor) -> torch.Tensor:
        alpha = torch.exp(self.log_alpha)
        q = d2 * torch.exp(-2.0 * self.log_ell) / (2.0 * alpha)
        return torch.exp(self.log_sf2) * (1.0 + q) ** (-alpha)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        """(m, m) K(Z, Z), exactly sf2 on the diagonal."""
        k = self._k_of_d2(sqdist(z, z))
        eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
        return torch.where(eye, torch.exp(self.log_sf2), k)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2).expand(X.shape[0])

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self._k_of_d2(sqdist(X, z))

    def k_cross_vjp(self, X, z, knm, knm_bar, kd_bar):
        """Hand-fused pullback of (k_cross, k_diag) given the computed
        ``knm`` tile: (log_alpha_bar, log_ell_bar, log_sf2_bar, z_bar).

        With u = d2 / ell^2 and q = u / (2 alpha):

          dk/dd2        = -(k / (2 ell^2)) / (1 + q)
          dk/dlog_ell   = -2 d2 dk/dd2
          dk/dlog_alpha = alpha k (q / (1 + q) - log1p(q))
          dk/dlog_sf2   = k;  k_diag is proportional to sf2.

        log_ell and z_bar ride ``sqdist_cotangent_reduce`` on
        c2 = knm_bar dk/dd2; log_alpha takes one more elementwise sum.
        """
        alpha = torch.exp(self.log_alpha)
        sf2 = torch.exp(self.log_sf2)
        inv_ell2 = torch.exp(-2.0 * self.log_ell)
        q = sqdist(X, z) * inv_ell2 / (2.0 * alpha)
        c2 = knm_bar * (-0.5 * inv_ell2) * knm / (1.0 + q)
        z_bar, c_dot_d2, _ = sqdist_cotangent_reduce(c2, X, z)
        alpha_term = torch.sum(knm_bar * knm * (q / (1.0 + q)
                                                - torch.log1p(q)))
        return (alpha * alpha_term, -2.0 * c_dot_d2,
                torch.sum(knm_bar * knm) + sf2 * torch.sum(kd_bar), z_bar)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self.k_upper(X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2)
