"""Matérn covariance families (3/2 and 5/2, isotropic) as ``nn.Module``s.

  Matérn-5/2: k(r) = sf2 (1 + a r + a^2 r^2 / 3) exp(-a r),  a = sqrt(5)/ell
  Matérn-3/2: k(r) = sf2 (1 + a r) exp(-a r),                a = sqrt(3)/ell

The counterpart of ``gpr_tpu/kernels/matern.py``.  Distances come from the
one-product ``sqdist``; the square root is gated at zero (``_safe_r``) so
that autograd stays finite at coincident points, and ``k_cross_vjp`` is the
hand pullback the streaming VJP uses.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .base import set_hypers, sqdist, sqdist_cotangent_reduce, view_of


def _safe_r(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with an autograd-safe zero: where d2 == 0 the kernel's
    r-derivative is 0 for both orders, so gating the sqrt's input keeps
    the backward finite without changing values."""
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2,
                                                   torch.ones_like(d2))),
                       torch.zeros_like(d2))


class _MaternBase(nn.Module):
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("log_ell", "log_sf2")
    static_names = ()
    optional_names = ()
    learn_inducing_default = True

    def __init__(self, log_ell=0.0, log_sf2=0.0, *, device="cuda",
                 dtype=None):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work)."""
        super().__init__()
        set_hypers(self, device, dtype, log_ell=log_ell, log_sf2=log_sf2)

    @classmethod
    def of(cls, log_ell: torch.Tensor, log_sf2: torch.Tensor):
        """A kernel whose hypers ARE the given tensors."""
        return view_of(cls, log_ell=log_ell, log_sf2=log_sf2)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None):
        """log_ell = log_sf2 = 0 on X's device and dtype; nothing is
        drawn."""
        return cls(0.0, 0.0, device=X.device, dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _k_of_d2(self, d2: torch.Tensor) -> torch.Tensor:
        ar = self._NU_A * torch.exp(-self.log_ell) * _safe_r(d2)
        return torch.exp(self.log_sf2) * self._poly(ar) * torch.exp(-ar)

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
        ``knm`` tile: (log_ell_bar, log_sf2_bar, z_bar), plain tensors.

        dk/dd2 is finite at coincident points (the 1/r of the sqrt chain
        cancels against the kernel's r factor):

          M32: dk/dd2 = -sf2 a^2 e^{-ar} / 2
          M52: dk/dd2 = -sf2 a^2 (1 + ar) e^{-ar} / 6

        and dk/dlog_ell = -2 d2 dk/dd2, so both the lengthscale's cotangent
        and z_bar reduce through ``sqdist_cotangent_reduce`` on
        c2 = knm_bar dk/dd2; k and k_diag are proportional to sf2.
        """
        a = self._NU_A * torch.exp(-self.log_ell)
        sf2 = torch.exp(self.log_sf2)
        ar = a * _safe_r(sqdist(X, z))
        c2 = knm_bar * self._dk_dd2(sf2, a, ar, torch.exp(-ar))
        z_bar, c_dot_d2, _ = sqdist_cotangent_reduce(c2, X, z)
        return (-2.0 * c_dot_d2,
                torch.sum(knm_bar * knm) + sf2 * torch.sum(kd_bar), z_bar)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self.k_upper(X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2)


class Matern52(_MaternBase):
    name = "matern52"
    _NU_A = math.sqrt(5.0)

    @staticmethod
    def _poly(ar):
        return 1.0 + ar + ar * ar / 3.0

    @staticmethod
    def _dk_dd2(sf2, a, ar, e):
        return (-sf2 / 6.0) * a * a * (1.0 + ar) * e


class Matern32(_MaternBase):
    name = "matern32"
    _NU_A = math.sqrt(3.0)

    @staticmethod
    def _poly(ar):
        return 1.0 + ar

    @staticmethod
    def _dk_dd2(sf2, a, ar, e):
        return (-0.5 * sf2) * a * a * e
