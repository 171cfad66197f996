"""Periodic covariance family (MacKay's exp-sine-squared) as an
``nn.Module``.

  k(x, z) = sf2 exp(-(2 / ell^2) sum_d sin^2(pi (x_d - z_d) / p))

The counterpart of ``gpr_tpu/kernels/periodic.py``, with one shared period
p and lengthscale ell.  With sin^2(t/2) = (1 - cos t)/2 and the angle
difference identity, sum_d cos(2 pi (x_d - z_d) / p) = Cx Cz' + Sx Sz'
(Cx = cos(2 pi x / p), Sx = sin(2 pi x / p)): one (n, 2d) x (2d, m) product
on the [C | S] features instead of an (n, m, d) tensor.  The streaming VJP
pulls a tile back through autograd.
"""

from __future__ import annotations

import torch
from torch import nn

from ..numerics.linalg import matmul
from .base import set_hypers, view_of

_TWO_PI = 6.283185307179586


class Periodic(nn.Module):
    name = "periodic"
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("log_ell", "log_period", "log_sf2")
    #: the JAX ``Params`` declaration order (``base.declared_names``)
    declared_names = ("log_ell", "log_sf2", "log_period")
    static_names = ()
    optional_names = ()
    learn_inducing_default = True

    def __init__(self, log_ell=0.0, log_sf2=0.0, log_period=0.0, *,
                 device="cuda", dtype=None):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work)."""
        super().__init__()
        set_hypers(self, device, dtype, log_ell=log_ell, log_sf2=log_sf2,
                   log_period=log_period)

    @classmethod
    def of(cls, log_ell: torch.Tensor, log_period: torch.Tensor,
           log_sf2: torch.Tensor) -> "Periodic":
        """A kernel whose hypers ARE the given tensors."""
        return view_of(cls, log_ell=log_ell, log_period=log_period,
                       log_sf2=log_sf2)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None
                       ) -> "Periodic":
        """All three hypers 0 on X's device and dtype; nothing is drawn."""
        return cls(0.0, 0.0, 0.0, device=X.device, dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _cos_sum(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """sum_d cos(2 pi (x_d - z_d) / p) through the [C | S] product."""
        w = _TWO_PI * torch.exp(-self.log_period)
        fx = torch.cat([torch.cos(w * X), torch.sin(w * X)], dim=1)
        fz = torch.cat([torch.cos(w * z), torch.sin(w * z)], dim=1)
        return matmul(fx, fz.T)

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        # 2 sum sin^2(./2) / ell^2 = (d - sum cos) / ell^2
        inv_ell2 = torch.exp(-2.0 * self.log_ell)
        cs = self._cos_sum(X, z)
        return torch.exp(self.log_sf2) * torch.exp(-(X.shape[1] - cs)
                                                   * inv_ell2)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        """(m, m) K(Z, Z), exactly sf2 on the diagonal (the product's
        cosine sum rounds near d)."""
        k = self.k_cross(z, z)
        eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
        return torch.where(eye, torch.exp(self.log_sf2), k)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2).expand(X.shape[0])

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self.k_upper(X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2)
