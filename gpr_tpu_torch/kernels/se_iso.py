"""Isotropic squared-exponential kernel as an ``nn.Module``.

k(x, y) = sf2 * exp(-||x - y||^2 / (2 ell^2)),  sf2 = exp(log_sf2).

The counterpart of ``gpr_tpu/kernels/se_iso.py``.  Where the JAX family is a
class of static methods over a params pytree, here the module holds
``log_ell`` and ``log_sf2`` as parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import sqdist


class SeIso(nn.Module):
    name = "se_iso"

    def __init__(self, log_ell: float = 0.0, log_sf2: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.log_ell = nn.Parameter(torch.as_tensor(log_ell, **kw).clone())
        self.log_sf2 = nn.Parameter(torch.as_tensor(log_sf2, **kw).clone())

    def _k_of_d2(self, d2: torch.Tensor) -> torch.Tensor:
        inv_ell2_05 = -0.5 * torch.exp(-2.0 * self.log_ell)
        return torch.exp(self.log_sf2 + inv_ell2_05 * d2)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        """(m, m) K(Z, Z), with exactly sf2 on the diagonal: the sqdist
        expansion can leave tiny nonzeros there."""
        k = self._k_of_d2(sqdist(z, z))
        eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
        return torch.where(eye, torch.exp(self.log_sf2), k)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) prior variances, all sf2."""
        return torch.exp(self.log_sf2).expand(X.shape[0])

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """(n, m) cross-covariance K(X, Z)."""
        return self._k_of_d2(sqdist(X, z))
