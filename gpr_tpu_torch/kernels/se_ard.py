"""Anisotropic (ARD) squared-exponential kernel as an ``nn.Module``.

k(x, y) = sf2 * exp(-1/2 sum_d (x_d - y_d)^2 / ell_d^2)

The counterpart of ``gpr_tpu/kernels/se_ard.py``.  Evaluation scales the
inputs by 1/ell per dimension and rides the same one-product ``sqdist`` as
se_iso.  Inducing points stay in raw input space (scaled inside each call),
so their gradients compose with the learned lengthscales.  The streaming
VJP pulls a tile back through autograd (there is no hand pullback).
"""

from __future__ import annotations

import torch
from torch import nn

from .base import set_hypers, sqdist, view_of


class SeArd(nn.Module):
    name = "se_ard"
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("log_ells", "log_sf2")
    static_names = ()
    optional_names = ()
    learn_inducing_default = True

    def __init__(self, log_ells, log_sf2=0.0, *, device="cuda", dtype=None):
        """``log_ells`` (d,) log lengthscales.  On the card unless
        ``device`` says otherwise (``"cpu"`` for CPU work)."""
        super().__init__()
        set_hypers(self, device, dtype, log_ells=log_ells, log_sf2=log_sf2)

    @classmethod
    def of(cls, log_ells: torch.Tensor, log_sf2: torch.Tensor) -> "SeArd":
        """A kernel whose hypers ARE the given tensors."""
        return view_of(cls, log_ells=log_ells, log_sf2=log_sf2)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "SeArd":
        """Unit lengthscales and signal variance, on X's device and dtype;
        nothing is drawn."""
        return cls(torch.zeros(X.shape[-1]), 0.0, device=X.device,
                   dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _scaled(self, X: torch.Tensor) -> torch.Tensor:
        return X * torch.exp(-self.log_ells)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        """(m, m) K(Z, Z), exactly sf2 on the diagonal."""
        zs = self._scaled(z)
        k = torch.exp(self.log_sf2 - 0.5 * sqdist(zs, zs))
        eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
        return torch.where(eye, torch.exp(self.log_sf2), k)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2).expand(X.shape[0])

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2
                         - 0.5 * sqdist(self._scaled(X), self._scaled(z)))

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self.k_upper(X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_sf2)
