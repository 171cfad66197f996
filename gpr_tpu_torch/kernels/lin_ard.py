"""Linear ARD kernel as an ``nn.Module``: k(x, y) = x' P^-1 y with
P = diag(ell_1^2 .. ell_d^2).

The counterpart of ``gpr_tpu/kernels/lin_ard.py`` (the reference's
lib/cov_lin_ard.ml).  Its inducing representation is the pre-scaled input
(``inducing_from_inputs``, lib/cov_lin_ard.ml:71), so ``k_upper`` is a
plain Gram of Z and ``k_cross`` scales only the inputs' side, as the
reference and the JAX package do.  Inducing points are not learned by
default.
"""

from __future__ import annotations

import torch
from torch import nn

from ..numerics.linalg import matmul
from .base import set_hypers, view_of


class LinArd(nn.Module):
    name = "lin_ard"
    param_names = ("log_ells",)
    static_names = ()
    optional_names = ()
    learn_inducing_default = False

    def __init__(self, log_ells, *, device="cuda", dtype=None):
        """``log_ells`` (d,) log lengthscales.  On the card unless
        ``device`` says otherwise (``"cpu"`` for CPU work)."""
        super().__init__()
        set_hypers(self, device, dtype, log_ells=log_ells)

    @classmethod
    def of(cls, log_ells: torch.Tensor) -> "LinArd":
        """A kernel whose hypers ARE ``log_ells``."""
        return view_of(cls, log_ells=log_ells)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "LinArd":
        """The reference's default log_ells = 0 (lib/cov_lin_ard.ml:73-74)
        on X's device and dtype."""
        return cls(torch.zeros(X.shape[-1]), device=X.device, dtype=X.dtype)

    def _scale(self, X: torch.Tensor) -> torch.Tensor:
        return X * torch.exp(-self.log_ells)[None, :]

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self._scale(X)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        return matmul(z, z.T)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.square(self._scale(X)), dim=-1)

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return matmul(self._scale(X), z.T)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        xs = self._scale(X)
        return matmul(xs, xs.T)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.square(x * torch.exp(-self.log_ells)))
