"""Linear kernel with a bias as an ``nn.Module``:
k(x, y) = (x . y + 1) / theta^2.

The counterpart of ``gpr_tpu/kernels/lin_one.py`` (the reference's
lib/cov_lin_one.ml: const = exp(-2 log_theta) at :31, calc_upper = syrk +
const at :40-43).  Inducing points live in input space and are not learned
by default.
"""

from __future__ import annotations

import torch
from torch import nn

from ..numerics.linalg import matmul
from .base import set_hypers, view_of


class LinOne(nn.Module):
    name = "lin_one"
    param_names = ("log_theta",)
    static_names = ()
    optional_names = ()
    learn_inducing_default = False

    def __init__(self, log_theta=0.0, *, device="cuda", dtype=None):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work)."""
        super().__init__()
        set_hypers(self, device, dtype, log_theta=log_theta)

    @classmethod
    def of(cls, log_theta: torch.Tensor) -> "LinOne":
        """A kernel whose hyper IS ``log_theta``."""
        return view_of(cls, log_theta=log_theta)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "LinOne":
        """The reference's default log_theta = 0 (lib/cov_lin_one.ml:66-67)
        on X's device and dtype."""
        return cls(0.0, device=X.device, dtype=X.dtype)

    def _alpha(self) -> torch.Tensor:
        return torch.exp(-2.0 * self.log_theta)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        return self._alpha() * (matmul(z, z.T) + 1.0)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return self._alpha() * (torch.sum(torch.square(X), dim=-1) + 1.0)

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self._alpha() * (matmul(X, z.T) + 1.0)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self.k_upper(X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return self._alpha() * (torch.sum(torch.square(x)) + 1.0)
