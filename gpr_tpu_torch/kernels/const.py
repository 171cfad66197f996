"""Constant-function covariance as an ``nn.Module``:
k(x, y) = exp(-2 log_theta) = 1/theta^2.

The counterpart of ``gpr_tpu/kernels/const.py`` (the reference's
lib/cov_const.ml).  The reference's inducing representation is a point
count; here, as in the JAX package, Z is an (m, 0) tensor: m rows, no
feature columns.  Every covariance is the constant.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import set_hypers, view_of


class Const(nn.Module):
    name = "const"
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
    def of(cls, log_theta: torch.Tensor) -> "Const":
        """A kernel whose hyper IS ``log_theta``."""
        return view_of(cls, log_theta=log_theta)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "Const":
        """The reference's default log_theta = 0 (lib/cov_const.ml:57-58)
        on X's device and dtype."""
        return cls(0.0, device=X.device, dtype=X.dtype)

    def _const(self) -> torch.Tensor:
        return torch.exp(-2.0 * self.log_theta)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X[:, :0]  # (m, 0): carries only the point count

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        return self._const().expand(z.shape[0], z.shape[0])

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return self._const().expand(X.shape[0])

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self._const().expand(X.shape[0], z.shape[0])

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self._const().expand(X.shape[0], X.shape[0])

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return self._const()
