"""Cosine covariance family as an ``nn.Module``: the oscillation factor of
spectral-mixture kernels.

  k(x, y) = cos(2 pi mu . (x - y))

The counterpart of ``gpr_tpu/kernels/cosine.py``, with a learnable
frequency vector mu (d,).  It is a linear kernel on the two features
[cos(2 pi mu.x), sin(2 pi mu.x)], and is evaluated so: one (n, 2) x (2, m)
product.  The streaming VJP pulls a tile back through autograd.
"""

from __future__ import annotations

import torch
from torch import nn

from ..numerics.linalg import matmul
from .base import set_hypers, view_of

_TWO_PI = 6.283185307179586


class Cosine(nn.Module):
    name = "cosine"
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("mu",)
    static_names = ()
    optional_names = ()
    learn_inducing_default = True

    def __init__(self, mu, *, device="cuda", dtype=None):
        """``mu`` (d,) the frequency vector.  On the card unless ``device``
        says otherwise (``"cpu"`` for CPU work)."""
        super().__init__()
        set_hypers(self, device, dtype, mu=mu)

    @classmethod
    def of(cls, mu: torch.Tensor) -> "Cosine":
        """A kernel whose frequency vector IS ``mu``."""
        return view_of(cls, mu=mu)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "Cosine":
        """Positive random frequencies |0.3 N(0, 1)| + 0.05 drawn from
        ``generator`` (mu = 0 is a stationary point of the evidence), or
        0.25 in every dimension without one, as the JAX package does
        without a key.  The draws are the generator's, not JAX's."""
        kw = {"dtype": X.dtype, "device": X.device}
        d = X.shape[-1]
        if generator is None:
            mu = torch.full((d,), 0.25, **kw)
        else:
            mu = torch.abs(0.3 * torch.randn(d, generator=generator,
                                             **kw)) + 0.05
        return cls(mu, device=X.device, dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _features(self, X: torch.Tensor) -> torch.Tensor:
        t = _TWO_PI * matmul(X, self.mu)  # (n,)
        return torch.stack([torch.cos(t), torch.sin(t)], dim=-1)

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return matmul(self._features(X), self._features(z).T)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        return self.k_cross(z, z)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return self.k_cross(X, X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        return torch.ones((), dtype=x.dtype, device=x.device)
