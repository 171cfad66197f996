"""Pairwise squared distances: the counterpart of ``gpr_tpu/kernels/base.py``."""

from __future__ import annotations

import torch

from ..config import config
from ..numerics.linalg import matmul


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between rows of a (n, d) and b (m, d),
    clamped at zero against rounding.

    ``config.sqdist_impl == "gemm"`` (default) uses |a|^2 - 2 a.b + |b|^2,
    one GEMM; ``"direct"`` sums (a_k - b_k)^2 elementwise, which has no
    cancellation and so ~1-ulp entries for near pairs.
    """
    if config.sqdist_impl == "direct":
        d2 = torch.sum(torch.square(a[:, None, :] - b[None, :, :]), dim=-1)
        return torch.clamp(d2, min=0.0)
    a2 = torch.sum(torch.square(a), dim=-1)
    b2 = torch.sum(torch.square(b), dim=-1)
    d2 = a2[:, None] - 2.0 * matmul(a, b.T) + b2[None, :]
    return torch.clamp(d2, min=0.0)
