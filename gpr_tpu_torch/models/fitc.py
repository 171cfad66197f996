"""Inducing-point state: the part of ``gpr_tpu/models/fitc.py`` that the
streaming path needs.  The dense small-n engine is not ported yet."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..numerics.linalg import cholesky_upper, log_det_tri

LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class InducingState:
    """Precomputed inducing-point quantities."""

    z: torch.Tensor  # (m, dz) inducing representation
    km: torch.Tensor  # (m, m) K(Z, Z), no jitter
    chol_km: torch.Tensor  # upper U: Km + jitter I = U'U
    log_det_km: torch.Tensor  # log|Km + jitter I|


def calc_inducing(kernel, z: torch.Tensor,
                  jitter: float | None = None) -> InducingState:
    """K(Z, Z), its jittered Cholesky and log-det."""
    km = kernel.k_upper(z)
    chol_km = cholesky_upper(km, jitter)
    return InducingState(
        z=z, km=km, chol_km=chol_km, log_det_km=log_det_tri(chol_km)
    )
