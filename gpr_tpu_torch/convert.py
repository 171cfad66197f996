"""Carry trained weights from the JAX package (or its artifacts) to tensors.

Both entries return ``(kernel module, z, sigma2)`` on an explicit device and
dtype, ready for the streaming functions of ``gpr_tpu_torch.models``.
Only the ``se_iso`` family is ported.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .io.checkpoint import ModelArtifact
from .kernels import SeIso, resolve_family


def from_jax_params(params: Mapping[str, np.ndarray], z, sigma2, *, device,
                    dtype):
    """``params`` maps field names of the JAX ``SeIso.Params`` to arrays
    (``{"log_ell": ..., "log_sf2": ...}``); ``z`` is the (m, d) inducing
    representation and ``sigma2`` the noise variance."""
    names = set(params)
    if names != {"log_ell", "log_sf2"}:
        raise ValueError(
            f"expected se_iso parameters log_ell and log_sf2, got "
            f"{sorted(names)}"
        )
    kernel = SeIso(
        float(np.asarray(params["log_ell"])),
        float(np.asarray(params["log_sf2"])),
        device=device, dtype=dtype,
    )
    z_t = torch.tensor(np.asarray(z), dtype=dtype, device=device)
    s2_t = torch.as_tensor(float(np.asarray(sigma2)), dtype=dtype,
                           device=device)
    return kernel, z_t, s2_t


def params_from_artifact(art: ModelArtifact, *, device, dtype):
    """:func:`from_jax_params` for an artifact of ``io.checkpoint``."""
    resolve_family(art.family_name)
    return from_jax_params(art.kernel_params, art.inducing, art.sigma2,
                           device=device, dtype=dtype)
