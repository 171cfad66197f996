"""Carry trained weights from the JAX package (or its artifacts) to tensors.

Both entries return ``(kernel module, z, sigma2)`` on an explicit device and
dtype, ready for the streaming functions of ``gpr_tpu_torch.models``;
``warp_from_jax`` carries a warped GP's warp parameters.
Every family of the JAX package is ported: the base families
(``kernels.FAMILIES``) and every structural name (``sum(...)``,
``prod(...)``, ``cols(...)``, ``task(T,R)``), whose fields have dotted
names (``terms.0.log_ell``), as in an artifact.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .io.checkpoint import ModelArtifact
from .kernels import resolve_family
from .models.warped import WARP_FIELDS, WarpParams


def _dotted(params: Mapping, prefix: str = "") -> dict:
    """A combinator's nested fields (``{"terms": (term, ...)}``, each term a
    mapping) as dotted names; plain names stay as they are."""
    out = {}
    for name, v in params.items():
        if name == "terms" and isinstance(v, (list, tuple)):
            for i, term in enumerate(v):
                out.update(_dotted(term, f"{prefix}terms.{i}."))
        else:
            out[prefix + name] = v
    return out


def from_jax_params(params: Mapping, z, sigma2, *, device, dtype,
                    family="se_iso"):
    """``params`` maps field names of the JAX family's ``Params`` to arrays
    (se_iso: ``{"log_ell": ..., "log_sf2": ...}``), static fields to their
    values (se_fat's ``d``) and an option that is off to None or nothing;
    a combinator's fields go by their dotted names (``terms.0.log_ell``) or
    nested, as ``{"terms": ({"log_ell": ...}, ...)}``.  ``family`` is the
    family's name or kernel class; ``z`` is the (m, dz) inducing
    representation and ``sigma2`` the noise variance."""
    cls = resolve_family(family) if isinstance(family, str) else family
    params = _dotted(params)
    names = set(params)
    fields = set(cls.param_names) | set(cls.static_names)
    required = fields - set(cls.optional_names)
    if not required <= names <= fields:
        raise ValueError(
            f"expected {cls.name} parameters {sorted(required)} (optional: "
            f"{sorted(cls.optional_names)}), got {sorted(names)}"
        )
    kw = {name: v if v is None or name in cls.static_names else np.array(v)
          for name, v in params.items()}
    kernel = cls(**kw, device=device, dtype=dtype)
    z_t = torch.tensor(np.asarray(z), dtype=dtype, device=device)
    s2_t = torch.as_tensor(float(np.asarray(sigma2)), dtype=dtype,
                           device=device)
    return kernel, z_t, s2_t


def params_from_artifact(art: ModelArtifact, *, device, dtype):
    """:func:`from_jax_params` for an artifact of ``io.checkpoint``."""
    return from_jax_params(art.kernel_params, art.inducing, art.sigma2,
                           device=device, dtype=dtype,
                           family=art.family_name)


def warp_from_jax(wp, *, device, dtype):
    """The port's ``WarpParams`` from JAX's: its ``log_a``, ``log_b`` and
    ``c`` leaves as attributes (a JAX ``WarpParams``) or by name (a
    mapping of arrays)."""
    leaves = [wp[f] if isinstance(wp, Mapping) else getattr(wp, f)
              for f in WARP_FIELDS]
    return WarpParams(*(np.array(v) for v in leaves), device=device,
                      dtype=dtype)
