"""Model persistence: the JAX package's versioned npz artifacts.

The counterpart of ``gpr_tpu/io/checkpoint.py``, with the same schema
(``SCHEMA_VERSION = 1``), so an artifact written by either package loads in
the other: a flat npz with a json manifest, every leaf a named numpy array.
A kernel's parameters are a dict by field name: its arrays go to
``param__<name>``, its static fields (se_fat's ``d``) and the options that
are off (None) to the manifest's ``params_static``, as the JAX package's
``_params_to_arrays`` writes them.  A combinator's fields have the dotted
names that JAX's nested params flatten to (``terms.0.log_ell``,
``terms.1.terms.0.W``, ``terms.0.d`` for an se_fat term).  ``artifact_from_trained`` takes tensors
to the host; ``gpr_tpu_torch.convert.params_from_artifact`` turns an
artifact back into tensors.

The extras of the Gaussian-likelihood extensions are the JAX package's,
written and read as they are: ``student_t`` (nu) and ``t_scale`` (the t
scale; the artifact's sigma2 is the moment-matched noise variance),
``pitc_block``, ``warp_log_a``/``warp_log_b``/``warp_c``
(:func:`warp_extras`; ``convert.warp_from_jax`` reads them back), and
``exact``, whose artifact holds the training inputs as its inducing set,
alpha as its coeffs and chol(K + sigma2 I) as both chol_km and r_mat.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..kernels import resolve_family
from ..kernels.base import hyper_fields, static_fields

SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ModelArtifact:
    """Everything needed to serve means and (co)variances."""

    family_name: str
    # field name -> np.ndarray, or the static value (an int or None)
    kernel_params: dict
    inducing: np.ndarray  # inducing representation (m, dz)
    coeffs: np.ndarray  # (m,)
    chol_km: np.ndarray  # (m, m) upper
    r_mat: np.ndarray  # (m, m) upper
    sigma2: float
    target_mean: float
    input_means: np.ndarray  # (d,)
    input_stddevs: np.ndarray  # (d,)

    @property
    def family(self):
        return resolve_family(self.family_name)


def _params_to_arrays(params: dict) -> tuple[dict, dict]:
    """(arrays, static) of a kernel's parameter dict: ints and None go to
    the manifest, everything else is an array."""
    arrays, static = {}, {}
    for name, v in params.items():
        if v is None or (isinstance(v, int) and not hasattr(v, "shape")):
            static[name] = v
        else:
            arrays[name] = np.asarray(v)
    return arrays, static


def _host(t):
    return torch.as_tensor(t).detach().cpu().numpy()


def kernel_params_of(kernel) -> dict:
    """An artifact's ``kernel_params`` of a kernel module: its static fields
    and its hyper fields on the host (None where an option is off)."""
    return {**static_fields(kernel),
            **{name: None if t is None else _host(t)
               for name, t in hyper_fields(kernel).items()}}


def warp_extras(wp) -> dict:
    """A warped model's artifact extras, as the JAX package writes them:
    ``warp_log_a``, ``warp_log_b`` and ``warp_c``."""
    return {f"warp_{name}": _host(getattr(wp, name))
            for name in ("log_a", "log_b", "c")}


def artifact_from_trained(family, trained, *, target_mean=0.0,
                          input_means=None, input_stddevs=None,
                          kernel_params) -> ModelArtifact:
    """The artifact of a trained state (dense or streaming) and its kernel
    module ``kernel_params``, e.g. a ``TrainResult``'s ``trained`` and
    ``kernel_params``; tensors go to the host."""

    model = trained.model
    z = model.inducing.z
    d = z.shape[1] if z.ndim == 2 else 1
    return ModelArtifact(
        family_name=family.name,
        kernel_params=kernel_params_of(kernel_params),
        inducing=_host(z),
        coeffs=_host(trained.coeffs),
        chol_km=_host(model.inducing.chol_km),
        r_mat=_host(model.r_mat),
        sigma2=float(model.sigma2),
        target_mean=float(target_mean),
        input_means=np.asarray(input_means if input_means is not None
                               else np.zeros(d)),
        input_stddevs=np.asarray(input_stddevs if input_stddevs is not None
                                 else np.ones(d)),
    )


def save_model(path: str, art: ModelArtifact, extra_arrays: dict | None = None):
    resolve_family(art.family_name)
    params, params_static = _params_to_arrays(art.kernel_params)
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "family": art.family_name,
        "sigma2": float(art.sigma2),
        "target_mean": float(art.target_mean),
        "params_static": params_static,
        "params_arrays": sorted(params),
        "extra": sorted(extra_arrays) if extra_arrays else [],
    }
    arrays = {
        "inducing": np.asarray(art.inducing),
        "coeffs": np.asarray(art.coeffs),
        "chol_km": np.asarray(art.chol_km),
        "r_mat": np.asarray(art.r_mat),
        "input_means": np.asarray(art.input_means),
        "input_stddevs": np.asarray(art.input_stddevs),
    }
    arrays.update({f"param__{k}": v for k, v in params.items()})
    if extra_arrays:
        arrays.update(
            {f"extra__{k}": np.asarray(v) for k, v in extra_arrays.items()}
        )
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_model(path: str) -> tuple[ModelArtifact, dict]:
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        if manifest["schema_version"] > SCHEMA_VERSION:
            raise ValueError(
                f"model schema {manifest['schema_version']} is newer than "
                f"supported {SCHEMA_VERSION}"
            )
        resolve_family(manifest["family"])
        art = ModelArtifact(
            family_name=manifest["family"],
            kernel_params={
                **manifest["params_static"],
                **{name: z[f"param__{name}"]
                   for name in manifest["params_arrays"]},
            },
            inducing=z["inducing"],
            coeffs=z["coeffs"],
            chol_km=z["chol_km"],
            r_mat=z["r_mat"],
            sigma2=manifest["sigma2"],
            target_mean=manifest["target_mean"],
            input_means=z["input_means"],
            input_stddevs=z["input_stddevs"],
        )
        extra = {k: z[f"extra__{k}"] for k in manifest["extra"]}
    return art, extra
