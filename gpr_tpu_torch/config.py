"""Global configuration of the PyTorch port.

The counterpart of ``gpr_tpu/config.py``: the reference's ``cholesky_jitter``
plus the precision dials.  Left out on purpose: ``acc_precision`` and
``bwd_demote_sites``, which were tuned for the TPU's multi-pass bf16 GEMMs.

``matmul_precision`` maps onto PyTorch's TF32 switches instead of a
``lax.Precision``: ``"highest"`` (the default) runs float32 products in full
float32; ``"high"`` and ``"default"`` allow TF32 (about three decimal digits
in the inputs).  :func:`apply_precision` writes both switches explicitly,
and :func:`gpr_tpu_torch.numerics.linalg.matmul` calls it before every
product, so the policy never rests on PyTorch's own defaults (which differ
between matmul and cuDNN).
"""

from __future__ import annotations

import dataclasses

import torch

_TF32 = {"highest": False, "high": True, "default": True}


@dataclasses.dataclass
class Config:
    # Jitter added to the Cholesky factorization of Km (the reference's
    # lib/utils.ml:35).  In float32, cholesky_upper raises it to 1e-5 of the
    # mean diagonal.
    cholesky_jitter: float = 1e-6
    # "highest" | "high" | "default": see the module docstring.
    matmul_precision: str = "highest"
    # "gemm" | "direct": pairwise squared-distance assembly
    # (kernels/base.py:sqdist).  "direct" avoids the cancellation of the
    # |a|^2 - 2ab + |b|^2 expansion at O(n m d) elementwise cost.
    sqdist_impl: str = "gemm"
    # "qr" | "chol" | "auto": how the dense engine factors
    # B = Km + Knm' D^-1 Knm (models/fitc.py).  "auto" takes the stacked QR
    # while n m <= 2^24, the whitened Cholesky above.
    factorization: str = "auto"


config = Config()


def apply_precision(cfg: Config = config) -> None:
    """Set PyTorch's TF32 switches from ``cfg.matmul_precision``."""
    try:
        tf32 = _TF32[cfg.matmul_precision]
    except KeyError:
        raise ValueError(
            f"unknown matmul precision {cfg.matmul_precision!r}; valid: "
            f"{sorted(_TF32)}"
        ) from None
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
