"""Hyper-prior building blocks for MAP estimation: the counterpart of
``gpr_tpu/optim/priors.py``.

A prior is any differentiable callable ``(kernel, z, sigma2) -> scalar log
density`` passed as ``log_prior=`` to :func:`gpr_tpu_torch.optim.fit`.  A
steep prior (small ``std`` / large ``strength``) doubles as a soft bound.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def normal(mean, std):
    """Gaussian log density, summed over the argument's elements."""

    def logp(value):
        value = torch.as_tensor(value)
        m = torch.as_tensor(mean, dtype=value.dtype, device=value.device)
        s = torch.as_tensor(std, dtype=value.dtype, device=value.device)
        zsc = (value - m) / s
        return torch.sum(-0.5 * (zsc * zsc + LOG_2PI) - torch.log(s))

    return logp


def soft_box(lo, hi, strength=100.0):
    """Differentiable box penalty: 0 inside [lo, hi], quadratic outside."""

    def logp(value):
        v = torch.as_tensor(value)
        below = torch.clamp(v - lo, max=0.0)
        above = torch.clamp(v - hi, min=0.0)
        return -strength * torch.sum(below * below + above * above)

    return logp


def field_priors(param_priors=None, sigma2_prior=None, z_prior=None):
    """Compose per-field priors into one ``log_prior(kernel, z, sigma2)``.

    ``param_priors`` maps kernel hyper names to log-density callables (e.g.
    ``{"log_ell": normal(0.0, 1.0)}``).
    """
    param_priors = dict(param_priors or {})

    def log_prior(kernel, z, sigma2):
        total = torch.zeros((), dtype=z.dtype, device=z.device)
        for name, logp in param_priors.items():
            total = total + logp(getattr(kernel, name))
        if sigma2_prior is not None:
            total = total + sigma2_prior(sigma2)
        if z_prior is not None:
            total = total + z_prior(z)
        return total

    return log_prior
