"""Isotropic squared-exponential kernel as an ``nn.Module``.

k(x, y) = sf2 * exp(-||x - y||^2 / (2 ell^2)),  sf2 = exp(log_sf2).

The counterpart of ``gpr_tpu/kernels/se_iso.py``.  Where the JAX family is a
class of static methods over a params pytree, here the module holds
``log_ell`` and ``log_sf2`` as parameters; :meth:`SeIso.of` builds a view
whose hypers are given tensors (the optimizer's unpacked vector), so that
autograd reaches them.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import set_hypers, sqdist, sqdist_cotangent_reduce, view_of


class SeIso(nn.Module):
    name = "se_iso"
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("log_ell", "log_sf2")
    static_names = ()
    optional_names = ()
    learn_inducing_default = True

    def __init__(self, log_ell: float = 0.0, log_sf2: float = 0.0, *,
                 device="cuda", dtype=None):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work): with no GPU the default raises rather than falling back."""
        super().__init__()
        set_hypers(self, device, dtype, log_ell=log_ell, log_sf2=log_sf2)

    @classmethod
    def of(cls, log_ell: torch.Tensor, log_sf2: torch.Tensor) -> "SeIso":
        """A kernel whose hypers ARE ``log_ell`` and ``log_sf2`` (plain
        tensor attributes, not fresh parameters), so gradients flow back to
        whatever they were computed from."""
        return view_of(cls, log_ell=log_ell, log_sf2=log_sf2)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "SeIso":
        """The reference's defaults, log_ell = log_sf2 = 0
        (lib/cov_se_iso.ml:122-123), on X's device and dtype.  The SE-iso
        defaults draw nothing: ``n_inducing`` and ``generator`` are the
        family interface's."""
        return cls(0.0, 0.0, device=X.device, dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        """Inducing points live in input space (lib/cov_se_iso.ml:120)."""
        return X

    def _k_of_d2(self, d2: torch.Tensor) -> torch.Tensor:
        inv_ell2_05 = -0.5 * torch.exp(-2.0 * self.log_ell)
        return torch.exp(self.log_sf2 + inv_ell2_05 * d2)

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        """(m, m) K(Z, Z), with exactly sf2 on the diagonal: the sqdist
        expansion can leave tiny nonzeros there."""
        k = self._k_of_d2(sqdist(z, z))
        eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
        return torch.where(eye, torch.exp(self.log_sf2), k)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) prior variances, all sf2."""
        return torch.exp(self.log_sf2).expand(X.shape[0])

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """(n, m) cross-covariance K(X, Z)."""
        return self._k_of_d2(sqdist(X, z))

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        """(n, n) K(X, X): the inputs' own covariance, as ``k_upper``."""
        return self.k_upper(X)

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        """Prior variance at one input: sf2."""
        return torch.exp(self.log_sf2)

    def k_cross_vjp(self, X, z, knm, knm_bar, kd_bar):
        """Hand-fused pullback of (k_cross, k_diag) given the computed
        ``knm`` tile: (log_ell_bar, log_sf2_bar, z_bar), plain tensors.

        With a = ell^-2, q = -a/2, knm = exp(log_sf2 + q d2) and
        c = knm_bar * knm:

            log_sf2_bar = sum(c) + sf2 sum(kd_bar)
            log_ell_bar = a sum(c . d2)
            z_bar       = 2q (colsum(c)[:, None] * Z - c'X)
        """
        a = torch.exp(-2.0 * self.log_ell)
        sf2 = torch.exp(self.log_sf2)
        c = knm_bar * knm
        z_core, c_dot_d2, c_sum = sqdist_cotangent_reduce(c, X, z)
        # d2_bar = q c with scalar q = -a/2, so q factors out of z_core
        return (a * c_dot_d2, c_sum + sf2 * torch.sum(kd_bar),
                -0.5 * a * z_core)
