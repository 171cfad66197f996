"""The "fat" squared-exponential kernel as an ``nn.Module``.

The counterpart of ``gpr_tpu/kernels/se_fat.py`` (the reference's
lib/cov_se_fat.ml).  Three options, each of which may be off (None):

* ``tproj`` (D, d): inputs X (n, D) are projected to (n, d) before any
  distance is taken (supervised dimensionality reduction);
* ``log_hetero_skedasticity`` (m,): per-inducing-point noise added to the
  diagonal of K(Z, Z) only;
* ``log_multiscales_m05`` (m, d): per-inducing-point, per-dimension scales
  u = exp(.) + 0.5 > 0.5.

With p the projection of x and z_c an inducing point (which lives in the
projected space):

    k(p, z_c)   = sf2 exp(-1/2 sum_i [(p_i - z_ci)^2 / u_ci + log u_ci])
    k(z_r, z_c) = sf2 exp(-1/2 sum_i [(z_ri - z_ci)^2 / s_i + log s_i]),
                  s = u_r + u_c - 1, plus the hetero noise on the diagonal
    k_diag(X)   = sf2 (the multiscales leave input variances alone)

and ``k_upper_inputs`` / ``k_cross_inputs`` are the plain SE on the
projections (the reference ignores multiscales and hetero noise there).

The module holds ``d`` (static) and the hyper fields; :meth:`SeFat.of`
builds a view whose hypers are given tensors (the optimizer's unpacked
vector), so that autograd reaches them.  ``param_names`` lists the hyper
fields in the sorted order of the JAX ``Params`` keys, the order of a packed
vector and of the streaming VJP's accumulators.
"""

from __future__ import annotations

import torch
from torch import nn

from ..numerics.linalg import matmul
from .base import set_hypers, sqdist, view_of

_OPTIONS = ("tproj", "log_hetero_skedasticity", "log_multiscales_m05")


class SeFat(nn.Module):
    name = "se_fat"
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    param_names = ("log_hetero_skedasticity", "log_multiscales_m05",
                   "log_sf2", "tproj")
    #: the JAX ``Params`` declaration order (``base.declared_names``)
    declared_names = ("log_sf2", "tproj", "log_hetero_skedasticity",
                      "log_multiscales_m05")
    static_names = ("d",)
    #: the hyper fields that may be None (option off)
    optional_names = _OPTIONS
    learn_inducing_default = True

    def __init__(self, d: int, log_sf2=0.0, tproj=None,
                 log_hetero_skedasticity=None, log_multiscales_m05=None, *,
                 device="cuda", dtype=None):
        """On the card unless ``device`` says otherwise (``"cpu"`` for CPU
        work): with no GPU the default raises rather than falling back.
        ``None`` turns an option off."""
        super().__init__()
        self.d = int(d)
        set_hypers(self, device, dtype, log_sf2=log_sf2, tproj=tproj,
                   log_hetero_skedasticity=log_hetero_skedasticity,
                   log_multiscales_m05=log_multiscales_m05)

    @classmethod
    def of(cls, d: int, log_sf2: torch.Tensor, tproj=None,
           log_hetero_skedasticity=None, log_multiscales_m05=None) -> "SeFat":
        """A kernel whose hypers ARE the given tensors (plain attributes,
        not fresh parameters), so gradients flow back to whatever they were
        computed from."""
        return view_of(cls, d=int(d), log_sf2=log_sf2, tproj=tproj,
                       log_hetero_skedasticity=log_hetero_skedasticity,
                       log_multiscales_m05=log_multiscales_m05)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "SeFat":
        """Random defaults after lib/cov_se_fat.ml:191-213, all options on:
        tproj row r is U(-1, 1) scaled by (n / D) / sum(X[:, r]); log_sf2 ~
        U(-1, 1); hetero noise exp(-5); u = 1.5.  The draws come from
        ``generator`` (default ``torch.Generator(X.device).manual_seed(0)``),
        tproj's first, so they are not the JAX package's."""
        if generator is None:
            generator = torch.Generator(X.device).manual_seed(0)
        n, big_dim = X.shape
        d = min(big_dim, 10)
        kw = {"dtype": X.dtype, "device": X.device}
        mean_factor = (n / big_dim) / torch.sum(X, dim=0)
        u_proj = torch.rand((big_dim, d), generator=generator, **kw)
        u_sf2 = torch.rand((), generator=generator, **kw)
        return cls(
            d, 2.0 * u_sf2 - 1.0,
            tproj=mean_factor[:, None] * (2.0 * u_proj - 1.0),
            log_hetero_skedasticity=torch.full((n_inducing,), -5.0, **kw),
            log_multiscales_m05=torch.zeros((n_inducing, d), **kw),
            device=X.device, dtype=X.dtype,
        )

    def project(self, X: torch.Tensor) -> torch.Tensor:
        """(n, D) -> (n, d); the identity when tproj is off."""
        return X if self.tproj is None else matmul(X, self.tproj)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        """Inducing points live in the projected space."""
        return self.project(X)

    def _multiscales(self) -> torch.Tensor:
        return torch.exp(self.log_multiscales_m05) + 0.5

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        """(m, m) K(Z, Z): off the multiscales, exactly sf2 on the diagonal;
        with them, the scale u_r + u_c - 1 per pair; plus the hetero noise
        on the diagonal."""
        m = z.shape[0]
        if self.log_multiscales_m05 is None:
            k = torch.exp(self.log_sf2 - 0.5 * sqdist(z, z))
            eye = torch.eye(m, dtype=torch.bool, device=z.device)
            k = torch.where(eye, torch.exp(self.log_sf2), k)
        else:
            u = self._multiscales()
            scale = u[:, None, :] + u[None, :, :] - 1.0
            diff = z[:, None, :] - z[None, :, :]
            quad = torch.sum(torch.square(diff) / scale + torch.log(scale),
                             dim=-1)
            k = torch.exp(self.log_sf2 - 0.5 * quad)
        if self.log_hetero_skedasticity is not None:
            k = k + torch.diag(torch.exp(self.log_hetero_skedasticity))
        return k

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) prior variances, all sf2."""
        return torch.exp(self.log_sf2).expand(X.shape[0])

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """(n, m) cross-covariance K(X, Z)."""
        return self._cross_from_projections(self.project(X), z)

    def _cross_from_projections(self, p, z):
        if self.log_multiscales_m05 is None:
            return torch.exp(self.log_sf2 - 0.5 * sqdist(p, z))
        # the multiscale cross as ONE augmented product:
        #   quad[n, c] = sum_i (p_ni - z_ci)^2 / u_ci + sum_i log u_ci
        #             = [p^2 | p | 1] [iu | -2 z iu | sum(z^2 iu + log u)]'
        u = self._multiscales()
        iu = 1.0 / u
        ones = torch.ones((p.shape[0], 1), dtype=p.dtype, device=p.device)
        aug = torch.cat([torch.square(p), p, ones], dim=1)
        w = torch.cat([
            iu, -2.0 * (z * iu),
            torch.sum(torch.square(z) * iu + torch.log(u), dim=-1)[:, None],
        ], dim=1)
        return torch.exp(self.log_sf2 - 0.5 * matmul(aug, w.T))

    def k_cross_vjp(self, X, z, knm, knm_bar, kd_bar):
        """Hand-fused pullback of (k_cross, k_diag) given the computed
        ``knm`` tile: the cotangents of the fields that are not None, in
        ``param_names`` order, then z_bar.

        With quad[n, c] = sum_i (p_ni - z_ci)^2 iu_ci + sum_i log u_ci (iu =
        1/u; u = 1 with the multiscales off) and qbar = -1/2 knm_bar knm,
        every cotangent reduces through two small products:

          qbar'[P | P^2 | 1]  -> B1 = qbar'P, B2 = qbar'P^2, cs (col sums)
          qbar [iu | Z iu]    -> the projection's row-side pullback

          z_bar       = -2 iu (B1 - Z cs)
          P_bar       = 2 (P (qbar iu) - qbar (Z iu));  tproj_bar = X' P_bar
          u_bar       = iu cs - iu^2 (B2 - 2 Z B1 + Z^2 cs);
                        log_ms_bar = u_bar (u - 1/2)
          log_sf2_bar = sum(knm_bar knm) + sf2 sum(kd_bar)

        The hetero noise enters ``k_upper`` only: its cotangent here is
        zero (not None), and autograd adds the ``k_upper`` path to it.
        """
        sf2 = torch.exp(self.log_sf2)
        qbar = -0.5 * (knm_bar * knm)
        p = self.project(X)
        d = z.shape[1]
        u = (None if self.log_multiscales_m05 is None
             else self._multiscales())
        iu = torch.ones_like(z) if u is None else 1.0 / u
        ones = torch.ones((p.shape[0], 1), dtype=p.dtype, device=p.device)
        g = matmul(qbar.T, torch.cat([p, torch.square(p), ones], dim=1))
        b1, b2, cs = g[:, :d], g[:, d:2 * d], g[:, 2 * d]
        bars = {
            "log_hetero_skedasticity": (
                None if self.log_hetero_skedasticity is None
                else torch.zeros_like(self.log_hetero_skedasticity)),
            "log_sf2": -2.0 * torch.sum(cs) + sf2 * torch.sum(kd_bar),
            "log_multiscales_m05": None,
            "tproj": None,
        }
        z_bar = -2.0 * iu * (b1 - z * cs[:, None])
        if self.tproj is not None:
            a2 = matmul(qbar, torch.cat([iu, z * iu], dim=1))  # (bs, 2d)
            p_rows_bar = 2.0 * (p * a2[:, :d] - a2[:, d:])
            bars["tproj"] = matmul(X.T, p_rows_bar)
        if u is not None:
            sq = b2 - 2.0 * z * b1 + torch.square(z) * cs[:, None]
            u_bar = iu * cs[:, None] - torch.square(iu) * sq
            bars["log_multiscales_m05"] = u_bar * (u - 0.5)
        return (*(bars[name] for name in self.param_names
                  if getattr(self, name) is not None), z_bar)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        """(n, n) K(X, X): the plain SE on the projections, exactly sf2 on
        the diagonal (multiscales and hetero noise left out, as
        lib/cov_se_fat.ml:221 does)."""
        p = self.project(X)
        k = torch.exp(self.log_sf2 - 0.5 * sqdist(p, p))
        eye = torch.eye(p.shape[0], dtype=torch.bool, device=p.device)
        return torch.where(eye, torch.exp(self.log_sf2), k)

    def k_cross_inputs(self, X1: torch.Tensor,
                       X2: torch.Tensor) -> torch.Tensor:
        """Data-side cross block, consistent with ``k_upper_inputs``."""
        return torch.exp(self.log_sf2 - 0.5 * sqdist(self.project(X1),
                                                     self.project(X2)))

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        """Prior variance at one input: sf2."""
        return torch.exp(self.log_sf2)
