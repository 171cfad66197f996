"""Pairwise squared distances and their cotangent, the field helpers every
family shares, and the public helpers of the kernel protocol: the
counterpart of ``gpr_tpu/kernels/base.py``."""

from __future__ import annotations

import torch
from torch import nn

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


def set_hypers(module: nn.Module, device, dtype, **values) -> None:
    """Give ``module`` each of ``values`` as an ``nn.Parameter`` on
    ``device`` in ``dtype`` (None stays None: an option that is off)."""
    kw = {"device": device, "dtype": dtype}
    for name, value in values.items():
        setattr(module, name, None if value is None else nn.Parameter(
            torch.as_tensor(value, **kw).clone()))


def view_of(cls, **fields):
    """An instance of ``cls`` whose fields ARE the given values (plain
    attributes, not fresh parameters), so gradients flow back to whatever
    they were computed from: the body of every family's ``of``."""
    self = cls.__new__(cls)
    nn.Module.__init__(self)
    for name, value in fields.items():
        setattr(self, name, value)
    return self


def hyper_fields(kernel) -> dict:
    """The kernel's hyper fields by name, in the sorted order of the JAX
    ``Params`` keys: a tensor each, or None where an option is off."""
    return {name: getattr(kernel, name) for name in type(kernel).param_names}


def static_fields(kernel) -> dict:
    """The kernel's static (non-tensor) fields by name, e.g. se_fat's ``d``."""
    return {name: getattr(kernel, name) for name in type(kernel).static_names}


def hyper_leaves(kernel) -> tuple[tuple[str, ...], tuple[torch.Tensor, ...]]:
    """(names, tensors) of the fields that are not None, in sorted order:
    the positional layout of the streaming VJP's hyper arguments and
    accumulators, and of a packed vector's kernel slice."""
    items = [(n, t) for n, t in hyper_fields(kernel).items() if t is not None]
    return tuple(n for n, _ in items), tuple(t for _, t in items)


def kernel_with(kernel, values: dict):
    """A view of ``kernel`` (``type(kernel).of``) whose hyper fields named in
    ``values`` are those tensors; the other fields and the static ones stay
    as they are."""
    fields = {**hyper_fields(kernel), **values}
    return type(kernel).of(**static_fields(kernel), **fields)


def sqdist_cotangent_reduce(c: torch.Tensor, X: torch.Tensor,
                            Z: torch.Tensor):
    """(z_bar, c_dot_d2, c_sum) for a (bs, m) cotangent ``c`` of
    ``sqdist(X, Z)``.

    Every reduction rides one (m, bs) x (bs, d + 2) product against the
    augmented [X | 1 | xx] (xx the row square norms): columns :d give c'X,
    column d the column sums, column d + 1 c'xx.  Then

        z_bar    = 2 (colsum(c)[:, None] * Z - c'X)
        c_dot_d2 = sum(c . d2) = sum(c'xx) + colsum(c).zz - 2 sum((c'X) . Z)
    """
    xx = torch.sum(X * X, dim=1)
    aug = torch.cat([X, torch.ones_like(xx)[:, None], xx[:, None]], dim=1)
    caug = matmul(c.T, aug)  # (m, d + 2)
    d = X.shape[1]
    cX, cs, cxx = caug[:, :d], caug[:, d], caug[:, d + 1]
    zz = torch.sum(Z * Z, dim=1)
    c_dot_d2 = torch.sum(cxx) + torch.dot(cs, zz) - 2.0 * torch.sum(cX * Z)
    z_bar = 2.0 * (cs[:, None] * Z - cX)
    return z_bar, c_dot_d2, torch.sum(cs)


def weighted_eval(kernel, X, Z, coeffs) -> torch.Tensor:
    """K(X, Z) @ coeffs: the reference's ``Inputs.weighted_eval``
    (lib/interfaces.ml:193-198)."""
    return matmul(kernel.k_cross(X, Z), coeffs)


def weighted_eval_one(kernel, x, Z, coeffs) -> torch.Tensor:
    """k(x, Z) . coeffs for one input x: the reference's
    ``Input.weighted_eval`` (lib/interfaces.ml:131-137)."""
    return torch.dot(kernel.k_cross(x[None, :], Z)[0], coeffs)


def choose_subset(X, indexes) -> torch.Tensor:
    """The rows ``indexes`` of X: the reference's ``Inputs.choose_subset``
    (lib/utils.ml:60-75; column-major there, row-major here)."""
    return X[torch.as_tensor(indexes, device=X.device)]
