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


def declared_names(cls) -> tuple[str, ...]:
    """A family's hyper fields in the declaration order of the JAX
    ``Params`` dataclass: the order of its leaves inside a combinator's
    packed vector, where JAX's ravel flattens each term's dataclass field
    by field.  It differs from the sorted ``param_names`` for rq, periodic
    and se_fat, which say so in ``declared_names``."""
    return getattr(cls, "declared_names", cls.param_names)


def field_of(kernel, path: str):
    """The field ``path`` of ``kernel``: a plain name, or a dotted one
    (``terms.0.log_ell``) that walks a combinator's terms."""
    value = kernel
    for part in path.split("."):
        value = value[int(part)] if part.isdigit() else getattr(value, part)
    return value


def hyper_fields(kernel) -> dict:
    """The kernel's hyper fields by name in ``param_names`` order, a tensor
    each or None where an option is off: for a base family the sorted order
    of the JAX ``Params`` keys, for a combinator the dotted names of its
    terms' fields in the order of JAX's ravel (``combinators``)."""
    return {name: field_of(kernel, name) for name in type(kernel).param_names}


def static_fields(kernel) -> dict:
    """The kernel's static (non-tensor) fields by name, e.g. se_fat's ``d``
    (``terms.0.d`` for an se_fat term)."""
    return {name: field_of(kernel, name)
            for name in type(kernel).static_names}


def hyper_leaves(kernel) -> tuple[tuple[str, ...], tuple[torch.Tensor, ...]]:
    """(names, tensors) of the fields that are not None, in ``param_names``
    order: the positional layout of the streaming VJP's hyper arguments and
    accumulators, and of a packed vector's kernel slice."""
    items = [(n, t) for n, t in hyper_fields(kernel).items() if t is not None]
    return tuple(n for n, _ in items), tuple(t for _, t in items)


def kernel_with(kernel, values: dict):
    """A view of ``kernel`` (``type(kernel).of``) whose hyper fields named in
    ``values`` are those tensors; the other fields and the static ones stay
    as they are."""
    fields = {**hyper_fields(kernel), **values}
    return type(kernel).of(**static_fields(kernel), **fields)


def cross_inputs(kernel, X1, X2) -> torch.Tensor:
    """Data-side cross-covariance block K(X1, X2) among inputs: the
    family's ``k_cross_inputs`` where it has one (se_fat, the combinators),
    else ``k_cross`` against ``inducing_from_inputs(X2)``."""
    hook = getattr(kernel, "k_cross_inputs", None)
    if hook is not None:
        return hook(X1, X2)
    return kernel.k_cross(X1, kernel.inducing_from_inputs(X2))


def k_upper_cols(kernel, z, j0: int, m_t: int) -> torch.Tensor:
    """Columns [j0, j0 + m_t) of ``kernel.k_upper(z)`` without forming the
    (m, m) Gram (the JAX package's ``k_upper_cols``): the combinators and
    the task family compose their own, the base families go by name."""
    own = getattr(kernel, "k_upper_cols", None)
    if own is not None:
        return own(z, j0, m_t)
    z_c = z[j0:j0 + m_t]
    on_diag = (torch.arange(z.shape[0], device=z.device)[:, None]
               == j0 + torch.arange(m_t, device=z.device)[None, :])
    name = kernel.name
    if name == "const":
        return kernel.k_cross(z[:, :0], z_c)
    if name == "lin_ard":
        # k_upper is the plain Gram of the pre-scaled inducing points
        return matmul(z, z_c.T)
    if name in ("lin_one", "cosine"):
        return kernel.k_cross(z, z_c)
    if name in ("se_iso", "se_ard", "matern32", "matern52", "rq",
                "periodic"):
        return torch.where(on_diag, torch.exp(kernel.log_sf2),
                           kernel.k_cross(z, z_c))
    if name == "se_fat":
        log_sf2 = kernel.log_sf2
        if kernel.log_multiscales_m05 is None:
            k = torch.exp(log_sf2 - 0.5 * sqdist(z, z_c))
            k = torch.where(on_diag, torch.exp(log_sf2), k)
        else:
            u = torch.exp(kernel.log_multiscales_m05) + 0.5
            scale = u[:, None, :] + u[j0:j0 + m_t][None, :, :] - 1.0
            diff = z[:, None, :] - z_c[None, :, :]
            quad = torch.sum(torch.square(diff) / scale + torch.log(scale),
                             dim=-1)
            k = torch.exp(log_sf2 - 0.5 * quad)
        if kernel.log_hetero_skedasticity is not None:
            het_c = torch.exp(kernel.log_hetero_skedasticity)[j0:j0 + m_t]
            k = k + torch.where(on_diag, het_c[None, :],
                                torch.zeros_like(k))
        return k
    raise NotImplementedError(f"k_upper_cols for family {name!r}")


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
