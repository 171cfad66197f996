"""Hyperparameter packing: a kernel module, z and sigma2 <-> one flat
optimization vector.  The counterpart of ``gpr_tpu/optim/pack.py``.

The vector layout is the JAX package's, so a packed vector means the same
thing in both: coordinate 0 is log(sigma2) when ``learn_sigma2``, then the
selected kernel hypers in the kernel class's ``param_names`` order, then
the inducing coordinates row-major when ``learn_inducing``.  That order is
JAX's ravel: sorted field names for a base family (``ravel_pytree`` sorts
dict keys: for SE-iso ``log_ell``, ``log_sf2``; for se_fat
``log_hetero_skedasticity``, ``log_multiscales_m05``, ``log_sf2``,
``tproj``), and for a combinator its terms in order, each term's fields in
their ``Params`` declaration order (``kernels/combinators.py``).  Static
fields (se_fat's ``d``) and options that are off (None) are not in the
vector.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from ..kernels.base import hyper_fields, kernel_with
from ..tracing import span


@dataclasses.dataclass(frozen=True)
class HyperPack:
    x0: torch.Tensor
    #: x -> (kernel, z, sigma2), each a differentiable function of x
    unpack: Callable[[torch.Tensor], tuple[Any, torch.Tensor, torch.Tensor]]
    n_hypers: int
    learn_sigma2: bool
    learn_inducing: bool = True
    fixed: tuple = ()


@dataclasses.dataclass(frozen=True)
class ExtendedPack:
    """A base pack plus extra (likelihood) parameters appended to the
    optimization vector, e.g. ordinal cutpoints, which are neither kernel
    hypers nor sigma2.  ``unpack`` sees only the base coordinates, so the
    extended pack drops into every base-pack code path; ``unpack_extra``
    recovers the appended tensor."""

    x0: torch.Tensor
    unpack: Callable[[torch.Tensor], tuple[Any, torch.Tensor, torch.Tensor]]
    n_hypers: int
    learn_sigma2: bool
    base: HyperPack
    n_extra: int
    unpack_extra: Callable[[torch.Tensor], torch.Tensor]


def extend_pack(pack: HyperPack, extra0: torch.Tensor) -> ExtendedPack:
    """Append the tensor ``extra0`` (flattened row-major) after the base
    pack's coordinates.  Layout: [base coords | extra leaves], as the JAX
    package's ``ravel_pytree``."""
    n_base = int(pack.x0.shape[0])
    x0 = torch.cat([pack.x0, extra0.detach().reshape(-1).to(
        dtype=pack.x0.dtype, device=pack.x0.device)])
    return ExtendedPack(
        x0=x0, unpack=lambda x: pack.unpack(x[:n_base]),
        n_hypers=int(x0.shape[0]), learn_sigma2=pack.learn_sigma2,
        base=pack, n_extra=extra0.numel(),
        unpack_extra=lambda x: x[n_base:].reshape(extra0.shape),
    )


def make_pack(kernel, z0, sigma2_0, *, learn_sigma2: bool = True,
              learn_inducing: bool | None = None,
              fixed: Sequence[str] = ()) -> HyperPack:
    """Build the pack for (kernel's hypers, z0, sigma2_0).

    ``learn_inducing`` defaults per kernel class; ``fixed`` names top-level
    hyper fields to hold at the kernel's values, as in the JAX package: for
    a combinator that is ``terms``, all of its hypers.  ``unpack(x)`` returns a kernel
    view (``type(kernel).of``) whose hypers are slices of ``x``, so
    autograd reaches ``x`` through every field; ``d`` and the fields that
    are None stay as they were.
    """
    cls = type(kernel)
    if learn_inducing is None:
        learn_inducing = cls.learn_inducing_default
    fixed = set(fixed)
    top = {name: name.split(".", 1)[0] for name in cls.param_names}
    unknown = fixed - set(top.values())
    if unknown:
        raise ValueError(f"unknown hyper fields {sorted(unknown)}; "
                         f"{cls.name} has {sorted(set(top.values()))}")
    values0 = {name: t.detach() for name, t in hyper_fields(kernel).items()
               if t is not None}
    free = [name for name in values0 if top[name] not in fixed]
    pieces = [values0[name].reshape(-1) for name in free]
    if learn_inducing:
        pieces.append(z0.detach().reshape(-1))
    dtype = pieces[0].dtype if pieces else torch.as_tensor(sigma2_0).dtype
    device = z0.device
    vec = (torch.cat([p.to(dtype) for p in pieces]) if pieces
           else torch.zeros(0, dtype=dtype, device=device))
    sigma2_0 = torch.as_tensor(sigma2_0, dtype=dtype, device=device)
    x0 = torch.cat([torch.log(sigma2_0)[None], vec]) if learn_sigma2 else vec

    def unpack(x):
        with span("gpr.optim.unpack"):
            if learn_sigma2:
                sigma2, rest = torch.exp(x[0]), x[1:]
            else:
                sigma2, rest = sigma2_0, x
            values = dict(values0)
            at = 0
            for name in free:
                k = values0[name].numel()
                values[name] = rest[at:at + k].reshape(values0[name].shape)
                at += k
            z = rest[at:].reshape(z0.shape) if learn_inducing else z0
            return kernel_with(kernel, values), z, sigma2

    return HyperPack(
        x0=x0, unpack=unpack, n_hypers=int(x0.shape[0]),
        learn_sigma2=learn_sigma2, learn_inducing=bool(learn_inducing),
        fixed=tuple(sorted(fixed)),
    )
