"""Coregionalization ("task") kernel for multi-output GPs (ICM).

k(t, t') = B[t, t'],   B = W W' + diag(exp(log_kappa))   (T x T, PSD)

over one input column holding task indices 0..T-1.  The counterpart of
``gpr_tpu/kernels/task.py``.  Multi-output models stack every task's rows
into one dataset ``[features..., task_id]`` and compose this family with a
data kernel over the feature columns (``kernels.icm_family``):

    prod(cols(task(T,R),d,d+1),cols(se_iso,0,d))

which is the intrinsic coregionalization model B[t,t'] k_data(x, x').

* The (n, m) cross block is two products against one-hot task selectors
  (K = O1 B O2'), as in the JAX package: no gather, so no scatter-add in
  the backward.
* Task ids are ``round`` then ``clip`` of the column (``torch.round``
  rounds half to even, as ``jnp.round`` does) and integer from there on,
  so the task column of the shared inducing set gets an exactly zero
  gradient: inducing points keep the task they started with.
* B is PSD for any real W; the rank R dials expressiveness (R = T is a
  full PSD B).

``task_family(T, R)`` interns one subclass of :class:`Task` per (T, R),
so ``type(kernel)`` is the family, as for every other family.
"""

from __future__ import annotations

import torch
from torch import nn

from ..numerics.linalg import matmul
from .base import set_hypers, view_of


class Task(nn.Module):
    """Body of every ``task(T, R)`` family (see ``task_family``)."""

    name: str
    n_tasks: int
    rank: int
    #: hyper fields in the order of the JAX ``Params`` pytree's sorted keys
    #: (which is also their declaration order)
    param_names = ("W", "log_kappa")
    static_names = ()
    optional_names = ()
    #: integer task ids have no useful gradient
    learn_inducing_default = False

    def __init__(self, W, log_kappa, *, device="cuda", dtype=None):
        """``W`` (T, R) coregionalization factors, ``log_kappa`` (T,) log
        per-task independent variances.  On the card unless ``device`` says
        otherwise (``"cpu"`` for CPU work)."""
        super().__init__()
        set_hypers(self, device, dtype, W=W, log_kappa=log_kappa)

    @classmethod
    def of(cls, W: torch.Tensor, log_kappa: torch.Tensor) -> "Task":
        """A kernel whose hypers ARE ``W`` and ``log_kappa``."""
        return view_of(cls, W=W, log_kappa=log_kappa)

    @classmethod
    def default_params(cls, X: torch.Tensor, n_inducing: int,
                       generator: torch.Generator | None = None) -> "Task":
        """W = 0.3 N(0, 1) drawn from ``generator``, or without one the
        deterministic 0.3 cos(arange(T R) + 0.7), bit-equal to the JAX
        package's keyless init (W = 0 is a stationary point); log_kappa =
        -1.  On X's device and dtype."""
        kw = {"dtype": X.dtype, "device": X.device}
        T, R = cls.n_tasks, cls.rank
        if generator is None:
            W = 0.3 * torch.cos(torch.arange(T * R, **kw).reshape(T, R)
                                + 0.7)
        else:
            W = 0.3 * torch.randn((T, R), generator=generator, **kw)
        return cls(W, torch.full((T,), -1.0, **kw), device=X.device,
                   dtype=X.dtype)

    def inducing_from_inputs(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _ids(self, x: torch.Tensor) -> torch.Tensor:
        ids = torch.clamp(torch.round(x[..., 0]), 0, self.n_tasks - 1)
        return ids.to(torch.int64)

    def _one_hot(self, t, dtype):
        return torch.nn.functional.one_hot(t, self.n_tasks).to(dtype)

    def _cross_ids(self, t1, t2):
        """K = O1 B O2' with one-hot task selectors: two products."""
        B = self.coregionalization()
        return matmul(matmul(self._one_hot(t1, B.dtype), B),
                      self._one_hot(t2, B.dtype).T)

    def k_cross(self, X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self._cross_ids(self._ids(X), self._ids(z))

    def k_upper(self, z: torch.Tensor) -> torch.Tensor:
        t = self._ids(z)
        return self._cross_ids(t, t)

    def k_upper_inputs(self, X: torch.Tensor) -> torch.Tensor:
        t = self._ids(X)
        return self._cross_ids(t, t)

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        """diag(B) at each row's task, by a one-hot product."""
        diag_b = (torch.sum(torch.square(self.W), dim=-1)
                  + torch.exp(self.log_kappa))
        o = self._one_hot(self._ids(X), diag_b.dtype)
        return matmul(o, diag_b[:, None])[:, 0]

    def k_one(self, x: torch.Tensor) -> torch.Tensor:
        t = self._ids(x[None, :])[0]
        w = self.W[t]
        return torch.dot(w, w) + torch.exp(self.log_kappa)[t]

    def k_upper_cols(self, z: torch.Tensor, j0: int, m_t: int):
        """Columns [j0, j0 + m_t) of ``k_upper``: no diagonal correction, so
        the cross block against those rows."""
        return self.k_cross(z, z[j0:j0 + m_t])

    def coregionalization(self) -> torch.Tensor:
        """The learned (T, T) task covariance B = W W' + diag(kappa)."""
        return matmul(self.W, self.W.T) + torch.diag(torch.exp(
            self.log_kappa))


_INTERNED: dict = {}


def task_family(n_tasks: int, rank: int):
    """The coregionalization family over ``n_tasks`` outputs with a
    rank-``rank`` shared component (W of shape (n_tasks, rank)), interned
    so that equal (T, R) give the same class."""
    key = (int(n_tasks), int(rank))
    cls = _INTERNED.get(key)
    if cls is None:
        if key[0] < 1 or key[1] < 1:
            raise ValueError("task_family needs n_tasks >= 1 and rank >= 1")
        name = f"task({key[0]},{key[1]})"
        cls = _INTERNED[key] = type(name, (Task,), {
            "__doc__": f"The ``{name}`` coregionalization family.",
            "name": name, "n_tasks": key[0], "rank": key[1],
        })
    return cls
