"""Batched multi-task GPs: B independent sparse GPs in one call.  The
counterpart of ``gpr_tpu/models/multitask.py``.

Stacked tasks carry a leading axis B: a kernel module whose every hyper
field has it (``SeIso(log_ell=(B,), log_sf2=(B,))``), Z (B, m, dz), sigma2
(B,), X (B, n, d) or shared (n, d), y (B, n).  The dense engine runs all
tasks at once under ``torch.func.vmap`` (batched Cholesky and triangular
solves).  The streaming branch loops over the tasks: each task's pass takes
the default route, so SE-iso in f32 on the card runs the statistics kernels
once per task (a ctypes-bound kernel cannot run under vmap).
"""

from __future__ import annotations

import torch

from ..kernels.base import hyper_leaves, kernel_with
from .fitc import log_evidence
from .streaming import streaming_log_evidence


def _one(kernel, names, variational, factorization, block_size, jitter):
    """One task's evidence of its hyper leaves (in ``names`` order), Z,
    sigma2, X and y."""

    def f(leaves, z, sigma2, X, y):
        k = kernel_with(kernel, dict(zip(names, leaves)))
        if block_size is not None:
            return streaming_log_evidence(k, z, sigma2, X, y,
                                          variational=variational,
                                          block_size=block_size,
                                          jitter=jitter)
        return log_evidence(k, z, sigma2, X, y, variational=variational,
                            factorization=factorization, jitter=jitter)

    return f


def batched_log_evidence(kernel, z, sigma2, X, y, *, shared_inputs=None,
                         variational=False, factorization="chol",
                         block_size=None, jitter=None):
    """(B,) evidence vector.  Pass ``shared_inputs=X`` (n, d) instead of
    ``X`` when all tasks see the same inputs.  ``jitter`` (the port's
    addition; JAX's takes the configured one) applies to each Km."""
    names, leaves = hyper_leaves(kernel)
    one = _one(kernel, names, variational, factorization, block_size, jitter)
    x_dim = 0
    if shared_inputs is not None:
        X, x_dim = shared_inputs, None
    if block_size is None:
        return torch.func.vmap(one, in_dims=(0, 0, 0, x_dim, 0))(
            leaves, z, sigma2, X, y)
    return torch.stack([
        one([t[i] for t in leaves], z[i], sigma2[i],
            X if x_dim is None else X[i], y[i])
        for i in range(y.shape[0])])


def batched_value_and_grad(**kw):
    """``vg(kernel, z, sigma2, X, y) -> (neg_evidence (B,), (hyper grads,
    z grads, sigma2 grads))`` over stacked tasks (X stacked (B, n, d)); the
    hyper grads are a dict by field name of (B, ...) tensors.  The per-task
    gradients are exact and independent.  ``kw``: ``variational``,
    ``factorization``, ``block_size`` and (the port's addition) ``jitter``."""
    variational = kw.get("variational", False)
    factorization = kw.get("factorization", "chol")
    block_size = kw.get("block_size")
    jitter = kw.get("jitter")

    def vg(kernel, z, sigma2, X, y):
        names, leaves = hyper_leaves(kernel)
        leaves = tuple(t.detach() for t in leaves)
        one = _one(kernel, names, variational, factorization, block_size,
                   jitter)

        def neg(leaves, z, sigma2, X, y):
            return -one(leaves, z, sigma2, X, y)

        if block_size is None:
            grads, vals = torch.func.vmap(torch.func.grad_and_value(
                neg, argnums=(0, 1, 2)))(leaves, z, sigma2, X, y)
        else:
            vals, per_task = [], []
            for i in range(y.shape[0]):
                args = [tuple(t[i].clone().requires_grad_(True)
                              for t in leaves),
                        z[i].detach().clone().requires_grad_(True),
                        sigma2[i].detach().clone().requires_grad_(True)]
                with torch.enable_grad():
                    val = neg(*args, X[i], y[i])
                    g = torch.autograd.grad(val, [*args[0], *args[1:]])
                vals.append(val.detach())
                per_task.append(g)
            vals = torch.stack(vals)
            cols = [torch.stack(c) for c in zip(*per_task)]
            grads = (tuple(cols[:len(names)]), *cols[len(names):])
        return vals, (dict(zip(names, grads[0])), grads[1], grads[2])

    return vg


def multi_start(X, y, packs_x0, unpack, *, variational=False,
                factorization="chol", steps=100, lr=1e-3):
    """Hyperparameter multi-start: ``steps`` fixed gradient-ascent steps
    (rate ``lr``) of the S stacked packed vectors ``packs_x0`` on the same
    data, all under ``torch.func.vmap``; returns (best_x, all final
    evidences).  ``unpack(x) -> (kernel, z, sigma2)``."""

    def neg_l(x):
        kernel, z, sigma2 = unpack(x)
        return -log_evidence(kernel, z, sigma2, X, y,
                             variational=variational,
                             factorization=factorization)

    xs = torch.as_tensor(packs_x0).detach()
    step = torch.func.vmap(torch.func.grad(neg_l))
    for _ in range(steps):
        xs = xs - lr * step(xs)
    with torch.no_grad():
        ls = -torch.func.vmap(neg_l)(xs)
    return xs[torch.argmax(ls)], ls
