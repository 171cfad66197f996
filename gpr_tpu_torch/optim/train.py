"""Evidence-maximization objectives: the counterpart of
``gpr_tpu/optim/train.py``.

:func:`make_objective` is the one packed objective the host L-BFGS
(``optim/lbfgs.py``) and the f64 polish (``optim/polish.py``) drive: the
negative log evidence, dense or streaming, over the packed hyper vector.
``train`` (the callback-rich host loop with resume) is not ported yet.
"""

from __future__ import annotations

import torch

from ..models.fitc import calc_model, calc_trained
from ..models.streaming import streaming_log_evidence, streaming_trained


def default_sigma2(targets) -> float:
    """sigma2 default = uncentered target variance."""
    y = torch.as_tensor(targets).detach().to(torch.float64)
    return float(torch.dot(y, y) / y.shape[0])


def default_n_inducing(n_inputs: int) -> int:
    """min(n/10, 1000)."""
    return max(1, min(n_inputs // 10, 1000))


def make_objective(X, targets, pack, *, variational=False,
                   factorization=None, normalize=False, block_size=None,
                   log_prior=None, value_only=False):
    """(value, grad) of the NEGATIVE evidence over the packed vector, plus a
    trained-state reconstruction for reporting: ``(fg, trained_of)`` with
    ``fg(x) -> (f, g)`` tensors on the data's device (f detached).

    The JAX ``make_objective(family, ...)`` minus ``family``: the pack's
    kernel class is it.  ``normalize=True`` optimizes the mean NLL (-l/n).
    ``block_size`` switches to the streaming evidence
    (``models/streaming.py``), which never materializes Knm; without it the
    dense engine (``models/fitc.py``) runs.  ``log_prior(kernel, z, sigma2)
    -> scalar`` makes it MAP estimation.  ``value_only=True`` makes the
    first return ``f(x) -> value`` with no backward pass.  (The JAX
    ``return_raw``, for embedding in a jitted graph, has no use here.)
    """
    scale = 1.0 / X.shape[0] if normalize else 1.0

    def dense_trained(kernel, z, sigma2):
        model = calc_model(kernel, X, z, sigma2, variational=variational,
                           factorization=factorization)
        return calc_trained(model, targets)

    def neg_l(x):
        kernel, z, sigma2 = pack.unpack(x)
        if block_size is not None:
            l = streaming_log_evidence(kernel, z, sigma2, X, targets,
                                       variational=variational,
                                       block_size=block_size)
        else:
            l = dense_trained(kernel, z, sigma2).l
        if log_prior is not None:
            l = l + log_prior(kernel, z, sigma2)
        return -l * scale

    def neg_l_and_grad(x):
        if value_only:
            with torch.no_grad():
                return neg_l(x)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = neg_l(x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    @torch.no_grad()
    def trained_of(x):
        kernel, z, sigma2 = pack.unpack(x)
        if block_size is not None:
            return streaming_trained(kernel, z, sigma2, X, targets,
                                     variational=variational,
                                     block_size=block_size)
        return dense_trained(kernel, z, sigma2)

    return neg_l_and_grad, trained_of

