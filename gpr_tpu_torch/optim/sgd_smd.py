"""Gradient-ascent optimizers, SGD with a decaying rate and SMD: the
counterpart of ``gpr_tpu/optim/sgd_smd.py`` (lib/fitc_gp.ml:1724-2019).

Both *maximize* the evidence, x += eta * grad, with sigma2 carried in log
space as coordinate 0 of the packed vector.  SMD (stochastic meta-descent)
adapts a per-coordinate rate from the Hessian-vector product H.nu, which
the reference approximates by finite differences of the gradient
(fitc_gp.ml:1952-1954).  Here, as in the JAX package, it is exact: by
default a double backward, ``torch.func.vjp`` of the gradient function
(v'H = (Hv)' since H is symmetric), which needs a ``grad_fn`` that
``torch.func`` can transform (``torch.func.grad`` of a pure objective, as
``optim.train`` builds it).  The JAX package's forward-over-reverse
``jax.jvp`` has a counterpart in ``torch.func.jvp``, but PyTorch's forward
AD promotes a float32 tangent to float64 where a Python scalar multiplies
a 0-d tensor (the kernel's ``exp(-2 log_ell)``), and then fails in a
float32 product; the double backward keeps float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class SGDState:
    """fitc_gp.ml:1725-1735."""

    x: torch.Tensor
    grad: torch.Tensor
    eta: float
    tau: float
    step: int

    @property
    def gradient_norm(self) -> float:
        return float(torch.linalg.norm(self.grad))


def sgd_create(grad_fn, x0, *, tau: float = 100.0,
               eta0: float = 1e-3) -> SGDState:
    """fitc_gp.ml:1737-1772 (defaults tau=100, eta0=1e-3)."""
    if tau <= 0 or eta0 <= 0:
        raise ValueError("tau and eta0 must be positive")
    return SGDState(x=x0, grad=grad_fn(x0), eta=eta0, tau=tau, step=0)


def sgd_step(grad_fn, st: SGDState) -> SGDState:
    """Ascent step and rate decay eta <- tau/(tau+step) eta
    (fitc_gp.ml:1774-1826)."""
    x = st.x + st.eta * st.grad
    return SGDState(
        x=x,
        grad=grad_fn(x),
        eta=st.tau / (st.tau + st.step) * st.eta,
        tau=st.tau,
        step=st.step + 1,
    )


@dataclasses.dataclass(frozen=True)
class SMDState:
    """fitc_gp.ml:1836-1848."""

    x: torch.Tensor
    grad: torch.Tensor
    eta: torch.Tensor  # per-coordinate rates
    nu: torch.Tensor
    lambda_: float
    mu: float

    @property
    def gradient_norm(self) -> float:
        return float(torch.linalg.norm(self.grad))


def smd_create(grad_fn, x0, *, lambda_: float = 0.1, mu: float = 1e-3,
               eta0: torch.Tensor | float = 1e-3,
               nu0: torch.Tensor | float = 1e-3) -> SMDState:
    """fitc_gp.ml:1850-1925 (defaults lambda=0.1, mu=1e-3,
    eta0=nu0=1e-3)."""
    if not 0.0 <= lambda_ <= 1.0:
        raise ValueError("lambda must be in [0, 1]")
    if mu < 0.0:
        raise ValueError("mu must be >= 0")
    kw = {"dtype": x0.dtype, "device": x0.device}
    eta = torch.as_tensor(eta0, **kw).expand(x0.shape)
    if bool(torch.any(eta <= 0)):
        raise ValueError("eta0 must be positive")
    nu = torch.as_tensor(nu0, **kw).expand(x0.shape)
    return SMDState(x=x0, grad=grad_fn(x0), eta=eta, nu=nu, lambda_=lambda_,
                    mu=mu)


def _exact_hvp(grad_fn, x, v):
    """H v by a double backward: v'H = (Hv)', H symmetric."""
    return torch.func.vjp(grad_fn, x)[1](v)[0]


def smd_step(grad_fn, st: SMDState, *, hvp_fn=None) -> SMDState:
    """One SMD update (fitc_gp.ml:1927-2012):

        eta' = eta * max(1/2, 1 + mu * g * nu)
        x'   = x + eta' * g
        nu'  = lambda nu + eta * (g + lambda H nu)

    ``hvp_fn(x, v)`` defaults to the exact product, a double backward.
    """
    if hvp_fn is None:
        h_nu = _exact_hvp(grad_fn, st.x, st.nu)
    else:
        h_nu = hvp_fn(st.x, st.nu)
    eta = st.eta * torch.clamp(1.0 + st.mu * st.grad * st.nu, min=0.5)
    x = st.x + eta * st.grad
    nu = st.lambda_ * st.nu + st.eta * (st.grad + st.lambda_ * h_nu)
    return SMDState(x=x, grad=grad_fn(x), eta=eta, nu=nu,
                    lambda_=st.lambda_, mu=st.mu)


def run_ascent(step_fn: Callable, value_fn: Callable[[torch.Tensor], float],
               state, *, epsabs: float = 0.1, max_iter: int | None = None,
               report: Callable | None = None):
    """Best-so-far loop shared by SGD and SMD (fitc_gp.ml:1696-1722):
    iterate until |grad| < epsabs or max_iter, returning the state whose
    evidence was highest."""
    if max_iter is not None and max_iter < 0:
        raise ValueError("max_iter < 0")
    n = max_iter if max_iter is not None else -1
    best, best_le = state, value_fn(state.x)
    t = state
    while n != 0 and t.gradient_norm >= epsabs:
        t = step_fn(t)
        le = value_fn(t.x)
        if le > best_le:
            best_le, best = le, t
            if report is not None:
                report(t)
        n -= 1
    return best
