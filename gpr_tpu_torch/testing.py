"""Derivative self-test harness: the rebuild of ``Sigs.Deriv.Test``.  The
counterpart of ``gpr_tpu/testing.py``.

The reference ships finite-difference validators as part of the library
(``check_deriv_hyper`` and ``self_test``, lib/fitc_gp.ml:1212-1462, spec
lib/interfaces.ml:987-1026).  Here the analytic side is PyTorch's automatic
differentiation (``torch.func.jvp`` for the kernel matrices, autograd for
the evidence), so these checks validate (a) each kernel family's
derivatives and (b) the full evidence gradient, through the jittered
Cholesky and both factorizations.  A kernel module stands for the JAX
package's ``(family, params)``.

Central differences in f64 give ~1e-9 accuracy; the defaults are tighter
than the reference's (eps=1e-8, tol=1e-2 at fitc_gp.ml:1223,1398).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.fitc import log_evidence
from .optim.pack import make_pack


class DerivMismatch(AssertionError):
    """Raised with the offending quantity, mirroring the reference's loud
    per-element failure reports."""


def _fd_dir(f, x, v, eps):
    plus, minus = f(x + eps * v), f(x - eps * v)
    if isinstance(plus, tuple):
        return tuple((a - b) / (2.0 * eps) for a, b in zip(plus, minus))
    return (plus - minus) / (2.0 * eps)


def _unit(x0, i):
    v = torch.zeros_like(x0)
    v[i] = 1.0
    return v


def check_deriv_hyper(kernel, z, X, *, eps: float = 1e-6,
                      tol: float = 1e-6) -> int:
    """Check d(Km)/dh, d(Knm)/dh, d(kn_diag)/dh along every optimizable
    hyper direction: ``torch.func.jvp`` against central finite
    differences.

    Returns the number of directions checked.  Raises
    :class:`DerivMismatch` naming the worst element on failure.
    """
    pack = make_pack(kernel, z, 1.0, learn_sigma2=False)
    x0 = pack.x0.detach()

    def mats(x):
        k, zz, _ = pack.unpack(x)
        return k.k_upper(zz), k.k_cross(X, zz), k.k_diag(X)

    names = ("dKm", "dKnm", "dkn_diag")
    n = int(x0.shape[0])
    with torch.no_grad():
        for i in range(n):
            v = _unit(x0, i)
            analytic = torch.func.jvp(mats, (x0,), (v,))[1]
            fd = _fd_dir(mats, x0, v, eps)
            for name, a, f in zip(names, analytic, fd):
                a, f = a.cpu().numpy(), f.cpu().numpy()
                rel = np.abs(a - f) / np.maximum(1.0, np.abs(f))
                if rel.max() > tol:
                    idx = np.unravel_index(rel.argmax(), rel.shape)
                    raise DerivMismatch(
                        f"{kernel.name}: {name} mismatch for hyper "
                        f"coordinate {i} at element {idx}: analytic "
                        f"{a[idx]:.10g} vs FD {f[idx]:.10g} (tol {tol})"
                    )
    return n


def self_test(kernel, z, X, y, sigma2, *, variational: bool = False,
              factorization: str | None = None, eps: float = 1e-6,
              tol: float = 1e-5) -> int:
    """Check the full evidence gradient (log sigma2, every kernel hyper,
    every inducing coordinate) against central finite differences: the
    analogue of Test.self_test looping `Sigma2 and each `Hyper
    (fitc_gp.ml:1398-1462).  Returns the number of coordinates checked."""
    pack = make_pack(kernel, z, sigma2, learn_sigma2=True)
    x0 = pack.x0.detach()

    def f(x):
        k, zz, s2 = pack.unpack(x)
        return log_evidence(k, zz, s2, X, y, variational=variational,
                            factorization=factorization)

    x = x0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    g = g.cpu().numpy()
    n = int(x0.shape[0])
    with torch.no_grad():
        for i in range(n):
            fd = float(_fd_dir(f, x0, _unit(x0, i), eps))
            err = abs(g[i] - fd) / max(1.0, abs(fd))
            if err > tol:
                which = ("log_sigma2" if (pack.learn_sigma2 and i == 0)
                         else f"hyper {i}")
                raise DerivMismatch(
                    f"{kernel.name}: evidence gradient mismatch for {which}: "
                    f"analytic {g[i]:.10g} vs FD {fd:.10g} (rel err "
                    f"{err:.2e}, tol {tol})"
                )
    return n
