"""The port's distributed block Cholesky and solves
(``gpr_tpu_torch/parallel/dist_chol.py``) == dense algebra, on gloo CPU
ranks in f64.

One spawned world of four ranks (``torch_spmd.dist_chol_ranks``) runs
every function over the model axis of a 2x2 mesh (p = 2, each model pair
alike) and a 1x4 mesh (p = 4) on a 16 x 16 SPD matrix.  The column blocks,
gathered, are held at rtol 1e-10 against dense torch and the JAX
package's ``numerics.linalg``: the Cholesky factor, its log det, the
forward solve of a vector and of each member's own columns, the back
solve, the inverse, the ring transpose and the two-sided whitening
(distributed and with a replicated factor).  The gradient of log det(A) +
|R^-T u|^2 + sum(R^-T G R^-1 * C) over the leaves that make A, u and G
equals torch's dense one (the gradient rule over the whole mesh: not 2, 4
or 8 times), as the JAX package's slow-marked ``test_dist_chol.py`` holds
its functions against dense algebra.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.numerics import linalg as jla
from gpr_tpu_torch.parallel import run_spmd
from torch_ext import close
from torch_laplace import one_torch_thread  # noqa: F401 (autouse)
import torch_spmd as ts

D = ts.dist_chol_draws()
P_OF = {2: (2, 2), 4: (1, 4)}


@pytest.fixture(scope="module")
def ranks():
    """Every function's gathered outputs at p = 2 and 4, from one world."""
    return run_spmd(ts.dist_chol_ranks, 4, D, platform="cpu")


@pytest.fixture(scope="module")
def dense():
    """The dense references."""
    A = ts.t(D["A"])
    R = torch.linalg.cholesky(A, upper=True)
    G = ts.t(D["G"])
    return {"A": A, "R": R, "G": G,
            "jax_R": np.asarray(jla.cholesky_upper(jnp.asarray(D["A"]),
                                                   jitter=0.0))}


def solve_t(R, b):
    return torch.linalg.solve_triangular(R.T, b, upper=False)


@pytest.mark.parametrize("p", sorted(P_OF))
def test_cholesky_and_log_det(ranks, dense, p):
    got = ranks[P_OF[p]]
    close(got["chol"], dense["R"], 1e-10, "R vs torch")
    close(got["chol"], dense["jax_R"], 1e-10, "R vs JAX")
    close(got["log_det"], torch.logdet(dense["A"]), 1e-10, "log det")


@pytest.mark.parametrize("p", sorted(P_OF))
def test_forward_solves(ranks, dense, p):
    got = ranks[P_OF[p]]
    u = ts.t(D["u"])
    close(got["lower_t"], solve_t(dense["R"], u[:, None])[:, 0], 1e-10,
          "R' t = u")
    close(got["lower_t"], np.asarray(jla.solve_tri(
        jnp.asarray(dense["jax_R"]), jnp.asarray(D["u"]), trans=True)),
        1e-10, "vs JAX's solve_tri")
    # each member solved its own columns of B
    close(got["lower_cols"], solve_t(dense["R"], ts.t(D["B"])), 1e-10,
          "R' Y = B")


@pytest.mark.parametrize("p", sorted(P_OF))
def test_back_solve_and_inverse(ranks, dense, p):
    got = ranks[P_OF[p]]
    close(got["upper_cols"], torch.linalg.solve_triangular(
        dense["R"], ts.t(D["B"]), upper=True), 1e-10, "R X = B")
    close(got["inverse"], torch.linalg.inv(dense["A"]), 1e-10, "A^-1")


@pytest.mark.parametrize("p", sorted(P_OF))
def test_transpose_and_whitening(ranks, dense, p):
    got = ranks[P_OF[p]]
    close(got["transpose"], ts.t(D["W"]).T, 0.0, "ring transpose")
    R = dense["R"]
    white = solve_t(R, solve_t(R, dense["G"]).T)
    close(got["whiten"], white, 1e-10, "R^-T G R^-1")
    close(got["whiten_replicated"], white, 1e-10, "replicated factor")


@pytest.mark.parametrize("p", sorted(P_OF))
def test_gradient(ranks, p):
    leaves = [ts.t(D[name]).requires_grad_(True) for name in ("L", "u", "H")]
    every = slice(None)
    val = ts.dist_chol_value(
        D, *leaves, lambda a: torch.linalg.cholesky(a, upper=True),
        lambda r: 2.0 * torch.sum(torch.log(torch.diagonal(r))),
        lambda r, u: solve_t(r, u[:, None])[:, 0],
        lambda r, g, c: torch.sum(solve_t(r, solve_t(r, g).T) * c), every)
    want = torch.autograd.grad(val, leaves)
    got_val, got = ranks[P_OF[p]]["grad"]
    close(got_val, val, 1e-10, "value")
    for name, g, w in zip(("L", "u", "H"), got, want):
        close(g, w, 1e-10, name)
