"""The port's softmax Laplace classifier (models/classify_multi.py, dense,
and models/classify_multi_stream.py, streaming) == gpr_tpu's, in f64 on
the CPU.

Three-class labels over ``torch_laplace.setup``'s draw go through
``gpr_tpu.models.classify_multi`` and the port at rtol 1e-10, at a mode
converged by 20 Newton steps: ``softmax_newton_scan``; the evidence and its
gradients (kernel hypers, z) under "ift" and "unroll";
``multiclass_posterior_state``; ``multiclass_predict_from_state`` (mu and
Sigma, and the probabilities on JAX's own standard normal draw);
``fit_classify_multi``'s iterates for 3 iterations.  The streaming
evidence and gradients (ragged tails at blocks 13 and 97, every ninth row
masked) equal JAX's dense ones on the live rows, which JAX's streaming
path equals to rounding; so do the streaming state and predictions.
The coupling solve's (n, k) panel equals its column-by-column apply.  The
JAX references are computed once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import classify as jc
from gpr_tpu.models import classify_multi as jm
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.models import classify as tc
from gpr_tpu_torch.models import classify_multi as tm
from gpr_tpu_torch.models import classify_multi_stream as tms
from gpr_tpu_torch.optim import make_pack
from torch_ext import close, t
from torch_laplace import (  # noqa: F401  (one_torch_thread: autouse)
    JP,
    assert_same,
    jax_value_and_grad,
    kernel,
    one_torch_thread,
    setup,
    torch_value_and_grad,
)
from torch_spmd import check_mesh_fit

D = setup()
X, Z, MASK, XS = D["X"], D["Z"], D["mask"], D["Xs"]
LIVE = MASK > 0
C = 3
LABELS = np.digitize(np.sin(2.0 * X[:, 0] - X[:, 1])
                     + 0.3 * np.random.default_rng(7).standard_normal(
                         X.shape[0]), [-0.4, 0.4])
STEPS = 20
SAMPLES = 512
J = jnp.asarray


def _lab(rows=slice(None)):
    return torch.tensor(LABELS[rows])


@pytest.fixture(scope="module")
def jref():
    """Every JAX reference of the module, computed once."""
    out = {}
    for gi in ("ift", "unroll"):
        out[gi] = jax_value_and_grad(
            lambda p, z, gi=gi: jm.multiclass_log_evidence(
                jk.SeIso, p, z, J(X), J(LABELS), C, newton_iters=STEPS,
                grad_impl=gi), Z)
    out["live"] = jax_value_and_grad(lambda p, z: jm.multiclass_log_evidence(
        jk.SeIso, p, z, J(X[LIVE]), J(LABELS[LIVE]), C, newton_iters=STEPS,
        grad_impl="unroll"), Z)
    _, v, d = jc._fitc_prior(jk.SeIso, JP, J(Z), J(X))
    y1h = jax.nn.one_hot(J(LABELS), C, dtype=v.dtype)
    out["scan"] = jm.softmax_newton_scan(v, d, y1h, J(MASK),
                                         newton_iters=STEPS)
    out["state"] = jm.multiclass_posterior_state(
        jk.SeIso, JP, J(Z), J(X), J(LABELS), C, newton_iters=STEPS)
    out["eps"] = jax.random.normal(jax.random.PRNGKey(0), (SAMPLES, C),
                                   dtype=jnp.float64)
    out["predict"] = jm.multiclass_predict_from_state(
        jk.SeIso, JP, out["state"][0].z, *out["state"][1:], J(XS),
        n_samples=SAMPLES)
    jpack = jmake_pack(jk.SeIso, JP, J(Z), 1.0, learn_sigma2=False)
    out["fit"] = jm.fit_classify_multi(jk.SeIso, J(X), J(LABELS), jpack, C,
                                       max_iter=3, newton_iters=STEPS)[-1]
    return out


@pytest.mark.parametrize("grad_impl", ["ift", "unroll"])
def test_dense_evidence_matches_jax(grad_impl, jref):
    got = torch_value_and_grad(lambda k, z: tm.multiclass_log_evidence(
        k, z, t(X), _lab(), C, newton_iters=STEPS, grad_impl=grad_impl), Z)
    assert_same(got, jref[grad_impl])


def test_newton_scan_matches_jax(jref):
    """With every ninth row masked: those rows' a stays exactly 0."""
    with torch.no_grad():
        _, v, d = tc._fitc_prior(kernel(), t(Z), t(X))
        f, a = tm.softmax_newton_scan(v, d, tm.one_hot(_lab(), C, v.dtype),
                                      t(MASK), newton_iters=STEPS)
    close(f, jref["scan"][0], name="f_hat")
    close(a, jref["scan"][1], name="a")
    assert bool((a[MASK == 0] == 0).all())


STREAM = {"ift-block13-masked": ("ift", 13, True),
          "unroll-block97-masked": ("unroll", 97, True),
          "ift-block97": ("ift", 97, False)}


@pytest.mark.parametrize("case", sorted(STREAM))
def test_stream_evidence_matches_jax(case, jref):
    """Block 13 leaves a ragged tail of 6 rows, block 97 none (one block)
    but the masked rows; against JAX's dense evidence on the live rows."""
    grad_impl, block, masked = STREAM[case]
    got = torch_value_and_grad(lambda k, z: tms.stream_multiclass_log_evidence(
        k, z, t(X), _lab(), C, block_size=block, newton_iters=STEPS,
        mask=t(MASK) if masked else None, grad_impl=grad_impl), Z)
    assert_same(got, jref["live" if masked else "ift"])


def _state_close(got, want, what):
    for name, g, w in zip(("coeffs", "a_tilde", "b_tilde"), got[1:],
                          want[1:]):
        close(g, w, name=f"{what} {name}")


def test_posterior_state_matches_jax(jref):
    with torch.no_grad():
        got = tm.multiclass_posterior_state(kernel(), t(Z), t(X), _lab(), C,
                                            newton_iters=STEPS)
    _state_close(got, jref["state"], "dense")


@pytest.mark.parametrize("block", [13, 97])
def test_stream_state_matches_jax(block, jref):
    with torch.no_grad():
        got = tms.stream_multiclass_state(kernel(), t(Z), t(X), _lab(), C,
                                          block_size=block,
                                          newton_iters=STEPS)
    _state_close(got, jref["state"], f"block {block}")


def test_predict_from_state_matches_jax(jref):
    """mu and Sigma at 1e-10; the Monte Carlo probabilities equal JAX's on
    JAX's draw, and on the port's own draw (a ``torch.Generator``) are
    probabilities."""
    k = kernel()
    with torch.no_grad():
        inducing, *state = tm.multiclass_posterior_state(
            k, t(Z), t(X), _lab(), C, newton_iters=STEPS)
        probs, mu, sigma = tm.multiclass_predict_from_state(
            k, inducing.z, *state, t(XS), n_samples=SAMPLES,
            generator=torch.Generator().manual_seed(0))
        on_jax_draw = tm.mc_softmax_probs(mu, sigma, t(jref["eps"]))
    jprobs, jmu, jsigma = jref["predict"]
    close(mu, jmu, name="mu")
    close(sigma, jsigma, name="sigma")
    close(on_jax_draw, jprobs, name="probs on JAX's draw")
    assert bool(((probs >= 0) & (probs <= 1)).all())
    close(probs.sum(dim=1), np.ones(XS.shape[0]), rtol=1e-12, name="sum")


@pytest.mark.parametrize("block", [None, 13])
def test_predict_matches_state_route(block, jref):
    """``multiclass_predict`` / ``stream_multiclass_predict``: JAX's mu and
    Sigma."""
    with torch.no_grad():
        if block is None:
            _, mu, sigma = tm.multiclass_predict(
                kernel(), t(Z), t(X), _lab(), C, t(XS), newton_iters=STEPS,
                n_samples=SAMPLES)
        else:
            _, mu, sigma = tms.stream_multiclass_predict(
                kernel(), t(Z), t(X), _lab(), C, t(XS), block_size=block,
                newton_iters=STEPS, n_samples=SAMPLES)
    close(mu, jref["predict"][1], name="mu")
    close(sigma, jref["predict"][2], name="sigma")


def test_fit_classify_multi_matches_jax(jref):
    """Dense; the streaming fit is held against JAX's through the CLI
    (``test_torch_cli_classify.py``)."""
    pack = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    _, _, st = tm.fit_classify_multi(t(X), _lab(), pack, C, max_iter=3,
                                     newton_iters=STEPS)
    jst = jref["fit"]
    close(st.x, jst.x, rtol=1e-8, name="x")
    close(st.f, jst.f, rtol=1e-8, name="f")
    assert (int(st.n_iter), int(st.n_evals)) == (int(jst.n_iter),
                                                 int(jst.n_evals))


def test_coupling_panel_equals_columns():
    """(sum_c E_c)^-1 on an (n, 5) panel == on each column."""
    with torch.no_grad():
        _, v, d = tc._fitc_prior(kernel(), t(Z), t(X))
        f = torch.tensor(np.random.default_rng(1).standard_normal(
            (X.shape[0], C)))
        _, q, qbar_inv, r_all, h_chol = tm._mode_weights(
            v, d, f, t(MASK), tm._identity)
        panel = t(np.random.default_rng(2).standard_normal((X.shape[0], 5)))
        got = tm._apply_coupling_inv(v, q, qbar_inv, r_all, h_chol, panel,
                                     tm._identity)
        want = torch.stack([tm._apply_coupling_inv(
            v, q, qbar_inv, r_all, h_chol, panel[:, j], tm._identity)
            for j in range(5)], dim=1)
    close(got, want, rtol=1e-13, name="panel")


def test_fit_classify_multi_refuses():
    with pytest.raises(ValueError, match="learn_sigma2=False"):
        tm.fit_classify_multi(t(X), _lab(), make_pack(kernel(), t(Z), 1.0),
                              C)
    # mesh= runs the data-parallel fit: P = 2 matches one device
    check_mesh_fit("multi", t(X), _lab(), t(Z), max_iter=2,
                   newton_iters=STEPS)
    for fn in (tm.multiclass_log_evidence, tms.stream_multiclass_log_evidence):
        with pytest.raises(ValueError, match="grad_impl"):
            fn(kernel(), t(Z), t(X), _lab(), C, grad_impl="stationary")
