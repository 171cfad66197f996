"""The port's binary Laplace classifier (models/classify.py, dense, and
models/classify_stream.py, streaming) == gpr_tpu's, in f64 on the CPU.

The same numpy draw goes through ``gpr_tpu.models.classify`` /
``classify_stream`` and the port: the evidence and its gradients (kernel
hypers, z) at rtol 1e-10 for both ``grad_impl`` routes, dense and
streaming (a ragged tail and masked rows at block 32, block 50 without a
mask); the mode; the predictions, dense and streaming; ``fit_classify``'s
iterates for 3 iterations.  The streaming evidence equals the dense one at
any block.  ``fit_classify`` refuses a pack with sigma2 and ``mesh=``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import gpr_tpu.kernels as jk
from gpr_tpu.models import classify as jc
from gpr_tpu.models import classify_stream as jcs
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.models import classify as tc
from gpr_tpu_torch.models import classify_stream as tcs
from gpr_tpu_torch.optim import make_pack
from torch_ext import close, t
from torch_laplace import (
    JP,
    assert_same,
    jax_value_and_grad,
    kernel,
    setup,
    torch_value_and_grad,
)
from torch_spmd import check_mesh_fit

D = setup()
X, Z, Y = D["X"], D["Z"], D["classify"]
J = jnp.asarray
STEPS = 12


@pytest.mark.parametrize("grad_impl", ["ift", "unroll"])
def test_dense_evidence_matches_jax(grad_impl):
    want = jax_value_and_grad(lambda p, z: jc.classify_log_evidence(
        jk.SeIso, p, z, J(X), J(Y), newton_iters=STEPS,
        grad_impl=grad_impl), Z)
    got = torch_value_and_grad(lambda k, z: tc.classify_log_evidence(
        k, z, t(X), t(Y), newton_iters=STEPS, grad_impl=grad_impl), Z)
    assert_same(got, want)


STREAM = {"ift-block32-masked": ("ift", 32, True),
          "unroll-block50": ("unroll", 50, False)}


@pytest.mark.parametrize("case", sorted(STREAM))
def test_stream_evidence_matches_jax(case):
    """Block 32 leaves a ragged tail of 1 row and masks every ninth row;
    block 50 a tail of 47."""
    grad_impl, block, masked = STREAM[case]
    mask = D["mask"] if masked else None
    want = jax_value_and_grad(lambda p, z: jcs.stream_classify_log_evidence(
        jk.SeIso, p, z, J(X), J(Y), block_size=block, newton_iters=STEPS,
        mask=None if mask is None else J(mask), grad_impl=grad_impl), Z)
    got = torch_value_and_grad(lambda k, z: tcs.stream_classify_log_evidence(
        k, z, t(X), t(Y), block_size=block, newton_iters=STEPS,
        mask=None if mask is None else t(mask), grad_impl=grad_impl), Z)
    assert_same(got, want)


@pytest.mark.parametrize("block", [16, 97])
def test_stream_equals_dense(block):
    """The streaming evidence and gradients equal the dense ones to
    rounding at any block partition (the port alone)."""
    dense = torch_value_and_grad(lambda k, z: tc.classify_log_evidence(
        k, z, t(X), t(Y), newton_iters=STEPS), Z)
    stream = torch_value_and_grad(lambda k, z: tc.classify_log_evidence(
        k, z, t(X), t(Y), newton_iters=STEPS, block_size=block), Z)
    assert_same(stream, [float(dense[0].detach()), dense[1]])


def test_mode_matches_jax():
    jf, ja, _, jv, jd = jc.laplace_mode(jk.SeIso, JP, J(Z), J(X), J(Y),
                                        newton_iters=STEPS)
    f, a, _, v, d = tc.laplace_mode(kernel(), t(Z), t(X), t(Y),
                                    newton_iters=STEPS)
    for name, got, want in (("f_hat", f, jf), ("a", a, ja), ("v", v, jv),
                            ("d", d, jd)):
        close(got, want, name=name)


@pytest.mark.parametrize("block", [None, 32])
def test_predict_matches_jax(block):
    want = jc.classify_predict(jk.SeIso, JP, J(Z), J(X), J(Y), J(D["Xs"]),
                               newton_iters=STEPS, block_size=block)
    got = tc.classify_predict(kernel(), t(Z), t(X), t(Y), t(D["Xs"]),
                              newton_iters=STEPS, block_size=block)
    for name, g, w in zip(("prob", "mu", "var"), got, want):
        close(g, w, name=name)
    assert bool(((got[0] > 0) & (got[0] < 1)).all())


def test_fit_classify_matches_jax():
    jpack = jmake_pack(jk.SeIso, JP, J(Z), 1.0, learn_sigma2=False)
    *_, jst = jc.fit_classify(jk.SeIso, J(X), J(Y), jpack, max_iter=3,
                              newton_iters=STEPS)
    pack = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    k, z, st = tc.fit_classify(t(X), t(Y), pack, max_iter=3,
                               newton_iters=STEPS)
    close(st.x, jst.x, rtol=1e-8, name="x")
    close(st.f, jst.f, rtol=1e-8, name="f")
    assert (int(st.n_iter), int(st.n_evals)) == (int(jst.n_iter),
                                                 int(jst.n_evals))
    close(z, jst.x[2:].reshape(Z.shape), rtol=1e-8, name="z")


def test_fit_classify_refuses():
    with pytest.raises(ValueError, match="learn_sigma2=False"):
        tc.fit_classify(t(X), t(Y), make_pack(kernel(), t(Z), 1.0))
    # mesh= runs the data-parallel fit: P = 2 matches one device
    check_mesh_fit("classify", t(X), t(Y), t(Z), max_iter=2)
    with pytest.raises(ValueError, match="grad_impl"):
        tc.classify_log_evidence(kernel(), t(Z), t(X), t(Y),
                                 grad_impl="bogus")
