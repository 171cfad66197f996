"""The port's ordinal regression (models/ordinal.py) and
``optim.pack.extend_pack`` == gpr_tpu's, in f64 on the CPU.

The cutpoint maps; the cumulative-probit hooks elementwise, boundary
categories and far tails included, and their f32 gradients NaN-free where
a dead branch would otherwise meet an infinity; the evidence and its
gradients (kernel hypers, z, cut_raw) at rtol 1e-10, dense and streaming
at block 32 under both ``grad_impl`` routes; the predictions;
``extend_pack``'s vector layout; ``fit_ordinal``'s iterates for 3
iterations.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import ordinal as jo
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu.optim.pack import extend_pack as jextend_pack
from gpr_tpu_torch.models import ordinal as to
from gpr_tpu_torch.optim import extend_pack, make_pack
from torch_ext import close, t
from torch_laplace import (
    JP,
    assert_same,
    jax_value_and_grad,
    kernel,
    setup,
    torch_value_and_grad,
)

D = setup()
X, Z = D["X"], D["Z"]
Y = D["ordinal"]
J = jnp.asarray
STEPS = 12
CUT_RAW = np.array([-1.0, -0.3, 0.2])


def _yi(pkg):
    return (jnp.asarray(Y, jnp.int32) if pkg == "jax"
            else torch.as_tensor(Y, dtype=torch.int64))


@pytest.mark.parametrize("n_classes", [2, 3, 5])
def test_cutpoint_maps_match_jax(n_classes):
    raw = to.default_cutpoint_raw(n_classes)
    close(raw, jo.default_cutpoint_raw(n_classes), name="raw")
    close(to.cutpoints_from_raw(raw), jo.cutpoints_from_raw(J(raw.numpy())),
          name="cuts")


def test_hooks_match_jax_in_the_tails():
    """dl/df, W and log p per row for every category at latents from
    -12 to 12 (the log-space cell's far tails)."""
    f = np.linspace(-12.0, 12.0, 41)
    cuts = np.array([-1.0, 0.0, 1.5])
    for k in range(4):
        y = np.full(f.shape, k)
        jg, jw = jo._ord_parts(J(f), J(y, jnp.int32), J(cuts), 1.0)
        g, w = to._ord_parts(t(f), torch.as_tensor(y), t(cuts), 1.0)
        close(g, jg, name=f"grad k={k}")
        close(w, jw, name=f"W k={k}")
        close(to._ord_loglik(t(f), torch.as_tensor(y), t(cuts)),
              jo._ord_loglik(J(f), J(y, jnp.int32), J(cuts)),
              rtol=1e-9, name=f"log p k={k}")


def test_f32_gradient_is_nan_free():
    """f32 rows with z0 == z1 == 0 in the dead both-bounds branch, and rows
    far in either tail: the gradient of the summed log likelihood in f and
    the cutpoints is finite."""
    f = torch.tensor([0.0, 0.0, 0.0, 40.0, -40.0, 1e-12],
                     requires_grad=True)
    y = torch.tensor([0, 3, 1, 0, 3, 2])
    raw = torch.tensor([-1.0, 0.0, 0.0], requires_grad=True)
    torch.sum(to._ord_loglik(f, y, to.cutpoints_from_raw(raw))).backward()
    assert bool(torch.isfinite(f.grad).all())
    assert bool(torch.isfinite(raw.grad).all())


@functools.lru_cache(maxsize=None)
def _jax_dense(grad_impl):
    return jax_value_and_grad(lambda p, z, c: jo.ordinal_log_evidence(
        jk.SeIso, p, z, J(X), _yi("jax"), c, newton_iters=STEPS,
        grad_impl=grad_impl), Z, CUT_RAW)


@pytest.mark.parametrize("block,grad_impl", [(None, "ift"), (None, "unroll"),
                                             (32, "ift"), (32, "unroll")])
def test_evidence_matches_jax(block, grad_impl):
    """Dense against JAX's dense evidence by the same route; streaming at
    block 32 (a ragged tail, the cutpoints passed through unblocked) by
    either route against JAX's dense ift evidence, which its streaming
    core equals to rounding."""
    got = torch_value_and_grad(lambda k, z, c: to.ordinal_log_evidence(
        k, z, t(X), _yi("torch"), c, newton_iters=STEPS, block_size=block,
        grad_impl=grad_impl), Z, CUT_RAW)
    assert_same(got, _jax_dense(grad_impl if block is None else "ift"))


def test_predict_matches_jax():
    want = jo.ordinal_predict(jk.SeIso, JP, J(Z), J(X), _yi("jax"),
                              J(CUT_RAW), J(D["Xs"]), newton_iters=STEPS)
    got = to.ordinal_predict(kernel(), t(Z), t(X), _yi("torch"), t(CUT_RAW),
                             t(D["Xs"]), newton_iters=STEPS)
    for name, g, w in zip(("probs", "mu", "var"), got, want):
        close(g, w, name=name)
    close(got[0].sum(1), np.ones(len(D["Xs"])), name="rows sum to 1")


@pytest.mark.parametrize("learn_sigma2", [False, True])
def test_extend_pack_layout_matches_jax(learn_sigma2):
    """[base coords | extra leaves]: the same vector, the same base unpack
    and the same (2, 3) extra back."""
    jpack = jmake_pack(jk.SeIso, JP, J(Z), 0.7, learn_sigma2=learn_sigma2)
    pack = make_pack(kernel(), t(Z), 0.7, learn_sigma2=learn_sigma2)
    extra = np.arange(6.0).reshape(2, 3) - 2.5
    jext = jextend_pack(jpack, J(extra))
    ext = extend_pack(pack, t(extra))
    close(ext.x0, jext.x0, rtol=0, name="x0")
    assert (ext.n_hypers, ext.n_extra, ext.learn_sigma2) == (
        jext.n_hypers, jext.n_extra, jext.learn_sigma2)
    x = ext.x0 * 1.5 - 0.25
    jx = J(x.numpy())
    close(ext.unpack_extra(x), jext.unpack_extra(jx), rtol=0, name="extra")
    assert ext.unpack_extra(x).shape == (2, 3)
    k, z, s2 = ext.unpack(x)
    jp_, jz, js2 = jext.unpack(jx)
    close(z, jz, rtol=0, name="z")
    close(s2, js2, rtol=1e-15, name="sigma2")  # exp: one ulp apart
    close(k.log_ell, jp_.log_ell, rtol=0, name="log_ell")


def test_fit_ordinal_matches_jax():
    jpack = jmake_pack(jk.SeIso, JP, J(Z), 1.0, learn_sigma2=False)
    *_, jcut, jst = jo.fit_ordinal(jk.SeIso, J(X), _yi("jax"), jpack,
                                   J(CUT_RAW), max_iter=3,
                                   newton_iters=STEPS)
    pack = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    *_, cut, st = to.fit_ordinal(t(X), _yi("torch"), pack, t(CUT_RAW),
                                 max_iter=3, newton_iters=STEPS)
    close(st.x, jst.x, rtol=1e-8, name="x")
    close(cut, jcut, rtol=1e-8, name="cut_raw")
    assert (int(st.n_iter), int(st.n_evals)) == (int(jst.n_iter),
                                                 int(jst.n_evals))


def test_fit_ordinal_refuses():
    pack = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    with pytest.raises(ValueError, match="learn_sigma2=False"):
        to.fit_ordinal(t(X), _yi("torch"), make_pack(kernel(), t(Z), 1.0),
                       t(CUT_RAW))
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        to.fit_ordinal(t(X), _yi("torch"), pack, t(CUT_RAW), mesh=object())
    with pytest.raises(ValueError, match="n_classes >= 2"):
        to.default_cutpoint_raw(1)
