"""The port's count likelihoods (models/poisson.py, binomial.py, negbin.py)
== gpr_tpu's, in f64 on the CPU.

The same numpy draw of counts goes through the JAX modules and the port:
each family's evidence and its gradients (kernel hypers, z, the NB2
dispersion r; the Poisson with a log exposure) at rtol 1e-10, dense and
streaming at block 32 (a ragged tail) under both ``grad_impl`` routes, the
generic streaming core with masked rows; the predictions; each ``fit_*``'s
iterates for 3 iterations (``fit_negbin`` carries r in the pack's sigma2
slot).  The fits refuse a pack of the wrong kind.
"""

import functools

import jax.numpy as jnp
import pytest

import gpr_tpu.kernels as jk
from gpr_tpu.models import binomial as jb
from gpr_tpu.models import classify_stream as jcs
from gpr_tpu.models import negbin as jn
from gpr_tpu.models import poisson as jp
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.models import binomial as tb
from gpr_tpu_torch.models import classify_stream as tcs
from gpr_tpu_torch.models import negbin as tn
from gpr_tpu_torch.models import poisson as tp
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

D = setup()
X, Z = D["X"], D["Z"]
J = jnp.asarray
STEPS = 12
R0 = 1.7


def _evidence(family, pkg, block, grad_impl):
    """(fn(params or kernel, z(, r)), the extra leaf or None) of a family's
    evidence in ``pkg`` ("jax" or "torch")."""
    a = J if pkg == "jax" else t
    kw = dict(newton_iters=STEPS, block_size=block)
    if pkg == "torch" or block is None:
        kw["grad_impl"] = grad_impl
    fam = (jk.SeIso,) if pkg == "jax" else ()
    mod = {"jax": {"poisson": jp, "binomial": jb, "negbin": jn},
           "torch": {"poisson": tp, "binomial": tb, "negbin": tn}}[pkg]
    if family == "poisson":
        return (lambda p, z: mod["poisson"].poisson_log_evidence(
            *fam, p, z, a(X), a(D["poisson"]),
            log_exposure=a(D["exposure"]), **kw)), None
    if family == "binomial":
        return (lambda p, z: mod["binomial"].binomial_log_evidence(
            *fam, p, z, a(X), a(D["binomial"]), a(D["trials"]), **kw)), None
    return (lambda p, z, r: mod["negbin"].negbin_log_evidence(
        *fam, p, z, a(X), a(D["negbin"]), r, **kw)), R0


@functools.lru_cache(maxsize=None)
def _jax_dense(family, grad_impl):
    jfn, extra = _evidence(family, "jax", None, grad_impl)
    return jax_value_and_grad(jfn, Z, extra)


CASES = [(f, b, g) for f in ("poisson", "binomial", "negbin")
         for b, g in ((None, "ift"), (None, "unroll"), (32, "ift"),
                      (32, "unroll"))]


@pytest.mark.parametrize("family,block,grad_impl", CASES)
def test_evidence_matches_jax(family, block, grad_impl):
    """Dense: against JAX's dense evidence by the same route.  Streaming at
    block 32 (a ragged tail of 1 row), both routes: against JAX's dense
    ift evidence, which its streaming core equals to rounding (as
    ``test_stream_core_masked_matches_jax`` holds the port's streaming
    core against JAX's own)."""
    want = _jax_dense(family, grad_impl if block is None else "ift")
    tfn, extra = _evidence(family, "torch", block, grad_impl)
    assert_same(torch_value_and_grad(tfn, Z, extra), want)


@pytest.mark.parametrize("grad_impl", ["ift", "unroll"])
def test_stream_core_masked_matches_jax(grad_impl):
    """The generic streaming core with NB2's dispersion passed through and
    every ninth row masked, at block 40."""
    def fn(mod, parts, loglik, a, fam):
        return lambda p, z, r: mod.stream_laplace_log_evidence(
            *fam, p, z, a(X), (a(D["negbin"]), r, a(D["exposure"])),
            parts=parts, loglik=loglik, lik_is_row=(True, False, True),
            block_size=40, newton_iters=STEPS, mask=a(D["mask"]),
            grad_impl=grad_impl)

    want = jax_value_and_grad(fn(jcs, jn.nb_parts, jn.nb_loglik, J,
                                 (jk.SeIso,)), Z, R0)
    got = torch_value_and_grad(fn(tcs, tn.nb_parts, tn.nb_loglik, t, ()),
                               Z, R0)
    assert_same(got, want)


@pytest.mark.parametrize("family", ["poisson", "binomial", "negbin"])
def test_predict_matches_jax(family):
    Xs = D["Xs"]
    if family == "poisson":
        want = jp.poisson_predict(jk.SeIso, JP, J(Z), J(X), J(D["poisson"]),
                                  J(Xs), log_exposure=J(D["exposure"]),
                                  newton_iters=STEPS)
        got = tp.poisson_predict(kernel(), t(Z), t(X), t(D["poisson"]),
                                 t(Xs), log_exposure=t(D["exposure"]),
                                 newton_iters=STEPS)
    elif family == "binomial":
        want = jb.binomial_predict(jk.SeIso, JP, J(Z), J(X),
                                   J(D["binomial"]), J(D["trials"]), J(Xs),
                                   newton_iters=STEPS)
        got = tb.binomial_predict(kernel(), t(Z), t(X), t(D["binomial"]),
                                  t(D["trials"]), t(Xs), newton_iters=STEPS)
    else:
        want = jn.negbin_predict(jk.SeIso, JP, J(Z), J(X), J(D["negbin"]),
                                 R0, J(Xs), newton_iters=STEPS)
        got = tn.negbin_predict(kernel(), t(Z), t(X), t(D["negbin"]), R0,
                                t(Xs), newton_iters=STEPS)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, name=f"output {i}")


@pytest.mark.parametrize("family", ["poisson", "binomial", "negbin"])
def test_fit_matches_jax(family):
    negbin = family == "negbin"
    s2 = R0 if negbin else 1.0
    jpack = jmake_pack(jk.SeIso, JP, J(Z), s2, learn_sigma2=negbin)
    pack = make_pack(kernel(), t(Z), s2, learn_sigma2=negbin)
    kw = dict(max_iter=3, newton_iters=STEPS)
    if family == "poisson":
        jst = jp.fit_poisson(jk.SeIso, J(X), J(D["poisson"]), jpack, **kw)[-1]
        st = tp.fit_poisson(t(X), t(D["poisson"]), pack, **kw)[-1]
    elif family == "binomial":
        jst = jb.fit_binomial(jk.SeIso, J(X), J(D["binomial"]),
                              J(D["trials"]), jpack, **kw)[-1]
        st = tb.fit_binomial(t(X), t(D["binomial"]), t(D["trials"]), pack,
                             **kw)[-1]
    else:
        *_, jr, jst = jn.fit_negbin(jk.SeIso, J(X), J(D["negbin"]), jpack,
                                    **kw)
        *_, r, st = tn.fit_negbin(t(X), t(D["negbin"]), pack, **kw)
        close(r, jr, rtol=1e-8, name="r")
    close(st.x, jst.x, rtol=1e-8, name="x")
    assert (int(st.n_iter), int(st.n_evals)) == (int(jst.n_iter),
                                                 int(jst.n_evals))


def test_fits_refuse_the_wrong_pack():
    with_s2 = make_pack(kernel(), t(Z), 1.0)
    without = make_pack(kernel(), t(Z), 1.0, learn_sigma2=False)
    with pytest.raises(ValueError, match="learn_sigma2=False"):
        tp.fit_poisson(t(X), t(D["poisson"]), with_s2)
    with pytest.raises(ValueError, match="learn_sigma2=False"):
        tb.fit_binomial(t(X), t(D["binomial"]), t(D["trials"]), with_s2)
    with pytest.raises(ValueError, match="sigma2 slot"):
        tn.fit_negbin(t(X), t(D["negbin"]), without)
