"""The port's Laplace core (models/ift.py) == gpr_tpu's, in f64 on the CPU.

The FITC K-apply and the Woodbury B^-1; the generic Newton scan with a
likelihood's hooks and masked rows; the implicit-gradient fixed point's
VJP into V, d and a floating likelihood leaf (NB2's dispersion) against
JAX's custom_vjp; the generic evidence with masked rows under both
``grad_impl`` routes.  In the port alone: the two routes agree within
JAX's tests/test_ift.py bound for every family, their values equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.models import classify as jc
from gpr_tpu.models import ift as jift
from gpr_tpu.models import negbin as jn
from gpr_tpu.models import poisson as jp
from gpr_tpu_torch.models import binomial as tb
from gpr_tpu_torch.models import classify as tc
from gpr_tpu_torch.models import ift as tift
from gpr_tpu_torch.models import negbin as tn
from gpr_tpu_torch.models import ordinal as to
from gpr_tpu_torch.models import poisson as tp
from torch_ext import close, t
from torch_laplace import kernel, setup, torch_value_and_grad

D = setup(n=83, m=6)
J = jnp.asarray
STEPS = 10


def _prior(seed=1):
    """V (n, m) and d (n,) of the SE-iso FITC prior over the draw's rows
    (numpy), a vector and masked weights drawn from ``seed``."""
    with torch.no_grad():
        _, v, d = tc._fitc_prior(kernel(), t(D["Z"]), t(D["X"]))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(v.shape[0])
    w = rng.uniform(0.0, 2.0, v.shape[0]) * D["mask"]
    return v.numpy(), d.numpy(), x, w


def test_kdot_and_binv_match_jax():
    v, d, x, w = _prior()
    close(tift.fitc_kdot(t(v), t(d), t(x)), jift.fitc_kdot(J(v), J(d), J(x)))
    jbinv, jsw, jrm = jift.make_binv(J(v), J(d), J(w), J(D["mask"]))
    binv, sw, rm = tift.make_binv(t(v), t(d), t(w), t(D["mask"]))
    close(sw, jsw, name="sw")
    close(rm, jrm, name="rm")
    close(binv(t(x)), jbinv(J(x)), name="binv")


HOOKS = {
    "logit": (jc.logit_parts, tc.logit_parts, ("classify",)),
    "poisson": (jp.pois_parts, tp.pois_parts, ("poisson", "exposure")),
}


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_newton_scan_matches_jax(hook):
    """The generic scan with every ninth row masked: (f_hat, a), the masked
    rows' exactly 0."""
    v, d, _, _ = _prior()
    jparts, tparts, keys = HOOKS[hook]
    jf, ja = jift.newton_scan_generic(
        jparts, J(v), J(d), tuple(J(D[k]) for k in keys), J(D["mask"]),
        newton_iters=STEPS)
    f, a = tift.newton_scan_generic(
        tparts, t(v), t(d), tuple(t(D[k]) for k in keys), t(D["mask"]),
        newton_iters=STEPS)
    close(f, jf, name="f_hat")
    close(a, ja, name="a")
    assert not bool(torch.any(a[t(D["mask"]) == 0]))


@pytest.mark.parametrize("hook", ["logit", "negbin"])
def test_fixed_point_vjp_matches_jax(hook):
    """a(V, d, lik) and its VJP under one cotangent: V, d and, for NB2, the
    dispersion r (a floating leaf); the labels (an integer-free tuple here)
    get the same treatment in both."""
    v, d, x, _ = _prior(2)
    mask = np.ones(v.shape[0])
    steps = 20  # converged: the step's bisections see the same signs
    if hook == "logit":
        jparts, tparts, lik = jc.logit_parts, tc.logit_parts, (D["classify"],)
        diff = ()
    else:
        jparts, tparts = jn.nb_parts, tn.nb_parts
        lik = (D["negbin"], np.asarray(1.3), D["exposure"])
        diff = (1,)

    def jfp(v, d, *leaves):
        full = tuple(leaves[diff.index(i)] if i in diff else J(l)
                     for i, l in enumerate(lik))
        return jift.laplace_fixed_point(jparts, jift._identity, steps, v, d,
                                        full, J(mask))

    ja, pull = jax.vjp(jfp, J(v), J(d), *(J(lik[i]) for i in diff))
    jbars = pull(J(x))
    leaves = [t(v).requires_grad_(True), t(d).requires_grad_(True)]
    tl = [t(l).requires_grad_(i in diff) for i, l in enumerate(lik)]
    a = tift.LaplaceFixedPoint.apply(tparts, tift._identity, steps,
                                     *leaves, t(mask), *tl)
    close(a, ja, name="a")
    bars = torch.autograd.grad(a, [*leaves, *(tl[i] for i in diff)],
                               grad_outputs=t(x))
    for name, g, w in zip(("v", "d", "r"), bars, jbars):
        close(g, w, name=name)


@pytest.mark.parametrize("grad_impl", ["ift", "unroll"])
def test_evidence_core_masked_matches_jax(grad_impl):
    """The generic evidence over V, d with masked rows: value and the V, d
    gradients (the Poisson hooks with an exposure)."""
    v, d, _, _ = _prior(3)
    lik = (D["poisson"], D["exposure"])

    def jf(v, d):
        return jift.laplace_evidence_core(
            jp.pois_parts, jp.pois_loglik, v, d, tuple(J(l) for l in lik),
            J(D["mask"]), newton_iters=STEPS, grad_impl=grad_impl)

    jval, (jgv, jgd) = jax.value_and_grad(jf, argnums=(0, 1))(J(v), J(d))
    tv, td = t(v).requires_grad_(True), t(d).requires_grad_(True)
    val = tift.laplace_evidence_core(
        tp.pois_parts, tp.pois_loglik, tv, td, tuple(t(l) for l in lik),
        t(D["mask"]), newton_iters=STEPS, grad_impl=grad_impl)
    gv, gd = torch.autograd.grad(val, (tv, td))
    close(val, jval, name="value")
    close(gv, jgv, name="V")
    close(gd, jgd, name="d")


FAMILIES = {
    "classify": lambda k, z, e, gi: tc.classify_log_evidence(
        k, z, t(D["X"]), t(D["classify"]), grad_impl=gi),
    "poisson": lambda k, z, e, gi: tp.poisson_log_evidence(
        k, z, t(D["X"]), t(D["poisson"]), log_exposure=t(D["exposure"]),
        grad_impl=gi),
    "binomial": lambda k, z, e, gi: tb.binomial_log_evidence(
        k, z, t(D["X"]), t(D["binomial"]), t(D["trials"]), grad_impl=gi),
    "negbin": lambda k, z, e, gi: tn.negbin_log_evidence(
        k, z, t(D["X"]), t(D["negbin"]), e, grad_impl=gi),
    "ordinal": lambda k, z, e, gi: to.ordinal_log_evidence(
        k, z, t(D["X"]), torch.as_tensor(D["ordinal"]), e, grad_impl=gi),
}
EXTRA = {"negbin": 2.0, "ordinal": np.array([-1.0, 0.0, 0.0])}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ift_matches_unroll(family):
    """At the families' default Newton steps: equal values, gradients
    within JAX's bound (rtol 1e-6, atol 1e-8)."""
    fn = FAMILIES[family]
    extra = EXTRA.get(family)
    got = {}
    for gi in ("ift", "unroll"):
        if extra is None:
            got[gi] = torch_value_and_grad(
                lambda k, z: fn(k, z, None, gi), D["Z"])
        else:
            got[gi] = torch_value_and_grad(
                lambda k, z, e: fn(k, z, e, gi), D["Z"], extra)
    assert float(got["ift"][0].detach()) == pytest.approx(
        float(got["unroll"][0].detach()), abs=1e-9)
    for gi_, gu in zip(got["ift"][1], got["unroll"][1]):
        np.testing.assert_allclose(gi_.numpy(), gu.numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_unknown_grad_impl_raises():
    v, d, _, _ = _prior()
    with pytest.raises(ValueError, match="grad_impl"):
        tift.laplace_mode_generic(tc.logit_parts, t(v), t(d),
                                  (t(D["classify"]),), t(D["mask"]),
                                  newton_iters=2, grad_impl="implicit")


def test_line_max_is_a_device_scalar():
    """The line search's step is a 0-d tensor in [0, 1] on the rows'
    device (no host value), and the iteration ascends Psi."""
    v, d, _, _ = _prior()
    y, mask = t(D["classify"]), t(D["mask"])
    f = torch.zeros_like(y)
    a = torch.zeros_like(y)
    psi = []
    for _ in range(4):
        psi.append(float(-0.5 * torch.dot(a, f) + torch.sum(
            mask * tc.logit_loglik(f, (y,)))))
        grad, w = tc.logit_parts(f, (y,), mask)
        f_n = tift.fitc_kdot(t(v), t(d), w * f + grad)  # a crude trial
        s = tift.line_max(tc.logit_parts, (y,), mask, f, f_n, a,
                          w * f + grad)
        assert s.shape == () and 0.0 <= float(s) <= 1.0
        f, a = tift._newton_step(tc.logit_parts, t(v), t(d), (y,), mask, f,
                                 a, tift._identity)
    assert psi == sorted(psi)
