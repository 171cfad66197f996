"""The port's iterative exact GP (models/iterative.py) == gpr_tpu's, in f64
on the CPU.

The same numpy draw goes through ``gpr_tpu.models.iterative`` and the port
for the four families of JAX's own tests (se_iso, matern52, the product
se_iso x lin_one and se_fat, whose cross self-value differs from k_diag):
the blocked matvec and the preconditioner's Woodbury apply at 1e-12, PCG at
1e-9, the CG posterior on JAX's anchor rows (alpha 1e-9 with the iteration
count within 1, means 1e-10, variances 1e-8) and the stochastic evidence
gradient on JAX's own probes and anchors (1e-8); one SGD update on the same
gradient at 1e-12.  The port's dense ``models/exact.py`` is the small-n
oracle, and the port alone meets JAX's statistical criteria: the gradient
averaged over draws within 10 % of the exact one, and the fit up by more
than 50 nats of exact evidence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import iterative as jit_
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.models import exact as texact
from gpr_tpu_torch.models import iterative as tit
from torch_composite import port_kernel
from torch_ext import close, jax_leaf, t
from torch_laplace import one_torch_thread  # noqa: F401  (autouse)

S2 = 0.05
FAMILIES = ("se_iso", "matern52", "prod", "se_fat")


def _data(n=60, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(axis=1)) + 0.1 * rng.standard_normal(n)
    return X, y


def _family(name, X):
    """(JAX family, params, the port's kernel at the same hypers), as in
    JAX's tests: se_fat's per-point options are sized (n,) where Z = X."""
    key = jax.random.PRNGKey(3)
    Xj = jnp.asarray(X)
    if name == "se_iso":
        fam = jk.SeIso
        jp = fam.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.2))
    elif name == "matern52":
        fam = jk.Matern52
        jp = fam.default_params(Xj, 10, key)
    elif name == "prod":
        fam = jk.product_family(jk.SeIso, jk.LinOne)
        jp = fam.default_params(Xj, 10, key)
    else:
        fam = jk.SeFat
        jp = fam.default_params(Xj, X.shape[0], key)
    return fam, jp, port_kernel(fam, jp)


@pytest.fixture(scope="module")
def posterior_refs():
    """JAX's CG posterior of each family on 80 rows, its anchors X[:30]."""
    X, y = _data(n=80)
    Xs = np.random.default_rng(1).standard_normal((25, X.shape[1]))
    refs = {}
    for name in FAMILIES:
        fam, jp, _ = _family(name, X)

        @jax.jit
        def posterior(jp, X, y, Xs):
            tr = jit_.iter_trained(fam, jp, X, y, S2, X_sub=X[:30],
                                   tol=1e-10, max_iter=400, block_size=16)
            var, _ = jit_.predict_variances_iter(
                fam, jp, tr, X, Xs, tol=1e-10, max_iter=400, block_size=16,
                precond=jit_.nystrom_precond(fam, jp, X, S2, X[:30]))
            return tr, jit_.predict_means_iter(fam, jp, tr, Xs,
                                               block_size=8), var

        refs[name] = posterior(jp, *map(jnp.asarray, (X, y, Xs)))
    return X, y, Xs, refs


@pytest.mark.parametrize("name", FAMILIES)
def test_matvec_and_precond_match_jax(name):
    X, _ = _data()
    fam, jp, k = _family(name, X)
    V = np.random.default_rng(2).standard_normal((X.shape[0], 3))
    want = jax.jit(lambda jp, X, V: jit_.kernel_matvec(
        fam, jp, X, V, 0.07, block_size=16))(jp, jnp.asarray(X),
                                            jnp.asarray(V))
    got = tit.kernel_matvec(k, t(X), t(V), 0.07, block_size=16)
    close(got, want, rtol=1e-12, name="matvec")
    close(tit.kernel_matvec(k, t(X), t(V[:, 0]), 0.07, block_size=16),
          want[:, 0], rtol=1e-12, name="matvec 1-D")
    # the dense oracle: chol(K + s2 I)' chol(K + s2 I) V
    chol = texact.calc_exact(k, t(X), 0.07).chol_a.detach()
    close(got, chol.T @ (chol @ t(V)), rtol=1e-10, name="dense")

    r = np.random.default_rng(3).standard_normal((X.shape[0], 2))

    @jax.jit
    def precond(jp, X, r):
        pre = jit_.nystrom_precond(fam, jp, X, S2, X[:12])
        return pre, pre.apply(r)

    jpre, japply = precond(jp, jnp.asarray(X), jnp.asarray(r))
    pre = tit.nystrom_precond(k, t(X), S2, t(X[:12]))
    for field in ("v", "d", "chol_c"):
        close(getattr(pre, field), getattr(jpre, field), rtol=1e-12,
              name=field)
    close(pre.apply(t(r)), japply, rtol=1e-12, name="apply")


def test_pcg_matches_jax():
    rng = np.random.default_rng(4)
    n = 32
    m = rng.standard_normal((n, n))
    a = m @ m.T + n * np.eye(n)
    b = rng.standard_normal((n, 4))
    jx, jinfo = jit_.pcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                         tol=1e-12, max_iter=200)
    x, info = tit.pcg(lambda v: t(a) @ v, t(b), tol=1e-12, max_iter=200)
    close(x, jx, rtol=1e-9, name="x")
    assert abs(info["iters"] - int(jinfo["iters"])) <= 1
    assert float(info["relres"].max()) < 1e-10
    # 1-D right-hand side and a preconditioner that cuts the iterations
    X, y = _data(n=120, d=3)
    k = SeIso(0.5, 0.0, device="cpu", dtype=torch.float64)
    A = texact.calc_exact(k, t(X), 1e-3)
    dense = (A.chol_a.T @ A.chol_a).detach()
    pre = tit.nystrom_precond(k, t(X), 1e-3, t(X[:40]))
    _, plain = tit.pcg(lambda v: dense @ v, t(y), tol=1e-8, max_iter=500)
    _, cond = tit.pcg(lambda v: dense @ v, t(y), precond=pre, tol=1e-8,
                      max_iter=500)
    assert cond["iters"] < plain["iters"]
    assert float(cond["relres"].max()) < 1e-8


@pytest.mark.parametrize("name", FAMILIES)
def test_posterior_matches_jax(name, posterior_refs):
    X, y, Xs, refs = posterior_refs
    jtr, jmu, jvar = refs[name]
    _, _, k = _family(name, X)
    tr = tit.iter_trained(k, t(X), t(y), S2, X_sub=t(X[:30]), tol=1e-10,
                          max_iter=400, block_size=16)
    close(tr.alpha, jtr.alpha, rtol=1e-9, name="alpha")
    assert abs(tr.iters - int(jtr.iters)) <= 1
    close(tr.z, jtr.z, rtol=1e-12, name="z")
    # the predictors on JAX's coefficients: alpha's own 1e-9 stays out
    same = tit.IterTrained(z=t(jtr.z), sigma2=t(S2), alpha=t(jtr.alpha),
                           iters=0, relres=t(0.0))
    mu = tit.predict_means_iter(k, same, t(Xs), block_size=8)
    close(mu, jmu, rtol=1e-10, name="means")
    pre = tit.nystrom_precond(k, t(X), S2, t(X[:30]))
    var, info = tit.predict_variances_iter(k, same, t(X), t(Xs), tol=1e-10,
                                           max_iter=400, block_size=16,
                                           precond=pre)
    close(var, jvar, rtol=1e-8, name="variances")
    # the dense exact posterior is the oracle
    dense = texact.exact_trained(texact.calc_exact(k, t(X), S2), t(y))
    close(tr.alpha, dense.alpha.detach(), rtol=1e-6, name="dense alpha")
    close(var, texact.predict_variances_exact(k, dense, t(Xs)).detach(),
          rtol=1e-5, name="dense variances")


def test_default_anchors_draw_from_the_generator():
    X, y = _data(n=80)
    k = SeIso(0.3, 0.2, device="cpu", dtype=torch.float64)
    a = tit.iter_trained(k, t(X), t(y), S2, n_inducing=30, tol=1e-10,
                         max_iter=400, block_size=16)
    b = tit.iter_trained(k, t(X), t(y), S2, n_inducing=30, tol=1e-10,
                         max_iter=400, block_size=16,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.alpha, b.alpha) and a.iters == b.iters
    dense = texact.exact_trained(texact.calc_exact(k, t(X), S2), t(y))
    close(a.alpha, dense.alpha.detach(), rtol=1e-6, name="alpha")


@pytest.mark.parametrize("name", ("se_iso", "se_fat"))
def test_evidence_grads_match_jax_on_its_draws(name):
    X, y = _data(n=40, d=2)
    fam, jp, k = _family(name, X)
    key = jax.random.PRNGKey(100)
    n, n_probes, m = X.shape[0], 8, 20
    (jgp, jgs), jinfo = _jax_grads(fam, jp, X, y, 0.08, key,
                                   n_probes=n_probes, n_inducing=m,
                                   tol=1e-12, max_iter=400, block_size=16)
    # JAX's own draws (gpr_tpu/models/iterative.py:394-399)
    probes = jax.random.rademacher(key, (n, n_probes), dtype=jnp.float64)
    idx = jax.random.choice(jax.random.fold_in(key, 1), n, (m,),
                            replace=False)
    (gp, gs), info = tit.evidence_grads_iter(
        k, t(X), t(y), 0.08, probes=t(probes), X_sub=t(X[np.asarray(idx)]),
        tol=1e-12, max_iter=400, block_size=16)
    assert set(gp) == {name for name, v in jax_fields_of(jp) if v}
    for field, g in gp.items():
        close(g, jax_leaf(jgp, field), rtol=1e-8, name=field)
    close(gs, jgs, rtol=1e-8, name="sigma2")
    assert float(info["relres"].max()) < 1e-11
    assert abs(info["iters"] - int(jinfo["iters"])) <= 1


def _jax_grads(fam, jp, X, y, s2, key, **kw):
    """JAX's evidence_grads_iter, jitted as its fit_iter does (a jitted
    call compiles once; an eager one dispatches every op)."""
    return jax.jit(lambda jp, X, y, s2, key: jit_.evidence_grads_iter(
        fam, jp, X, y, s2, key, **kw))(jp, jnp.asarray(X), jnp.asarray(y),
                                       jnp.asarray(s2), key)


def jax_fields_of(jp):
    """(dotted name, is an array) of each field of JAX params."""
    from torch_composite import jax_fields

    return [(name, not isinstance(v, int)) for name, v in
            jax_fields(jp).items()]


def test_sgd_update_matches_jax_fit_iter():
    """One step of JAX's fit_iter against the port's update on the same
    gradient (JAX's, from the key JAX's step draws with)."""
    X, y = _data(n=50, d=2)
    fam, jp, k = _family("se_iso", X)
    key = jax.random.PRNGKey(5)
    kw = dict(n_probes=4, n_inducing=10, tol=1e-10, max_iter=300,
              block_size=16)
    jp1, js1 = jit_.fit_iter(fam, jp, jnp.asarray(X), jnp.asarray(y), 0.3,
                             key=key, n_steps=1, eta0=0.5, **kw)
    (jgp, jgs), _ = _jax_grads(fam, jp, X, y, 0.3,
                               jax.random.fold_in(key, 0), **kw)
    grads = {f: t(getattr(jgp, f)) for f in ("log_ell", "log_sf2")}
    k1, s1 = tit.sgd_update(k, t(0.3), grads, t(jgs), 0, X.shape[0],
                            eta0=0.5)
    close(k1.log_ell, jp1.log_ell, rtol=1e-12, name="log_ell")
    close(k1.log_sf2, jp1.log_sf2, rtol=1e-12, name="log_sf2")
    close(s1, js1, rtol=1e-12, name="sigma2")


def test_evidence_grads_unbiased():
    """JAX's criterion (tests/test_iterative.py:134-167): the gradient
    averaged over 6 draws within 10 % of the exact autograd gradient."""
    X, y = _data(n=40, d=2)
    k = SeIso(0.4, 0.1, device="cpu", dtype=torch.float64)
    s2 = t(0.08).requires_grad_(True)
    neg_l = -texact.log_evidence_exact(k, t(X), t(y), s2)
    want = torch.autograd.grad(neg_l, (k.log_ell, k.log_sf2, s2))
    acc = [0.0, 0.0, 0.0]
    for i in range(6):
        (gp, gs), info = tit.evidence_grads_iter(
            k, t(X), t(y), 0.08, torch.Generator().manual_seed(100 + i),
            n_probes=8, n_inducing=20, tol=1e-10, max_iter=400,
            block_size=16)
        assert float(info["relres"].max()) < 1e-9
        for j, g in enumerate((gp["log_ell"], gp["log_sf2"], gs)):
            acc[j] += float(g) / 6
    for got, w in zip(acc, want):
        np.testing.assert_allclose(got, float(w), rtol=0.1)


def test_fit_iter_improves_exact_evidence():
    """JAX's criterion (tests/test_iterative.py:170-188): exact evidence up
    by more than 50 nats in 60 steps."""
    X, y = _data(n=150, d=2)
    k0 = SeIso(1.5, -1.0, device="cpu", dtype=torch.float64)

    def exact_l(k, s2):
        with torch.no_grad():
            return float(texact.log_evidence_exact(k, t(X), t(y), s2))

    seen = []
    k1, s2_1 = tit.fit_iter(
        k0, t(X), t(y), 0.5, generator=torch.Generator().manual_seed(5),
        n_steps=60, eta0=0.5, n_probes=8, n_inducing=40, tol=1e-8,
        max_iter=300, block_size=32,
        callback=lambda step, k, s2, info: seen.append(step))
    l0, l1 = exact_l(k0, 0.5), exact_l(k1, s2_1)
    assert l1 > l0 + 50.0, (l0, l1)
    assert float(s2_1) > 0.0 and seen == list(range(60))
