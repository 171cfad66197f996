"""The port's kernel combinators (sum, prod, cols) == gpr_tpu's, in f64 on
the CPU.

On ``SUM3`` = sum(se_iso,lin_ard,const), ``PROD2`` = prod(periodic,se_iso)
and ``NESTED`` = sum(PROD2,lin_one), with JAX's params moved off their
defaults and carried over by their dotted names: every method at 1e-12;
the dense evidence (qr and chol, variational on and off) and the masked
streaming evidence under both ``grad_impl``s with every gradient at 1e-10;
the packed vector element for element, also for ``sum(rq,periodic)`` and a
sum with an se_fat term whose options are on, with a distinct value in
every leaf (a combinator's leaves follow each term's declaration order,
not the sorted names); artifacts both ways; the parse round trip and the
interning; the cols restriction law.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.io import checkpoint as jckpt
from gpr_tpu.optim import lbfgs_device as jlb
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu.optim.polish import polish as j_polish
from gpr_tpu.optim.train import train as j_train
from gpr_tpu_torch import kernels as tk
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.kernels.base import field_of, hyper_leaves
from gpr_tpu_torch.optim import fit, fit_restarts, make_pack, polish
from gpr_tpu_torch.optim import train as ttrain
from torch_composite import (
    F64,
    S2,
    check_artifacts,
    check_dense,
    check_methods,
    check_pack,
    check_streaming,
    close,
    jax_fields,
    jax_streaming,
    perturbed,
    port_kernel,
    t_,
)

N, D, M = 90, 3, 5
JFAMS = {
    "SUM3": jk.sum_family(jk.SeIso, jk.LinArd, jk.Const),
    "PROD2": jk.product_family(jk.Periodic, jk.SeIso),
}
JFAMS["NESTED"] = jk.sum_family(JFAMS["PROD2"], jk.LinOne)


@functools.lru_cache(maxsize=None)
def _problem(key):
    """(X, y, Z, mask, Xs, JAX family, JAX params, port kernel)."""
    jfam = JFAMS[key]
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, D))
    y = np.sin(X[:, 0] - X[:, 1]) + 0.3 * X[:, 2] + 0.2 * rng.standard_normal(N)
    jp = perturbed(jfam.default_params(X, M, jax.random.PRNGKey(3)), 11)
    Z = np.asarray(jfam.inducing_from_inputs(jp, rng.standard_normal((M, D))))
    mask = (rng.uniform(size=N) > 0.2).astype(np.float64)
    Xs = rng.standard_normal((15, D))
    return X, y, Z, mask, Xs, jfam, jp, port_kernel(jfam, jp)


@pytest.mark.parametrize("key", sorted(JFAMS))
def test_methods_match_jax(key):
    X, _, Z, _, _, jfam, jp, k = _problem(key)
    check_methods(jfam, jp, k, X, Z)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
@pytest.mark.parametrize("key", sorted(JFAMS))
def test_dense_evidence_and_grads(key, variational, factorization):
    X, y, Z, _, _, jfam, jp, k = _problem(key)
    check_dense(jfam, jp, k, X, y, Z, variational, factorization)


@functools.lru_cache(maxsize=None)
def _jax_streaming(key):
    X, y, Z, mask, _, jfam, jp, _ = _problem(key)
    return jax_streaming(jfam, jp, X, y, Z, mask)


@pytest.mark.parametrize("grad_impl", ["custom", "ad"])
@pytest.mark.parametrize("key", sorted(JFAMS))
def test_streaming_evidence_and_grads(key, grad_impl):
    """No combinator has a hand pullback: the custom VJP pulls each tile
    back through ``torch.func.vjp``, as JAX's through ``jax.vjp``."""
    X, y, Z, mask, _, _, _, k = _problem(key)
    assert not hasattr(k, "k_cross_vjp")
    check_streaming(k, X, y, Z, mask, grad_impl, *_jax_streaming(key))


@pytest.mark.parametrize("key", sorted(JFAMS))
def test_make_pack_matches_jax(key):
    _, _, Z, _, _, jfam, jp, k = _problem(key)
    check_pack(jfam, jp, k, Z)


def _distinct(jfam, X, m):
    """JAX params with a distinct value in every leaf element."""
    jp = jfam.default_params(X, m, jax.random.PRNGKey(0))
    leaves, tree = jax.tree.flatten(jp)
    at, out = 1, []
    for leaf in leaves:
        size = int(np.size(leaf))
        out.append(np.arange(at, at + size, dtype=np.float64).reshape(
            np.shape(leaf)) / 10.0)
        at += size
    return jax.tree.unflatten(tree, out)


@pytest.mark.parametrize("name", ["sum(rq,periodic)",
                                  "sum(se_fat,se_iso)"])
def test_packed_x0_distinct_leaves(name):
    """With a distinct value in every leaf, the packed vector equals JAX's:
    rq's leaves go log_ell, log_sf2, log_alpha, periodic's log_ell,
    log_sf2, log_period and se_fat's log_sf2, tproj, hetero, multiscales
    (declaration order), where the base families pack sorted."""
    jfam = jk.resolve_family(name)
    X = np.random.default_rng(2).standard_normal((20, 4))
    jp = _distinct(jfam, X, 3)
    if name.startswith("sum(se_fat"):
        se_fat = jp.terms[0]
        assert all(getattr(se_fat, f) is not None for f in (
            "tproj", "log_hetero_skedasticity", "log_multiscales_m05"))
    k = port_kernel(jfam, jp)
    values = np.concatenate([np.ravel(v) for v in jax.tree.leaves(jp)])
    assert len(np.unique(values)) == len(values)
    z = jfam.inducing_from_inputs(jp, X[:3])
    pack, jpack = check_pack(jfam, jp, k, np.asarray(z))
    close(pack.x0[1:1 + len(values)], values, 0)
    if name == "sum(rq,periodic)":
        assert hyper_leaves(k)[0] == (
            "terms.0.log_ell", "terms.0.log_sf2", "terms.0.log_alpha",
            "terms.1.log_ell", "terms.1.log_sf2", "terms.1.log_period")


def test_pack_fixed_is_top_level():
    """``fixed`` names top-level fields, as in the JAX package: for a
    combinator ``terms`` holds every kernel hyper."""
    X, _, Z, _, _, jfam, jp, k = _problem("SUM3")
    pack = make_pack(k, t_(Z), S2, fixed=("terms",))
    jpack = j_make_pack(jfam, jp, Z, S2, fixed=("terms",))
    close(pack.x0, jpack.x0, 0)
    with pytest.raises(ValueError, match="unknown hyper fields"):
        make_pack(k, t_(Z), S2, fixed=("log_ell",))


@pytest.mark.parametrize("key", sorted(JFAMS))
def test_artifacts_cross_packages(key, tmp_path):
    X, y, Z, _, Xs, jfam, jp, k = _problem(key)
    check_artifacts(jfam, jp, k, X, y, Z, Xs, tmp_path)


def test_from_jax_params_nested_form():
    """``from_jax_params`` takes a combinator's fields nested as well as
    dotted."""
    _, _, _, _, _, jfam, jp, k = _problem("NESTED")
    nested = {"terms": (
        {"terms": tuple(vars(t) for t in jp.terms[0].terms)},
        vars(jp.terms[1]))}
    got, _, _ = from_jax_params(nested, np.zeros((1, D)), 1.0, device="cpu",
                                dtype=F64, family=jfam.name)
    (names, got_leaves), (_, want) = hyper_leaves(got), hyper_leaves(k)
    for name, a, b in zip(names, got_leaves, want):
        assert torch.equal(a, b.detach()), name
    assert set(jax_fields(jp)) == set(type(k).param_names)


@pytest.mark.parametrize("name", ["sum(se_iso,lin_ard)",
                                  "prod(se_ard,cosine)",
                                  "sum(prod(periodic,se_iso),lin_one)",
                                  "prod(cols(task(2,1),8,9),cols(se_iso,0,8))"])
def test_parse_round_trip_and_interning(name):
    cls = tk.resolve_family(name)
    assert cls.name == name == jk.resolve_family(name).name
    assert tk.resolve_family(cls.name) is cls
    assert cls.param_names == tuple(
        jckpt._params_to_arrays(jk.resolve_family(name).default_params(
            np.ones((4, 9)), 2, None))[0])


def test_interning_and_unknown_names():
    assert tk.sum_family(tk.SeIso, tk.LinArd) is tk.sum_family(tk.SeIso,
                                                               tk.LinArd)
    assert tk.cols_family(tk.SeIso, 0, 2) is tk.cols_family(tk.SeIso, 0, 2)
    assert tk.sum_family(tk.SeIso, tk.LinArd) is not tk.product_family(
        tk.SeIso, tk.LinArd)
    for bad in ("sum(se_iso,bogus)", "cols(se_iso,1)", "task(2)", "nope"):
        with pytest.raises(KeyError) as e:
            tk.resolve_family(bad)
        with pytest.raises(KeyError) as je:
            jk.resolve_family(bad)
        assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="at least two"):
        tk.sum_family(tk.SeIso)
    with pytest.raises(ValueError, match="0 <= lo < hi"):
        tk.cols_family(tk.SeIso, 2, 2)


def test_cols_restriction_law():
    """cols(se_iso, 1, 3) on wide rows == se_iso on those columns, and Z's
    other columns get an exactly zero gradient."""
    rng = np.random.default_rng(4)
    X, Z = t_(rng.standard_normal((12, 4))), t_(rng.standard_normal((5, 4)))
    fam = tk.cols_family(tk.SeIso, 1, 3)
    k = fam(tk.SeIso(0.2, -0.1, device="cpu", dtype=F64))
    se = k.terms[0]
    close(k.k_cross(X, Z), se.k_cross(X[:, 1:3], Z[:, 1:3]).detach(), 1e-15)
    close(k.k_upper(Z), se.k_upper(Z[:, 1:3]).detach(), 1e-15)
    close(k.k_diag(X), se.k_diag(X[:, 1:3]).detach(), 1e-15)
    z = Z.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(k.k_cross(X, z)), z)
    assert torch.all(g[:, [0, 3]] == 0) and torch.all(g[:, 1:3] != 0)


def test_default_params_one_generator():
    """The port's defaults: JAX's where nothing is drawn; a drawing term
    (cosine) takes its draws from one generator, term by term, and a
    second cosine term draws anew."""
    X = t_(np.random.default_rng(1).standard_normal((30, 2)))
    fam = tk.resolve_family("sum(se_iso,lin_ard,const)")
    k = fam.default_params(X, 4)
    jp = jk.resolve_family(fam.name).default_params(np.asarray(X), 4, None)
    for name, value in jax_fields(jp).items():
        close(field_of(k, name), value, 0, name)
    two = tk.resolve_family("sum(cosine,cosine)")
    drawn = two.default_params(X, 4, torch.Generator().manual_seed(5))
    again = two.default_params(X, 4, torch.Generator().manual_seed(5))
    assert torch.equal(drawn.terms[0].mu, again.terms[0].mu)
    assert torch.equal(drawn.terms[1].mu, again.terms[1].mu)
    assert not torch.equal(drawn.terms[0].mu, drawn.terms[1].mu)


def _same_run(st, jst):
    assert (st.n_iter, st.n_evals, st.failed) == (
        int(jst.n_iter), int(jst.n_evals), bool(jst.failed))
    close(st.x, jst.x, 1e-8, "x")


@pytest.mark.parametrize("trainer", ["fit", "fit_restarts", "polish",
                                     "train"])
def test_training_matches_jax(trainer):
    """The trainers on a combinator (PROD2, streaming in blocks of 32 over
    90 rows, variational): the JAX run's counts and final x at 1e-8 (the
    host ``train``: its final evidence at 1e-10 and x at 1e-8)."""
    X, y, Z, _, _, jfam, jp, k = _problem("PROD2")
    jpack = j_make_pack(jfam, jp, Z, S2)
    pack = make_pack(k, t_(Z), S2)
    jX, jy = jax.numpy.asarray(X), jax.numpy.asarray(y)
    kw = dict(variational=True, max_iter=8, epsabs=1e-6)
    if trainer == "fit":
        *_, jst = jlb.fit(jfam, jX, jy, jpack, streaming_block_size=32, **kw)
        *_, st = fit(t_(X), t_(y), pack, streaming_block_size=32, **kw)
        _same_run(st, jst)
    elif trainer == "fit_restarts":
        x0s = [pack.x0, pack.x0 + 0.05]
        kw.update(probe_iters=3, streaming_block_size=32)
        *_, jst, jrep = jlb.fit_restarts(jfam, jX, jy, jpack,
                                         [np.asarray(x) for x in x0s], **kw)
        *_, st, rep = fit_restarts(t_(X), t_(y), pack, x0s, **kw)
        _same_run(st, jst)
        close(list(rep), list(jrep), 1e-10, "probes")
    elif trainer == "polish":
        x = np.asarray(jpack.x0) + 0.05
        kw.update(subsample=None, block_size=32)
        *_, jx, jrep = j_polish(jfam, jX, jy, jpack, jax.numpy.asarray(x),
                                **kw)
        *_, xf, rep = polish(t_(X), t_(y), pack, t_(x), **kw)
        assert (rep.n_iter, rep.n_evals) == (jrep.n_iter, jrep.n_evals)
        close(xf, jx, 1e-8, "x")
    else:
        kw.update(block_size=32)
        want = j_train(jfam, jX, jy, kernel_params=jp, inducing=Z,
                            sigma2=S2, **kw)
        got = ttrain(type(k), t_(X), t_(y), kernel_params=k,
                     inducing=t_(Z), sigma2=S2, **kw)
        close(got.l, want.l, 1e-10, "l")
        for name, value in jax_fields(want.kernel_params).items():
            close(field_of(got.kernel_params, name), value, 1e-8, name)
        close(got.inducing, want.inducing, 1e-8, "z")
