"""The port's base kernel families == gpr_tpu's, in f64 on the CPU.

For each of se_ard, matern32, matern52, rq, periodic, cosine, lin_one,
lin_ard and const, the same numpy inputs go through the JAX family and its
``nn.Module`` counterpart: every method and the kernel protocol's helpers
at rtol 1e-12; ``default_params``; the hand pullbacks of matern and rq
against autograd and against JAX's; the dense evidence and its gradients
(hypers, z, sigma2) at rtol 1e-10; the masked streaming evidence and its
gradients under both ``grad_impl``s at rtol 1e-10; central differences of
the dense evidence against autograd at rtol 1e-6; the packed vector; and
npz artifacts carried both ways.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.io import checkpoint as jckpt
from gpr_tpu.kernels import base as jbase
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.models import streaming as jst
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu_torch import kernels as tk
from gpr_tpu_torch.convert import from_jax_params, params_from_artifact
from gpr_tpu_torch.io import checkpoint as tckpt
from gpr_tpu_torch.kernels import base as tbase
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import fitc as tfitc
from gpr_tpu_torch.models import streaming as tst
from gpr_tpu_torch.optim import make_pack

F64 = torch.float64
N, D, M, S2 = 120, 3, 6, 0.3
NAMES = ["se_ard", "matern32", "matern52", "rq", "periodic", "cosine",
         "lin_one", "lin_ard", "const"]
HAND_VJP = ["matern32", "matern52", "rq"]
#: K(Z, Z) of cosine, lin_one, lin_ard and const has rank 2, d + 1, d and 1.
#: Past it the Gram is singular up to the jitter, which amplifies rounding
#: about 1e6-fold in both packages alike; at it the approximation is exact
#: and the evidence's z-gradient is the jitter's alone.  So these take m
#: below their rank (const's z has no columns: m = 1).
RANK_M = {"cosine": 1, "lin_one": D, "lin_ard": D - 1, "const": 1}


def _fields(name, rng):
    """Hyper fields away from the defaults, by field name."""
    u = lambda *shape: rng.uniform(-0.4, 0.4, shape)  # noqa: E731
    return {
        "se_ard": {"log_ells": u(D), "log_sf2": u()},
        "matern32": {"log_ell": u(), "log_sf2": u()},
        "matern52": {"log_ell": u(), "log_sf2": u()},
        "rq": {"log_ell": u(), "log_sf2": u(), "log_alpha": u()},
        "periodic": {"log_ell": u(), "log_sf2": u(),
                     "log_period": 0.5 + u()},
        "cosine": {"mu": rng.uniform(0.05, 0.3, D)},
        "lin_one": {"log_theta": u()},
        "lin_ard": {"log_ells": u(D)},
        "const": {"log_theta": u()},
    }[name]


def _problem(name, seed=0):
    """(X, y, Z, mask, JAX family, JAX params, port kernel): Z is the
    family's inducing representation of fresh input rows."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D))
    y = np.sin(X[:, 0] - X[:, 1]) + 0.2 * rng.standard_normal(N)
    fields = _fields(name, rng)
    fam = jk.FAMILIES[name]
    jp = fam.Params(**{k: jnp.asarray(v) for k, v in fields.items()})
    Z = np.array(fam.inducing_from_inputs(
        jp, jnp.asarray(rng.standard_normal((M, D))[:RANK_M.get(name, M)])))
    mask = (rng.uniform(size=N) > 0.2).astype(np.float64)
    kernel = tk.FAMILIES[name](**fields, device="cpu", dtype=F64)
    return X, y, Z, mask, fam, jp, kernel


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.shape(got) == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0),
                                               1e-300),
                               err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_methods_match_jax(name):
    X, _, Z, _, fam, jp, k = _problem(name)
    coeffs = np.random.default_rng(3).standard_normal(len(Z))
    tX, tZ, jX, jZ = _t(X), _t(Z), jnp.asarray(X), jnp.asarray(Z)
    cases = {
        "inducing_from_inputs": (k.inducing_from_inputs(tX[:5]),
                                 fam.inducing_from_inputs(jp, jX[:5])),
        "k_upper": (k.k_upper(tZ), fam.k_upper(jp, jZ)),
        "k_diag": (k.k_diag(tX), fam.k_diag(jp, jX)),
        "k_cross": (k.k_cross(tX, tZ), fam.k_cross(jp, jX, jZ)),
        "k_upper_inputs": (k.k_upper_inputs(tX[:20]),
                           fam.k_upper_inputs(jp, jX[:20])),
        "k_one": (k.k_one(tX[0]), fam.k_one(jp, jX[0])),
        "weighted_eval": (
            tbase.weighted_eval(k, tX, tZ, _t(coeffs)),
            jbase.weighted_eval(fam, jp, jX, jZ, jnp.asarray(coeffs))),
        "weighted_eval_one": (
            tbase.weighted_eval_one(k, tX[1], tZ, _t(coeffs)),
            jbase.weighted_eval_one(fam, jp, jX[1], jZ,
                                    jnp.asarray(coeffs))),
        "choose_subset": (tbase.choose_subset(tX, [4, 0, 7]),
                          jbase.choose_subset(jX, [4, 0, 7])),
    }
    for method, (got, want) in cases.items():
        _close(got, want, 1e-12, method)
    assert k.name == fam.name == name
    assert tk.resolve_family(name) is type(k)
    assert list(type(k).param_names) == sorted(
        f.name for f in jp.__dataclass_fields__.values())
    assert type(k).learn_inducing_default == fam.learn_inducing_default
    assert {n for n, _ in k.named_parameters()} == set(type(k).param_names)


@pytest.mark.parametrize("name", NAMES)
def test_default_params(name):
    """JAX's defaults without a key; cosine's draw with a generator is the
    generator's own (positive, |0.3 N(0, 1)| + 0.05, reproducible)."""
    X = np.random.default_rng(1).standard_normal((40, D))
    cls = tk.FAMILIES[name]
    k = cls.default_params(_t(X), M)
    jp = jk.FAMILIES[name].default_params(jnp.asarray(X), M, None)
    for field in cls.param_names:
        got = getattr(k, field)
        assert got.dtype == F64, field
        _close(got, getattr(jp, field), 0, field)
    drawn = cls.default_params(_t(X), M, torch.Generator().manual_seed(5))
    again = cls.default_params(_t(X), M, torch.Generator().manual_seed(5))
    for field in cls.param_names:
        assert torch.equal(getattr(drawn, field), getattr(again, field))
    if name == "cosine":
        assert torch.all(drawn.mu >= 0.05) and drawn.mu.shape == (D,)
        assert not torch.equal(drawn.mu, k.mu)


@pytest.mark.parametrize("name", HAND_VJP)
def test_k_cross_vjp(name):
    """The hand pullback == autograd of (k_cross, k_diag) == JAX's, with a
    coincident point (d2 = 0) among the pairs."""
    X, _, Z, _, fam, jp, k = _problem(name)
    Z[2] = X[5]
    rng = np.random.default_rng(5)
    knm_bar, kd_bar = rng.standard_normal((N, M)), rng.standard_normal(N)
    tX, tZ = _t(X), _t(Z).requires_grad_(True)
    names, hypers = hyper_leaves(k)
    knm = k.k_cross(tX, tZ)
    got = k.k_cross_vjp(tX, tZ.detach(), knm.detach(), _t(knm_bar),
                        _t(kd_bar))
    objective = (torch.sum(knm * _t(knm_bar))
                 + torch.sum(k.k_diag(tX) * _t(kd_bar)))
    auto = torch.autograd.grad(objective, (*hypers, tZ))
    jknm = fam.k_cross(jp, jnp.asarray(X), jnp.asarray(Z))
    jbar, jz_bar = fam.k_cross_vjp(jp, jnp.asarray(X), jnp.asarray(Z), jknm,
                                   jnp.asarray(knm_bar), jnp.asarray(kd_bar))
    assert len(got) == len(names) + 1
    for field, g, a in zip((*names, "z"), got, auto):
        want = jz_bar if field == "z" else getattr(jbar, field)
        _close(g, want, 1e-12, field)
        _close(g, a.numpy(), 1e-12, field)


def _grads(val, k, z, s2):
    """The gradients by field name; zero where a field does not enter (z
    of const, which has no columns)."""
    names, hypers = hyper_leaves(k)
    wrt = (*hypers, z, s2)
    grads = torch.autograd.grad(val, wrt, allow_unused=True)
    return {name: torch.zeros_like(t) if g is None else g
            for name, t, g in zip((*names, "z", "sigma2"), wrt, grads)}


def _check_value_and_grads(val, grads, jval, jgrads, rtol, tag):
    _close(val, jval, rtol, f"{tag} value")
    for field, g in grads.items():
        _close(g, jgrads[field], rtol, f"{tag} {field}")


def _jax_value_and_grad(fam, jp, Z, f):
    """jax.value_and_grad of f(params, z, sigma2), the gradient as a dict
    by field name."""
    val, (gp, gz, gs) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jp, jnp.asarray(Z), jnp.asarray(S2))
    return val, {**{n: getattr(gp, n) for n in jp.__dataclass_fields__},
                 "z": gz, "sigma2": gs}


@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
@pytest.mark.parametrize("name", NAMES)
def test_dense_evidence_and_grads(name, variational):
    X, y, Z, _, fam, jp, k = _problem(name)
    jval, jgrads = _jax_value_and_grad(fam, jp, Z, lambda p, z, s: (
        jfitc.log_evidence(fam, p, z, s, jnp.asarray(X), jnp.asarray(y),
                           variational=variational)))
    z, s2 = _t(Z).requires_grad_(True), _t(S2).requires_grad_(True)
    val = tfitc.log_evidence(k, z, s2, _t(X), _t(y), variational=variational)
    _check_value_and_grads(val, _grads(val, k, z, s2), jval, jgrads, 1e-10,
                           "dense")


@functools.lru_cache(maxsize=None)
def _jax_streaming(name):
    X, y, Z, mask, fam, jp, _ = _problem(name)

    def f(p, z, s):
        inducing = jfitc.calc_inducing(fam, p, z)
        stats = jst.stream_stats(fam, p, inducing, s, jnp.asarray(X),
                                 jnp.asarray(y), block_size=32,
                                 mask=jnp.asarray(mask))
        return jst.evidence_from_stats(inducing, stats, variational=True)

    return _jax_value_and_grad(fam, jp, Z, f)


@pytest.mark.parametrize("grad_impl", ["custom", "ad"])
@pytest.mark.parametrize("name", NAMES)
def test_streaming_evidence_and_grads(name, grad_impl):
    """The masked streaming evidence (variational, block 32 over 120 rows:
    a ragged last block) and its gradients == JAX's; the custom VJP takes
    the family's hand pullback or autograd of its tile."""
    X, y, Z, mask, _, _, k = _problem(name)
    jval, jgrads = _jax_streaming(name)
    z, s2 = _t(Z).requires_grad_(True), _t(S2).requires_grad_(True)
    inducing = tfitc.calc_inducing(k, z)
    stats = tst.stream_stats(k, inducing, s2, _t(X), _t(y), block_size=32,
                             mask=_t(mask), grad_impl=grad_impl)
    val = tst.evidence_from_stats(inducing, stats, variational=True)
    _check_value_and_grads(val, _grads(val, k, z, s2), jval, jgrads, 1e-10,
                           grad_impl)
    # the default route of a family that is not se_iso is the plain loop
    assert tst._resolve_impl(None, _t(X), k, z=z) == "reference"


@pytest.mark.parametrize("name", sorted(RANK_M))
def test_low_rank_streaming_past_the_rank(name, monkeypatch):
    """At m = 6, past the rank of K(Z, Z), the masked streaming evidence
    and its hyper and sigma2 gradients still equal JAX's at rtol 1e-10;
    the z gradient, which the jitter then decides, within 10 eps kappa,
    kappa the condition number of K(Z, Z) + jitter I (the amplification of
    rounding by the solves: 4e6 to 1e7 here; measured 1 to 4 eps kappa)."""
    monkeypatch.setitem(RANK_M, name, M)
    X, y, Z, mask, fam, jp, k = _problem(name)
    assert Z.shape[0] == M

    def f(p, z, s):
        inducing = jfitc.calc_inducing(fam, p, z)
        stats = jst.stream_stats(fam, p, inducing, s, jnp.asarray(X),
                                 jnp.asarray(y), block_size=32,
                                 mask=jnp.asarray(mask))
        return jst.evidence_from_stats(inducing, stats, variational=True)

    jval, jgrads = _jax_value_and_grad(fam, jp, Z, f)
    z, s2 = _t(Z).requires_grad_(True), _t(S2).requires_grad_(True)
    inducing = tfitc.calc_inducing(k, z)
    stats = tst.stream_stats(k, inducing, s2, _t(X), _t(y), block_size=32,
                             mask=_t(mask))
    val = tst.evidence_from_stats(inducing, stats, variational=True)
    grads = _grads(val, k, z, s2)
    chol = inducing.chol_km.detach()
    kappa = float(torch.linalg.cond(chol.T @ chol))
    assert 1e6 < kappa < 1e8, kappa
    _close(val, jval, 1e-10, "value")
    for field, g in grads.items():
        rtol = 10 * np.finfo(np.float64).eps * kappa if field == "z" else 1e-10
        if field == "z" and not np.any(jgrads[field]):
            assert not torch.any(g)  # const's z has no columns
            continue
        _close(g, jgrads[field], rtol, field)


@pytest.mark.parametrize("name", NAMES)
def test_finite_differences(name):
    """Central differences of the dense evidence along every hyper element
    and sigma2 == autograd (the test_derivatives.py check, on the port)."""
    X, y, Z, _, _, _, k = _problem(name)
    tX, ty, tZ = _t(X), _t(y), _t(Z)
    names, hypers = hyper_leaves(k)
    s2 = _t(S2).requires_grad_(True)
    grads = torch.autograd.grad(
        tfitc.log_evidence(k, tZ, s2, tX, ty, variational=True),
        (*hypers, s2))
    h = 1e-5
    for field, base, g in zip((*names, "sigma2"), (*hypers, s2), grads):
        flat = base.detach().reshape(-1)
        for i in range(flat.numel()):
            vals = []
            for step in (h, -h):
                moved = flat.clone()
                moved[i] += step
                moved = moved.reshape(base.shape)
                if field == "sigma2":
                    kern, s = k, moved
                else:
                    kern = tbase.kernel_with(k, {field: moved})
                    s = s2.detach()
                with torch.no_grad():
                    vals.append(float(tfitc.log_evidence(
                        kern, tZ, s, tX, ty, variational=True)))
            fd = (vals[0] - vals[1]) / (2 * h)
            np.testing.assert_allclose(float(g.reshape(-1)[i]), fd,
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{field}[{i}]")


@pytest.mark.parametrize("name", NAMES)
def test_make_pack_matches_jax(name):
    """The packed vector means the same in both packages; inducing points
    are packed by default where the family learns them."""
    _, _, Z, _, fam, jp, k = _problem(name)
    jpack = j_make_pack(fam, jp, jnp.asarray(Z), S2)
    pack = make_pack(k, _t(Z), S2)
    _close(pack.x0, jpack.x0, 0)
    assert pack.learn_inducing == fam.learn_inducing_default
    kernel, z, _ = pack.unpack(pack.x0)
    for field in type(k).param_names:
        assert torch.equal(getattr(kernel, field), getattr(k, field).detach())
    assert torch.equal(z, _t(Z))


@pytest.mark.parametrize("name", NAMES)
def test_artifacts_cross_packages(name, tmp_path):
    """A JAX artifact serves the same means and variances in the port, and
    the port's artifact loads in JAX with the same params."""
    X, y, Z, _, fam, jp, k = _problem(name)
    Xs = np.random.default_rng(9).standard_normal((15, D))
    jtr = jst.streaming_trained(fam, jp, jnp.asarray(Z), S2, jnp.asarray(X),
                                jnp.asarray(y), block_size=32)
    art = jckpt.artifact_from_trained(fam, jtr, kernel_params=jp)
    path = str(tmp_path / "jax.npz")
    jckpt.save_model(path, art)
    tart, _ = tckpt.load_model(path)
    kernel, z, s2 = params_from_artifact(tart, device="cpu", dtype=F64)
    assert type(kernel) is type(k)
    args = (fam, art.kernel_params, jnp.asarray(art.inducing))
    _close(tst.predict_means_blocked(kernel, z, _t(art.coeffs), _t(Xs),
                                     block_size=8),
           jst.predict_means_blocked(*args, jnp.asarray(art.coeffs),
                                     jnp.asarray(Xs), block_size=8), 1e-12)
    _close(tst.predict_variances_blocked(kernel, z, _t(art.chol_km),
                                         _t(art.r_mat), _t(Xs), s2,
                                         block_size=8),
           jst.predict_variances_blocked(*args, jnp.asarray(art.chol_km),
                                         jnp.asarray(art.r_mat),
                                         jnp.asarray(Xs), S2, block_size=8),
           1e-12)
    tr = tst.streaming_trained(k, _t(Z), S2, _t(X), _t(y), block_size=32)
    back = str(tmp_path / "port.npz")
    tckpt.save_model(back, tckpt.artifact_from_trained(
        type(k), tr, kernel_params=k))
    jart, _ = jckpt.load_model(back)
    assert jart.family_name == name
    for field in type(k).param_names:
        _close(getattr(jart.kernel_params, field),
               getattr(jp, field), 0, field)
    _close(jart.coeffs, art.coeffs, 1e-10)
    kernel2, _, _ = from_jax_params(
        {f: np.asarray(getattr(jp, f)) for f in type(k).param_names}, Z, S2,
        device="cpu", dtype=F64, family=name)
    assert type(kernel2) is type(k)


@pytest.mark.parametrize("structural", ["sum(se_iso,lin_ard)",
                                        "prod(se_ard,cosine)", "sm2"])
def test_combinators_not_ported(structural):
    """The structural names the port once refused now resolve to their
    family, whose name round-trips and equals JAX's; ``sm2``, the CLI's
    shorthand, is ``sm_family(2)``."""
    if structural == "sm2":
        family, jfamily = tk.sm_family(2), jk.sm_family(2)
    else:
        family, jfamily = (tk.resolve_family(structural),
                           jk.resolve_family(structural))
        assert family.name == structural
    assert family.name == jfamily.name
    assert tk.resolve_family(family.name) is family
