"""The port's warped GP (models/warped.py) == gpr_tpu's, in f64 on the CPU.

The same numpy draw goes through ``gpr_tpu.models.warped`` and the port:
the warp, its derivative and its inverse; the warped evidence (FITC and
variational, SE-iso on the streaming custom VJP and rq) with every gradient
group, the warp's included, at rtol 1e-10; the median, quantile, mean and
moments predictors; ``make_warped_pack``'s vector (JAX's layout, so a JAX
vector converts unchanged) and ``fit_warped``'s iterates.  JAX's warp
leaves carry over by ``convert.warp_from_jax`` and the artifact extras.  On
the card (``cuda``) the SE-iso f32 value and gradient launch the forward
and the backward statistics kernels once each, and the warp's gradient,
which rests on the backward kernel's y cotangent, matches the plain loop's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import warped as jwarped
from gpr_tpu.optim import make_pack as jmake_pack
from gpr_tpu_torch.convert import warp_from_jax
from gpr_tpu_torch.io.checkpoint import warp_extras
from gpr_tpu_torch.kernels import RatQuad, SeIso
from gpr_tpu_torch.kernels.base import hyper_leaves
from gpr_tpu_torch.models import warped as twarped
from gpr_tpu_torch.optim import make_pack
from torch_ext import F64, close, cuda_device, t  # noqa: F401

SIGMA2 = 0.3
LEAVES = {"log_a": [0.0, -0.5], "log_b": [0.3, -0.2], "c": [0.4, -0.7]}
FIELDS = {"se_iso": {"log_ell": 0.2, "log_sf2": 0.1},
          "rq": {"log_ell": 0.2, "log_sf2": 0.1, "log_alpha": -0.3}}


def _data(n=90, m=5, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    Z = rng.standard_normal((m, d))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    return X, Z, y


def _warps(device="cpu", dtype=F64):
    jwp = jwarped.WarpParams(**{k: jnp.asarray(v) for k, v in LEAVES.items()})
    return jwp, warp_from_jax(jwp, device=device, dtype=dtype)


def test_warp_and_inverse_match_jax():
    jwp, wp = _warps()
    y = np.sort(np.random.default_rng(1).standard_normal(50) * 3)
    tw = twarped.warp(wp, t(y))
    close(tw, jwarped.warp(jwp, jnp.asarray(y)), name="warp")
    close(twarped.warp_deriv(wp, t(y)), jwarped.warp_deriv(jwp,
                                                           jnp.asarray(y)))
    close(twarped.warp_inv(wp, tw.detach()), jwarped.warp_inv(
        jwp, jnp.asarray(tw.detach().numpy())), name="warp_inv")
    close(twarped.warp_inv(wp, tw.detach()), y, rtol=1e-12)


@pytest.mark.parametrize("variational", [False, True], ids=["fitc", "var"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_value_and_grads_match_jax(name, variational):
    X, Z, y = _data()
    fam = jk.FAMILIES[name]
    jp = fam.Params(**{k: jnp.asarray(v) for k, v in FIELDS[name].items()})
    jwp, wp = _warps()
    jval, jg = jax.value_and_grad(
        lambda p, w, z, s2: jwarped.warped_log_evidence(
            fam, p, w, z, s2, jnp.asarray(X), jnp.asarray(y),
            variational=variational, block_size=32),
        argnums=(0, 1, 2, 3))(jp, jwp, jnp.asarray(Z), jnp.asarray(SIGMA2))
    k = (SeIso if name == "se_iso" else RatQuad)(**FIELDS[name],
                                                 device="cpu", dtype=F64)
    z, s2 = t(Z).requires_grad_(True), t(SIGMA2).requires_grad_(True)
    val = twarped.warped_log_evidence(k, wp, z, s2, t(X), t(y),
                                      variational=variational, block_size=32)
    names, hypers = hyper_leaves(k)
    warp_leaves = [getattr(wp, f) for f in twarped.WARP_FIELDS]
    grads = torch.autograd.grad(val, (*hypers, *warp_leaves, z, s2))
    close(val, jval, name="value")
    for field, g in zip(names, grads):
        close(g, getattr(jg[0], field), name=field)
    for field, g in zip(twarped.WARP_FIELDS, grads[len(names):]):
        close(g, getattr(jg[1], field), name=field)
    close(grads[-2], jg[2], name="z")
    close(grads[-1], jg[3], name="sigma2")


def test_predictors_match_jax():
    jwp, wp = _warps()
    rng = np.random.default_rng(2)
    mu, var = rng.standard_normal(12), 0.1 + rng.random(12)
    jmu, jvar = jnp.asarray(mu), jnp.asarray(var)
    close(twarped.warped_predict_median(wp, t(mu)),
          jwarped.warped_predict_median(jwp, jmu), name="median")
    for q in (0.025, 0.975):
        close(twarped.warped_predict_quantile(wp, t(mu), t(var), q),
              jwarped.warped_predict_quantile(jwp, jmu, jvar, q),
              name=f"quantile {q}")
    close(twarped.warped_predict_mean(wp, t(mu), t(var)),
          jwarped.warped_predict_mean(jwp, jmu, jvar), name="mean")
    for got, want in zip(twarped.warped_predict_moments(wp, t(mu), t(var)),
                         jwarped.warped_predict_moments(jwp, jmu, jvar)):
        close(got, want, name="moments")


def test_pack_and_fit_match_jax():
    X, Z, y = _data(n=60)
    jp = jk.SeIso.Params(log_ell=jnp.asarray(0.2), log_sf2=jnp.asarray(0.1))
    jwp0 = jwarped.default_warp_params(3)
    jpack_w, jun = jwarped.make_warped_pack(
        jmake_pack(jk.SeIso, jp, jnp.asarray(Z), 0.5), jwp0)
    pack = make_pack(SeIso(0.2, 0.1, device="cpu", dtype=F64), t(Z), 0.5)
    wp0 = twarped.default_warp_params(3, device="cpu")
    pack_w, unpack_w = twarped.make_warped_pack(pack, wp0)
    close(pack_w.x0, jpack_w.x0, rtol=0, name="x0")
    assert pack_w.n_hypers == jpack_w.n_hypers
    _, _, _, wp = unpack_w(pack_w.x0)
    for f in twarped.WARP_FIELDS:
        close(getattr(wp, f), getattr(jun(jpack_w.x0)[3], f), rtol=0)
    *_, jwp, jst = jwarped.fit_warped(jk.SeIso, jnp.asarray(X),
                                      jnp.asarray(y),
                                      jmake_pack(jk.SeIso, jp,
                                                 jnp.asarray(Z), 0.5),
                                      jwp0, variational=True, block_size=16,
                                      max_iter=4)
    *_, wp, st = twarped.fit_warped(t(X), t(y), pack, wp0, variational=True,
                                    block_size=16, max_iter=4)
    close(st.x, jst.x, rtol=1e-8, name="x")
    assert (st.n_iter, st.n_evals) == (int(jst.n_iter), int(jst.n_evals))
    # the artifact extras carry the warp across, both ways
    extras = warp_extras(wp)
    assert sorted(extras) == ["warp_c", "warp_log_a", "warp_log_b"]
    back = warp_from_jax({f: extras[f"warp_{f}"] for f in
                          twarped.WARP_FIELDS}, device="cpu", dtype=F64)
    for f in twarped.WARP_FIELDS:
        close(getattr(back, f), getattr(jwp, f), rtol=1e-8, name=f)


def _value_and_grads(dev, dtype, X, Z, y, impl):
    """The SE-iso warped evidence and its gradient groups on ``dev``."""
    k = SeIso(0.2, 0.1, device=dev, dtype=dtype)
    wp = twarped.WarpParams(*(LEAVES[f] for f in twarped.WARP_FIELDS),
                            device=dev, dtype=dtype)
    z = t(Z, dtype, dev).requires_grad_(True)
    val = twarped.warped_log_evidence(k, wp, z, 0.3, t(X, dtype, dev),
                                      t(y, dtype, dev), block_size=1024,
                                      jitter=1e-6, impl=impl)
    grads = torch.autograd.grad(
        val, (k.log_ell, k.log_sf2, wp.log_a, wp.log_b, wp.c, z))
    return val.detach(), grads


@pytest.mark.cuda
def test_kernel_path_launches_and_matches_loop(cuda_device):
    from gpr_tpu_torch.ops import fused_stats

    X, Z, y = _data(n=20_000, m=64, d=8)
    fwd = fused_stats.se_iso_stream_stats_fused_acc
    bwd = fused_stats.se_iso_stream_bwd_fused
    fwd.launches = bwd.launches = 0
    val, grads = _value_and_grads(cuda_device, torch.float32, X, Z, y, None)
    assert (fwd.launches, bwd.launches) == (1, 1)
    want_val, want = _value_and_grads(cuda_device, torch.float64, X, Z, y,
                                      "reference")
    assert abs(float(val) - float(want_val)) <= 2e-5 * abs(float(want_val))
    for g, w in zip(grads, want):
        err = float(torch.linalg.norm(g.double() - w)
                    / torch.linalg.norm(w))
        assert err <= 1e-3, err
