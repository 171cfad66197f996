"""The port's FITC LOO == gpr_tpu's, in f64 on the CPU.

``loo_posterior``, ``loo_log_likelihood`` and the gradient of
``loo_objective`` at 1e-10; ``fit(objective="loo")`` walks the JAX
iterates (the same counts, x within 1e-8); LOO with a streaming block size
is refused as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.kernels import SeIso as JSeIso
from gpr_tpu.models import fitc as jfitc
from gpr_tpu.models import loo as jloo
from gpr_tpu.optim import lbfgs_device as jlb
from gpr_tpu.optim import make_pack as j_make_pack
from gpr_tpu_torch.convert import from_jax_params
from gpr_tpu_torch.models import (
    calc_model,
    calc_trained,
    loo_log_likelihood_fitc,
    loo_objective_fitc,
    loo_posterior_fitc,
)
from gpr_tpu_torch.optim import fit, make_pack

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _gp(n=160, d=2, m=7, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.cos(X @ np.array([0.9, -0.4])) + 0.2 * rng.standard_normal(n)
    return X, y, X[:m].copy()


@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_loo_posterior_value_and_gradient_match_jax(factorization):
    X, y, Z = _gp()
    params = {"log_ell": 0.1, "log_sf2": -0.2}
    jp = JSeIso.Params(**{k: jnp.asarray(v) for k, v in params.items()})
    jtr = jax.jit(lambda p: jfitc.calc_trained(
        jfitc.calc_model(JSeIso, p, jnp.asarray(X), jnp.asarray(Z), 0.2,
                         factorization=factorization), jnp.asarray(y)))(jp)
    kernel, z, s2 = from_jax_params(params, Z, 0.2, device="cpu", dtype=F64)
    tr = calc_trained(calc_model(kernel, _t(X), z, s2,
                                 factorization=factorization), _t(y))
    for got, want in zip(loo_posterior_fitc(tr), jloo.loo_posterior(jtr)):
        _close(got.detach(), want)
    _close(loo_log_likelihood_fitc(tr).detach(),
           jloo.loo_log_likelihood(jtr))

    def jvalue(args):
        p, zz, ss = args
        return jloo.loo_objective(JSeIso, p, zz, ss, jnp.asarray(X),
                                  jnp.asarray(y), factorization=factorization)

    jargs = (jp, jnp.asarray(Z), jnp.asarray(0.2))
    jv, (jgp, jgz, jgs) = jax.jit(jax.value_and_grad(jvalue))(jargs)
    z.requires_grad_(True)
    s2.requires_grad_(True)
    value = loo_objective_fitc(kernel, z, s2, _t(X), _t(y),
                               factorization=factorization)
    value.backward()
    _close(value.detach(), jv)
    _close(kernel.log_ell.grad, jgp.log_ell)
    _close(kernel.log_sf2.grad, jgp.log_sf2)
    _close(z.grad, jgz)
    _close(s2.grad, jgs)


def _packs(Z):
    jp = JSeIso.Params(log_ell=jnp.asarray(0.3), log_sf2=jnp.asarray(0.0))
    jpack = j_make_pack(JSeIso, jp, jnp.asarray(Z), 1.0)
    kernel, z, _ = from_jax_params({"log_ell": 0.3, "log_sf2": 0.0}, Z, 1.0,
                                   device="cpu", dtype=F64)
    return jpack, make_pack(kernel, z, 1.0)


def test_fit_loo_matches_jax():
    X, y, Z = _gp()
    jpack, pack = _packs(Z)
    kw = dict(objective="loo", epsabs=1e-6, max_iter=15, dispatch_iters=6)
    *_, jst = jlb.fit(JSeIso, jnp.asarray(X), jnp.asarray(y), jpack, **kw)
    *_, st = fit(_t(X), _t(y), pack, **kw)
    assert (st.n_iter, st.n_evals, st.failed) == (
        int(jst.n_iter), int(jst.n_evals), bool(jst.failed))
    assert st.n_iter >= 8
    _close(st.x, jst.x, rtol=1e-8)
    _close(st.f, jst.f)

    def loo(x):
        kernel, z, s2 = pack.unpack(x)
        return float(loo_objective_fitc(kernel, z, s2, _t(X), _t(y)))

    assert loo(st.x) > loo(pack.x0)


def test_loo_refuses_streaming():
    X, y, Z = _gp(n=40)
    jpack, pack = _packs(Z)
    with pytest.raises(ValueError, match="streaming_block_size"):
        jlb.fit(JSeIso, jnp.asarray(X), jnp.asarray(y), jpack,
                objective="loo", streaming_block_size=16)
    with pytest.raises(ValueError, match="streaming_block_size"):
        fit(_t(X), _t(y), pack, objective="loo", streaming_block_size=16)
