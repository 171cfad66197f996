"""The port's online posterior (models/online.py) == gpr_tpu's, in f64 on the
CPU.

Batches of one numpy draw go through ``gpr_tpu.models.online`` and the
port, one of them streamed (``block_size``): the running statistics, the
evidence (FITC and variational) and the predictors' coefficients and
factor agree at rtol 1e-10.  The JAX tests' identities hold in the port:
update-then-downdate equals the batch evidence on the rows that remain, an
empty state is the prior, se_fat folds like SE-iso, and in f32 a dominant
batch added and removed leaves the survivors' evidence within JAX's 5e-4
of a direct f32 computation.  On the card (``cuda``) each streamed batch
of SE-iso f32 launches the forward-statistics kernel once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.models import online as jonline
from gpr_tpu_torch.kernels import SeFat, SeIso
from gpr_tpu_torch.models import fitc as tfitc
from gpr_tpu_torch.models import online as tonline
from gpr_tpu_torch.models import predict as tpredict
from torch_ext import F64, close as _close, cuda_device, t as _t  # noqa: F401

SIGMA2 = 0.3


def _data(n=400, d=3, m=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    Z = rng.standard_normal((m, d))
    return X, y, Z


JP = jk.SeIso.Params(log_ell=jnp.asarray(0.2), log_sf2=jnp.asarray(0.1))
BATCHES = ((0, 100, None), (100, 130, None), (130, 400, 64))


def _both(X, y, Z, batches=BATCHES, downdate=()):
    """(JAX state, port state) after the same updates and downdates."""
    k = SeIso(0.2, 0.1, device="cpu", dtype=F64)
    jst = jonline.online_init(jk.SeIso, JP, jnp.asarray(Z), SIGMA2)
    tst = tonline.online_init(k, _t(Z), SIGMA2)
    for sign, batches_ in ((1, batches), (-1, downdate)):
        for i0, i1, block in batches_:
            jfn, tfn = ((jonline.online_update, tonline.online_update)
                        if sign > 0 else
                        (jonline.online_downdate, tonline.online_downdate))
            jst = jfn(jk.SeIso, JP, jst, jnp.asarray(X[i0:i1]),
                      jnp.asarray(y[i0:i1]), block_size=block)
            tst = tfn(k, tst, _t(X[i0:i1]), _t(y[i0:i1]), block_size=block)
    return jst, tst, k


def test_updates_match_jax_and_batch():
    X, y, Z = _data()
    jst, tst, k = _both(X, y, Z)
    for f in dataclasses.fields(tst.stats):
        _close(getattr(tst.stats, f.name), getattr(jst.stats, f.name),
               name=f.name)
    for variational in (False, True):
        got = tonline.online_log_evidence(tst, variational=variational)
        _close(got, jonline.online_log_evidence(jst, variational=variational))
        batch = tfitc.log_evidence(k, _t(Z), SIGMA2, _t(X), _t(y),
                                   variational=variational,
                                   factorization="chol")
        _close(got, batch.detach(), rtol=1e-11)
    (mp, cvp), (jmp, jcvp) = (tonline.online_predictors(tst),
                              jonline.online_predictors(jst))
    _close(mp.coeffs, jmp.coeffs, name="coeffs")
    _close(cvp.r_mat, jcvp.r_mat, name="r_mat")
    Xs = _t(np.random.default_rng(7).standard_normal((50, 3)))
    trained = tfitc.calc_trained(tfitc.calc_model(
        k, _t(X), _t(Z), SIGMA2, factorization="chol"), _t(y))
    _close(tpredict.predict_means(k, mp, Xs),
           tpredict.predict_means(k, tpredict.mean_predictor(trained),
                                  Xs).detach(), rtol=1e-9)
    _close(tpredict.predict_variances(k, cvp, Xs, SIGMA2),
           tpredict.predict_variances(k, tpredict.co_variance_predictor(
               trained.model), Xs, SIGMA2).detach(), rtol=1e-9)


def test_downdate_removes_batch():
    X, y, Z = _data(n=300)
    batches = ((0, 200, None), (200, 300, 64))
    jst, tst, k = _both(X, y, Z, batches, downdate=(batches[1],))
    got = tonline.online_log_evidence(tst)
    _close(got, jonline.online_log_evidence(jst))
    ref = tfitc.log_evidence(k, _t(Z), SIGMA2, _t(X[:200]), _t(y[:200]),
                             factorization="chol")
    _close(got, ref.detach())
    assert float(tst.stats.n) == 200.0


def test_empty_state_is_prior():
    X, _, Z = _data()
    k = SeIso(0.2, 0.1, device="cpu", dtype=F64)
    mp, cvp = tonline.online_predictors(tonline.online_init(k, _t(Z),
                                                            SIGMA2))
    Xs = _t(X[:20])
    assert torch.all(tpredict.predict_means(k, mp, Xs) == 0.0)
    _close(tpredict.predict_variances(k, cvp, Xs, SIGMA2, predictive=False),
           k.k_diag(Xs).detach(), rtol=1e-9)


def test_se_fat_matches_batch():
    rng = np.random.default_rng(3)
    X, y = _t(rng.standard_normal((150, 4))), _t(rng.standard_normal(150))
    k = SeFat(4, 0.1, log_hetero_skedasticity=np.full(7, -3.0),
              device="cpu", dtype=F64)
    Z = k.inducing_from_inputs(X[:7])
    st = tonline.online_init(k, Z, 0.5)
    st = tonline.online_update(k, st, X[:80], y[:80])
    st = tonline.online_update(k, st, X[80:], y[80:], block_size=32)
    batch = tfitc.log_evidence(k, Z, 0.5, X, y, variational=True,
                               factorization="chol")
    _close(tonline.online_log_evidence(st, variational=True),
           batch.detach(), rtol=1e-11)


def _round_trip_f32(dev):
    """JAX's f32 round trip (tests/test_f32_paths.py): a batch 100x the
    targets' scale and 40x the rows, added and removed, on ``dev``."""
    rng = np.random.default_rng(0)
    d, m = 3, 10
    f32 = torch.float32
    X = _t(rng.standard_normal((50, d)), f32).to(dev)
    y = _t(np.sin(X.cpu().numpy().sum(1)), f32).to(dev)
    Z = _t(rng.standard_normal((m, d)), f32).to(dev)
    Xb = _t(rng.standard_normal((2000, d)), f32).to(dev)
    yb = _t(100.0 * rng.standard_normal(2000), f32).to(dev)
    k = SeIso(0.2, 0.1, device=dev, dtype=f32)
    st = tonline.online_init(k, Z, 0.3)
    st = tonline.online_update(k, st, X, y)
    st = tonline.online_update(k, st, Xb, yb, block_size=256)
    st = tonline.online_downdate(k, st, Xb, yb, block_size=256)
    got = float(tonline.online_log_evidence(st).detach())
    direct = float(tfitc.log_evidence(k, Z, 0.3, X, y,
                                      factorization="chol").detach())
    return got, direct, float(st.stats.n + st.stats_lo.n)


def test_f32_round_trip_within_jax_bound():
    got, direct, n = _round_trip_f32("cpu")
    assert abs(got - direct) < 5e-4 * abs(direct)
    assert n == 50.0


@pytest.mark.cuda
def test_streamed_batches_launch_the_kernel(cuda_device):
    """Each streamed SE-iso f32 batch on the card launches kernel #1 once,
    and the compensated round trip holds JAX's bound on its output."""
    from gpr_tpu_torch.ops import fused_stats

    fused_stats.se_iso_stream_stats_fused_acc.launches = 0
    got, direct, n = _round_trip_f32("cuda")
    assert fused_stats.se_iso_stream_stats_fused_acc.launches == 2
    assert abs(got - direct) < 5e-4 * abs(direct)
    assert n == 50.0
