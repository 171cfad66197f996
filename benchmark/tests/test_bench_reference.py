"""The plain reference against a tiny GP written in closed form with dense
matrices: the FITC covariance Q + diag(r + sigma2) built whole, its
log density, and the FITC predictive; the gradient against finite
differences; the TF32 rounding."""

import math

import pytest
import torch

import data
from reference import gp

BASE = {"n": 40, "d": 2, "m": 5, "variational": False, "dtype": "float64",
        "jitter": 1e-6, "jitter_f32_rel": 1e-5}
ISO = {**BASE, "family": "se_iso", "packed_fields": ["log_ell", "log_sf2"],
       "start": {"sigma2": 0.3, "log_sf2": 0.2, "log_ell": [0.1, 0.4]}}
FAT = {**BASE, "family": "se_fat", "d_proj": 2,
       "packed_fields": ["log_hetero_skedasticity", "log_multiscales_m05",
                         "log_sf2", "tproj"],
       "start": {"sigma2": 0.3, "log_sf2": 0.1,
                 "log_hetero_skedasticity": -3.0,
                 "log_multiscales_m05": -0.5}}


def _problem(cfg, seed=4):
    X, y = data.regression(cfg, seed, "cpu")
    hp = data.start(cfg, seed, 0, X)
    x = data.pack_vector(cfg, hp).double()
    x = x + 0.1 * torch.randn(x.shape, generator=torch.Generator()
                              .manual_seed(seed), dtype=torch.float64)
    return X.double(), y.double(), x


def _dense(cfg, x, X):
    """(Q + diag(r) , diag(r)) of the FITC prior, built whole."""
    hp = gp.unpack(cfg, x)
    prec = gp.Precision("f64")
    knm = gp.k_cross(cfg["family"], hp, X, prec)
    kj = gp.jittered(cfg, gp.k_upper(cfg["family"], hp))
    q = knm @ torch.linalg.solve(kj, knm.T)
    r = torch.exp(hp["log_sf2"]) - torch.diagonal(q)
    return q, r, hp


@pytest.mark.parametrize("cfg", [ISO, FAT], ids=["se_iso", "se_fat"])
@pytest.mark.parametrize("variational", [False, True])
def test_evidence_closed_form(cfg, variational):
    cfg = {**cfg, "variational": variational}
    X, y, x = _problem(cfg)
    q, r, hp = _dense(cfg, x, X)
    s = r + hp["sigma2"]
    cov = q + torch.diag(s)
    n = X.shape[0]
    l = -0.5 * (y @ torch.linalg.solve(cov, y) + torch.logdet(cov)
                + n * math.log(2 * math.pi))
    if variational:
        l = l - 0.5 * torch.sum(r / s)
    f, g = gp.neg_mean_evidence(cfg, x, X, y, block=7)
    assert float(f) == pytest.approx(float(-l / n), rel=1e-10)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("cfg", [ISO, FAT], ids=["se_iso", "se_fat"])
def test_gradient_finite_differences(cfg):
    X, y, x = _problem(cfg)
    _, g = gp.neg_mean_evidence(cfg, x, X, y, block=16)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        v = torch.randn(x.shape, generator=gen, dtype=torch.float64)
        h = 1e-5
        fp = gp.neg_mean_evidence(cfg, x + h * v, X, y, grad=False)[0]
        fm = gp.neg_mean_evidence(cfg, x - h * v, X, y, grad=False)[0]
        assert float((fp - fm) / (2 * h)) == pytest.approx(
            float(g @ v), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("cfg", [ISO, FAT], ids=["se_iso", "se_fat"])
def test_predictors_closed_form(cfg):
    X, y, x = _problem(cfg)
    q, r, hp = _dense(cfg, x, X)
    cov = q + torch.diag(r + hp["sigma2"])
    Xt = torch.randn((9, X.shape[1]), generator=torch.Generator()
                     .manual_seed(2), dtype=torch.float64)
    prec = gp.Precision("f64")
    ktm = gp.k_cross(cfg["family"], hp, Xt, prec)
    knm = gp.k_cross(cfg["family"], hp, X, prec)
    kj = gp.jittered(cfg, gp.k_upper(cfg["family"], hp))
    qtn = ktm @ torch.linalg.solve(kj, knm.T)
    mean = qtn @ torch.linalg.solve(cov, y)
    # the FITC latent posterior in the dense form:
    # k** - Q*n (Q + diag(r + sigma2))^-1 Qn*
    var = torch.exp(hp["log_sf2"]) - torch.sum(
        qtn * torch.linalg.solve(cov, qtn.T).T, dim=1)
    post = gp.condition(cfg, x, X, y, block=6)
    mr, vr = gp.predict(post, Xt, block=4)
    assert torch.allclose(mr, mean, rtol=1e-9, atol=1e-12)
    assert torch.allclose(vr, var, rtol=1e-9, atol=1e-12)


def test_round_tf32():
    t = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -2.5,
                      3.0e-30, 1.0 + 2.0**-10], dtype=torch.float32)
    r = gp.round_tf32(t)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie to even
    assert r[2] == 1.0 + 2.0**-9  # above the tie
    assert r[3] == -2.5 and r[5] == 1.0 + 2.0**-10
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def test_tf32_control_is_further_than_f32():
    cfg = {**ISO, "n": 4000, "d": 8, "m": 30}
    X, y, x = _problem(cfg)
    f64, g64 = gp.neg_mean_evidence(cfg, x, X, y)
    f32, g32 = gp.neg_mean_evidence(cfg, x, X, y, precision="f32")
    ftf, gtf = gp.neg_mean_evidence(cfg, x, X, y, precision="tf32")
    e32 = float(torch.linalg.norm(g32.double() - g64))
    etf = float(torch.linalg.norm(gtf.double() - g64))
    assert etf > 10 * e32
