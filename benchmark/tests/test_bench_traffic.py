"""The inputs drawn from a seed: the same seed gives the same inputs, two
seeds give different ones, and seeds past 32 bits work."""

import pytest
import torch

import data
from drivers import serve

CFG = {"name": "t", "family": "se_iso", "n": 500, "d": 3, "m": 9,
       "packed_fields": ["log_ell", "log_sf2"],
       "start": {"sigma2": 1.0, "log_sf2": 0.0, "log_ell": [0.3, 0.7]}}
FAT = {**CFG, "family": "se_fat", "d_proj": 3,
       "packed_fields": ["log_hetero_skedasticity", "log_multiscales_m05",
                         "log_sf2", "tproj"],
       "start": {"sigma2": 1.0, "log_sf2": 0.1,
                 "log_hetero_skedasticity": -5.0,
                 "log_multiscales_m05": 0.0}}
TRAFFIC = {"points": [16, 4096], "pool_points": 5000, "max_requests": 300,
           "check_rate": 0.1}
SEEDS = (0, 12345, 2**31 + 17, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_regression_repeats(seed):
    a, b = data.regression(CFG, seed, "cpu"), data.regression(CFG, seed,
                                                              "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = data.regression(CFG, seed + 1, "cpu")
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("cfg", [CFG, FAT], ids=["se_iso", "se_fat"])
def test_starts_repeat_and_differ(cfg):
    X, _ = data.regression(cfg, 5, "cpu")
    s0, s1 = data.start(cfg, 5, 0, X), data.start(cfg, 5, 0, X)
    s2 = data.start(cfg, 5, 1, X)
    v0, v1, v2 = (data.pack_vector(cfg, s) for s in (s0, s1, s2))
    assert torch.equal(v0, v1) and not torch.equal(v0, v2)
    lo, hi = cfg["start"].get("log_ell", (None, None))
    if lo is not None:
        assert lo <= s0["log_ell"] <= hi


def test_inducing_rows_are_distinct():
    idx = data.inducing_rows(3, 1000, 300, "fit", 0)
    assert len(set(idx.tolist())) == 300


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_repeat(seed):
    pool_a, reqs_a = serve.requests(CFG, TRAFFIC, seed, "cpu")
    pool_b, reqs_b = serve.requests(CFG, TRAFFIC, seed, "cpu")
    assert torch.equal(pool_a, pool_b) and reqs_a == reqs_b
    _, reqs_c = serve.requests(CFG, TRAFFIC, seed + 1, "cpu")
    assert reqs_a != reqs_c
    for off, size, _ in reqs_a:
        assert 16 <= size <= 4096 and 0 <= off <= 5000 - size


def test_request_sizes_are_log_uniform():
    sizes = data.request_sizes({"points": [4096, 262144]}, 9, 20000)
    logs = torch.log(torch.tensor(sizes, dtype=torch.float64))
    mid = (torch.log(torch.tensor(4096.0)) + torch.log(
        torch.tensor(262144.0))) / 2
    assert abs(float(torch.mean((logs < mid).double())) - 0.5) < 0.02


def test_stream_seeds_differ():
    assert data.stream_seed(1, "a") != data.stream_seed(1, "b")
    assert data.stream_seed(1, "a") != data.stream_seed(2, "a")
    assert 0 <= data.stream_seed(2**63, "x") < 2**63
