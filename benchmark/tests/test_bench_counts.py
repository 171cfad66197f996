"""The yardstick's counts against hand values at bench.py's shape (n =
1,000,000, d = 8, m = 300)."""

import pytest

import counts

N, D, M = 1_000_000, 8, 300


def test_stats_bound_hand_value():
    b = counts.stats_bound(N, D, M)
    # 2 n (m d + m (m + 1) + m) = 2e6 (2,400 + 90,300 + 300)
    assert b["flops"] == pytest.approx(0.186e12, rel=1e-12)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e3 * 0.186e12 / 67e12)


def test_bwd_bound_hand_value():
    b = counts.bwd_bound(N, D, M)
    # 2 n (m d + 3 m (m + 1) / 2 + m^2 + m (d + 2))
    assert b["flops"] == pytest.approx(0.4617e12, rel=1e-12)
    assert b["bound_ms"] == pytest.approx(6.891, rel=1e-3)


def test_chain_bound_hand_value():
    b = counts.chain_bound(61 * 16_384, 300, 3)
    assert b["flops"] == pytest.approx(2 * 61 * 16_384 * 300 ** 2 * 3)


def test_bytes_bound_when_operations_are_few():
    b = counts.bound(1e9, 1e12)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(1e3 * 1e12 / 3.35e12)


def test_eval_flops():
    se = counts.eval_flops("se_iso", N, D, M)
    assert se == pytest.approx(counts.stats_bound(N, D, M)["flops"]
                               + counts.bwd_bound(N, D, M)["flops"]
                               + 6 * M ** 3)
    assert se == pytest.approx(0.648e12, rel=1e-3)
    fat = counts.eval_flops("se_fat", N, D, 1000, big_d=8)
    assert 7.0e12 < fat < 7.3e12
    with pytest.raises(ValueError):
        counts.eval_flops("matern52", N, D, M)


def test_clock_window_reads_samples():
    samples = [(1.0, 1980, 200.0), (2.0, 1755, 700.0), (9.0, 100, 1.0)]
    assert counts.clock_window(samples, 0.5, 2.5) == (
        "SM clock 1755-1980 MHz, power up to 700 W")
    assert counts.clock_window(samples, 3, 4) == "clock not sampled"
