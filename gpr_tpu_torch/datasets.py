"""Synthetic benchmark data: the counterpart of ``gpr_tpu/datasets.py``
(the reference's test/gen_data.ml), kept as the port's own numpy copy.

The reference's end-to-end demo function (test/gen_data.ml:28-34):
    f(x) = sin(3x)/x + |x - 3| / (x^2 + 1)   on [-5, 5]
with noise sigma = 0.7, n = 1000 training points, m = 10 inducing.
"""

from __future__ import annotations

import numpy as np


def gen_data_fn(x: np.ndarray) -> np.ndarray:
    """The reference's noise-free target (test/gen_data.ml:28-34); the
    sin(3x)/x singularity at 0 resolves to 3 by continuity."""
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(x == 0.0, 3.0, np.sin(3.0 * x) / x)
    return s + np.abs(x - 3.0) / (x * x + 1.0)


def gen_data(seed: int = 0, n: int = 1000, noise_sigma: float = 0.7,
             lo: float = -5.0, hi: float = 5.0):
    """(X (n,1), y (n,), f (n,)) numpy arrays sampled like
    test/gen_data.ml:36-44; ``torch.as_tensor`` puts them on a device."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(lo, hi, n))
    f = gen_data_fn(x)
    y = f + noise_sigma * rng.standard_normal(n)
    return x[:, None], y, f
