"""Inputs made from ``--seed``: the regression data, the inducing rows,
the fits' starting points and the serving requests.  Everything is drawn
by ``torch.Generator``s on the data's device, in a few large calls, from
streams that a seed and a name fix, so the same seed gives the same inputs
and the program and the reference are handed the same tensors.

The data follow bench.py's target recipe (``bench.py:281-289`` draws X
standard normal; ``chip_smoke.bench_targets``): y = sin(X w) + 0.3 eps
with w_k = 0.3 k + 0.2.
"""

from __future__ import annotations

import hashlib
import math

import torch


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for the named stream of ``seed``: seeds of any size,
    and streams that never overlap."""
    key = ":".join(str(v) for v in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(seed: int, *names, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *names))


def regression(cfg: dict, seed: int, device, *, n: int | None = None):
    """(X, y) in f32 on ``device``: X (n, d) standard normal, y = sin(X w)
    + 0.3 eps (the product taken elementwise, so no TF32 setting can touch
    it)."""
    n = cfg["n"] if n is None else n
    d = cfg["d"]
    g = generator(seed, "data", device=device)
    X = torch.randn((n, d), generator=g, device=device, dtype=torch.float32)
    eps = torch.randn((n,), generator=g, device=device, dtype=torch.float32)
    w = torch.arange(d, device=device, dtype=torch.float32) * 0.3 + 0.2
    y = torch.sin(torch.sum(X * w, dim=1)) + 0.3 * eps
    return X, y


def inducing_rows(seed: int, n: int, m: int, *names, device="cpu"):
    """m distinct row indices of n: the head of a seeded permutation."""
    g = generator(seed, "rows", *names, device=device)
    return torch.randperm(n, generator=g, device=device)[:m]


def uniform(seed: int, lo: float, hi: float, *names) -> float:
    """One number uniform in [lo, hi] from the named stream."""
    g = generator(seed, "uniform", *names)
    return lo + (hi - lo) * float(torch.rand((), generator=g,
                                             dtype=torch.float64))


def start(cfg: dict, seed: int, fit: int, X) -> dict:
    """Fit number ``fit``'s starting point: the hypers of the config's
    ``start`` block, log_ell drawn in its interval, Z as m rows of X.
    se_fat's projection is drawn N(0, 1) / D, and Z lives in the projected
    space.  Values are on X's device in f32."""
    st = cfg["start"]
    m, d = cfg["m"], cfg["d"]
    dev = X.device
    idx = inducing_rows(seed, X.shape[0], m, "fit", fit, device=dev)
    out = {"sigma2": float(st["sigma2"]),
           "log_sf2": float(st["log_sf2"])}
    if cfg["family"] == "se_iso":
        lo, hi = st["log_ell"]
        out["log_ell"] = uniform(seed, lo, hi, "log_ell", fit)
        out["z"] = X[idx].clone()
    elif cfg["family"] == "se_fat":
        g = generator(seed, "tproj", fit, device=dev)
        dz = cfg["d_proj"]
        out["tproj"] = torch.randn((d, dz), generator=g, device=dev,
                                   dtype=torch.float32) / d
        out["log_hetero_skedasticity"] = torch.full(
            (m,), float(st["log_hetero_skedasticity"]), device=dev)
        out["log_multiscales_m05"] = torch.full(
            (m, dz), float(st["log_multiscales_m05"]), device=dev)
        out["z"] = torch.sum(X[idx][:, :, None] * out["tproj"][None], dim=1)
    else:
        raise ValueError(f"no starts for the family {cfg['family']!r}")
    return out


def pack_vector(cfg: dict, hp: dict) -> torch.Tensor:
    """The packed hyper vector of ``hp`` in the program's documented
    layout (``optim/pack.py``): log sigma2, then the family's hyper fields
    in sorted name order, each flattened row-major, then z."""
    names = cfg["packed_fields"]
    dev = hp["z"].device
    parts = [torch.tensor([math.log(hp["sigma2"])], device=dev)]
    for name in names:
        parts.append(torch.as_tensor(hp[name], dtype=torch.float32,
                                     device=dev).reshape(-1))
    parts.append(hp["z"].reshape(-1))
    return torch.cat([p.to(torch.float32) for p in parts])


def request_sizes(traffic: dict, seed: int, count: int) -> list[int]:
    """``count`` request sizes, log-uniform in the traffic's interval."""
    lo, hi = traffic["points"]
    g = generator(seed, "sizes")
    u = torch.rand((count,), generator=g, dtype=torch.float64)
    return [int(round(math.exp(math.log(lo) + float(v) * math.log(hi / lo))))
            for v in u]
