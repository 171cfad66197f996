"""Data-driven initialization of spectral-mixture kernels: the counterpart
of ``gpr_tpu/kernels/sm_init.py``, with the same numpy arithmetic, so that
its values are the JAX package's bit for bit.

A spectral mixture's evidence is multi-modal in frequency space, and the
published practice (Wilson & Adams 2013) initializes from the empirical
spectrum.  For scattered inputs, where an FFT does not apply, this takes a
classic periodogram on a per-dimension geometric frequency grid in
[f_min, f_nyq] and picks q frequencies proportional to spectral power
(Gumbel top-q with an exclusion window, so components land on distinct
peaks):

  f_nyq  = 1 / (2 * median nearest-neighbour spacing)
  f_min  = 1 / (2 * range)

Component j gets cosine.mu[d] = f_jd, se_ard.log_ells[d] from the peak
width sigma_s = max(f_jd / 4, f_min) (ell = 1 / (2 pi sigma_s)) and
se_ard.log_sf2 = log(var(y) / q).  One component is anchored at the window
floor with mu = 0: the smooth trend every decomposition needs.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_PI = 2.0 * np.pi


def _dim_scales(x: np.ndarray):
    """(f_min, f_nyq) for one input dimension from its empirical spacing."""
    xs = np.sort(np.unique(x))
    rng = float(xs[-1] - xs[0]) if xs.size > 1 else 1.0
    if rng <= 0.0:
        return 1e-3, 1.0
    if xs.size > 1:
        dx = float(np.median(np.diff(xs)))
    else:
        dx = rng
    f_nyq = 1.0 / (2.0 * max(dx, 1e-12))
    f_min = 1.0 / (2.0 * rng)
    return f_min, max(f_nyq, f_min * 2.0)


def _periodogram(x: np.ndarray, y: np.ndarray, freqs: np.ndarray):
    """Classic periodogram power at ``freqs`` for scattered 1-D inputs:
    P(f) = (sum y cos(2 pi f x))^2 + (sum y sin(2 pi f x))^2."""
    ang = _TWO_PI * np.outer(freqs, x)  # (n_f, n)
    c = np.cos(ang) @ y
    s = np.sin(ang) @ y
    return c * c + s * s


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def sm_spectrum(X, y, n_grid: int = 256):
    """Per-dimension (freqs, power) marginal periodograms: what
    ``sm_init_from_data`` samples from, for diagnostics and plots."""
    X = _host(X)
    y = _host(y)
    y = y - y.mean()
    out = []
    for d in range(X.shape[1]):
        f_min, f_nyq = _dim_scales(X[:, d])
        freqs = np.geomspace(f_min, f_nyq, n_grid)
        out.append((freqs, _periodogram(X[:, d], y, freqs)))
    return out


def sm_init_from_data(q: int, X, y, key=None, *, n_grid: int = 256,
                      device=None, dtype=None):
    """Empirical-spectrum init for ``sm_family(q)``: the kernel module (q =
    1: the single ``prod(se_ard,cosine)``).

    ``key`` None takes the top-q peaks deterministically; an int seeds the
    power-weighted draw (``np.random.default_rng(key)``, as the JAX package
    does); a ``torch.Generator`` gives that int seed, drawn from it.  The
    module lies on X's device in X's dtype when X is a tensor, else on
    ``device`` (default ``"cuda"``) in ``dtype`` (default float64).
    """
    from . import sm_family

    if q < 1:
        raise ValueError("sm_init_from_data needs q >= 1")
    if torch.is_tensor(X):
        device = X.device if device is None else device
        dtype = X.dtype if dtype is None else dtype
    device = "cuda" if device is None else device
    dtype = torch.float64 if dtype is None else dtype
    X = _host(X)
    if X.ndim == 1:
        X = X[:, None]
    yc = _host(y)
    yc = yc - yc.mean()
    n, dim = X.shape
    var_y = float(yc @ yc / max(n, 1)) or 1.0

    if key is None:
        rng = None
    elif isinstance(key, torch.Generator):
        seed = torch.randint(0, 2**31 - 1, (), generator=key,
                             device=key.device)
        rng = np.random.default_rng(int(seed))
    else:
        rng = np.random.default_rng(int(key))

    # per-dimension power-weighted frequency draws (q-1 spectral + 1 trend)
    n_spec = q - 1 if q > 1 else 1
    mus = np.zeros((q, dim))
    sig_s = np.zeros((q, dim))
    for d in range(dim):
        f_min, f_nyq = _dim_scales(X[:, d])
        freqs = np.geomspace(f_min, f_nyq, n_grid)
        power = _periodogram(X[:, d], yc, freqs)
        logp = np.log(power + 1e-12 * power.max() + 1e-300)
        if rng is not None:
            logp = logp + rng.gumbel(size=logp.shape)  # Gumbel top-q draw
        # greedy picks with an exclusion window so q components land on q
        # distinct spectral peaks, not adjacent bins of the strongest one
        w = max(n_grid // 32, 2)
        avail = logp.copy()
        top = []
        for _ in range(min(n_spec, n_grid)):
            i = int(np.argmax(avail))
            top.append(i)
            avail[max(0, i - w):i + w + 1] = -np.inf
        f_sel = freqs[np.sort(np.asarray(top))]
        if f_sel.size < n_spec:  # degenerate grid
            f_sel = np.resize(f_sel, n_spec)
        row0 = 1 if q > 1 else 0
        mus[row0:, d] = f_sel[: q - row0]
        sig_s[row0:, d] = np.maximum(f_sel[: q - row0] / 4.0, f_min)
        if q > 1:
            mus[0, d] = 0.0  # trend/DC component
            sig_s[0, d] = f_min

    log_w = np.log(var_y / q)
    fam = sm_family(q)
    comp = fam if q == 1 else fam.term_families[0]
    se_ard, cosine = comp.term_families
    kw = {"device": device, "dtype": dtype}
    terms = [comp(se_ard(np.log(1.0 / (_TWO_PI * sig_s[j])), log_w, **kw),
                  cosine(mus[j], **kw))
             for j in range(q)]
    return terms[0] if q == 1 else fam(*terms)
