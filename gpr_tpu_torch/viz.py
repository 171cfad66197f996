"""Graphical fit visualization — the rebuild of test/display.R, the port's
own copy of ``gpr_tpu/viz.py`` (numpy and matplotlib only; matplotlib is
imported when a plot is drawn).

The reference ships an R script that plots the save_data artifact set: data
scatter, the true function with its noise band, the posterior mean with
analytic and predictive 95% bands, posterior samples (FITC and FIC flavors),
and the inducing points with their own predictive intervals
(test/display.R:43-75; gpr_manual.tex:396-412).  This module renders the
same picture with matplotlib from in-memory arrays or from an artifact
directory written by examples/demo_fitc.py.

Design notes: one axis; series hues are assigned by entity in a fixed,
colorblind-validated categorical order (posterior=blue, truth=orange,
samples=aqua, inducing=yellow, FIC samples=magenta); data points and bands
are recessive grays/alpha so the means stay the foreground.
"""

from __future__ import annotations

import numpy as np

# fixed categorical order (validated palette; identity never rank)
C_POSTERIOR = "#2a78d6"  # blue: posterior mean + bands
C_TRUTH = "#eb6834"  # orange: true function + noise band
C_SAMPLE = "#1baf7a"  # aqua: FITC posterior samples
C_INDUCING = "#eda100"  # yellow: inducing points
C_FIC = "#e87ba4"  # magenta: FIC samples
C_DATA = "#52514e"  # secondary ink: observations
SURFACE = "#fcfcfb"

T95 = 1.959963984540054  # qnorm(1 - 0.05/2) as in display.R:38


def plot_fit(
    x,
    y,
    means,
    variances,
    sigma2,
    *,
    true_fn=None,
    inducing=None,
    inducing_means=None,
    inducing_variances=None,
    samples=None,
    fic_samples=None,
    ax=None,
    title="sparse GP fit",
):
    """Render the display.R picture; returns the matplotlib Axes.

    ``x`` (n,) 1-D inputs, ``y`` (n,) targets, ``means``/``variances`` the
    posterior at x (non-predictive), ``sigma2`` the noise level.  Optional:
    ``true_fn`` callable, inducing locations (+ their means/variances),
    posterior ``samples``/``fic_samples`` (k, n).
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(9, 5.5))
    ax.set_facecolor(SURFACE)
    x = np.asarray(x).reshape(-1)
    order = np.argsort(x)
    xs = x[order]
    mu = np.asarray(means).reshape(-1)[order]
    sd = np.sqrt(np.asarray(variances).reshape(-1)[order])
    psd = np.sqrt(np.asarray(variances).reshape(-1)[order] + float(sigma2))

    ax.scatter(x, np.asarray(y), s=8, color=C_DATA, alpha=0.45, linewidths=0,
               label="data", zorder=2)

    if true_fn is not None:
        ft = true_fn(xs)
        ax.plot(xs, ft, color=C_TRUTH, lw=2, label="true f", zorder=4)
        ns = np.sqrt(float(sigma2))
        ax.plot(xs, ft + T95 * ns, color=C_TRUTH, lw=1, ls=":", zorder=3)
        ax.plot(xs, ft - T95 * ns, color=C_TRUTH, lw=1, ls=":", zorder=3)

    def _rows_of_samples(arr):
        # accept (n, k) draws (cov_sample's native layout) or (k, n); a
        # square array is read as (points, draws)
        arr = np.atleast_2d(np.asarray(arr))
        if arr.shape[0] == len(xs):
            arr = arr.T
        return arr[:3]

    if samples is not None:
        for k, s in enumerate(_rows_of_samples(samples)):
            ax.plot(xs, s[order], color=C_SAMPLE, lw=1, alpha=0.7,
                    label="posterior samples" if k == 0 else None, zorder=3)
    if fic_samples is not None:
        for k, s in enumerate(_rows_of_samples(fic_samples)):
            ax.plot(xs, s[order], color=C_FIC, lw=1, alpha=0.7,
                    label="FIC samples" if k == 0 else None, zorder=3)

    ax.fill_between(xs, mu - T95 * sd, mu + T95 * sd, color=C_POSTERIOR,
                    alpha=0.15, linewidth=0, label="95% (latent)", zorder=1)
    ax.plot(xs, mu + T95 * psd, color=C_POSTERIOR, lw=1, ls="--", zorder=4,
            label="95% (predictive)")
    ax.plot(xs, mu - T95 * psd, color=C_POSTERIOR, lw=1, ls="--", zorder=4)
    ax.plot(xs, mu, color=C_POSTERIOR, lw=2, label="posterior mean", zorder=5)

    if inducing is not None:
        zi = np.asarray(inducing).reshape(-1)
        if inducing_means is not None:
            zm = np.asarray(inducing_means).reshape(-1)
        else:
            zm = np.interp(zi, xs, mu)
        ax.scatter(zi, zm, s=55, color=C_INDUCING, edgecolors="white",
                   linewidths=1.2, label="inducing", zorder=6)
        if inducing_variances is not None:
            zsd = np.sqrt(np.asarray(inducing_variances).reshape(-1)
                          + float(sigma2))
            ax.errorbar(zi, zm, yerr=T95 * zsd, fmt="none",
                        ecolor=C_INDUCING, elinewidth=1.2, capsize=3,
                        zorder=6)

    ax.set_title(title, color="#0b0b0b")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.grid(True, color="#e8e7e3", lw=0.6, zorder=0)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    ax.legend(loc="best", frameon=False, fontsize=8)
    return ax


def plot_artifacts(artifact_dir: str, out_path: str | None = None):
    """Render the artifact directory examples/demo_fitc.py writes (the
    save_data.ml set) — the drop-in replacement for `R -f display.R`."""
    import os

    from .datasets import gen_data_fn

    def load(name, required=False):
        p = os.path.join(artifact_dir, name)
        if not os.path.exists(p):
            if required:
                raise FileNotFoundError(
                    f"artifact {name!r} missing from {artifact_dir}"
                )
            return None
        return np.loadtxt(p)

    x = load("inputs", required=True)
    ax = plot_fit(
        x if x.ndim == 1 else x[:, 0],
        load("targets", required=True),
        load("means", required=True),
        load("variances", required=True),
        float(load("sigma2", required=True)),
        true_fn=gen_data_fn,
        inducing=load("inducing_points"),
        inducing_means=load("inducing_means"),
        inducing_variances=load("inducing_variances"),
        samples=load("fitc_samples"),
        fic_samples=load("fic_samples"),
        title="FITC fit (reference synthetic benchmark)",
    )
    if out_path:
        ax.figure.savefig(out_path, dpi=130, bbox_inches="tight")
    return ax
