"""The port's tooling modules (``testing.py``, ``utils.py``, ``viz.py``) on
the CPU in f64.

``check_deriv_hyper`` and ``self_test`` pass on the families of JAX's
tests/test_derivatives.py (carried over from JAX's params) and raise
``DerivMismatch`` on a kernel whose pullback drops a term;
``to_bf16_stochastic`` is unbiased and, on the same noise bits, bit-equal
to JAX's construction; the debug checks, the jsonl log, the profiler and
anomaly-mode contexts work; ``plot_fit`` and ``plot_artifacts`` mirror
tests/test_viz.py on the Agg backend.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu import utils as jutils
from gpr_tpu_torch import utils
from gpr_tpu_torch.config import config
from gpr_tpu_torch.kernels import SeIso
from gpr_tpu_torch.testing import DerivMismatch, check_deriv_hyper, self_test
from torch_composite import port_kernel
from torch_ext import F64, t
from torch_laplace import one_torch_thread  # noqa: F401  (autouse)

matplotlib.use("Agg")

SIGMA2 = 1.2
FAMILIES = ("const", "lin_one", "lin_ard", "se_iso", "se_fat")


def _data(name, n=10, d=3, m=5):
    """tests/test_derivatives.py's setup: se_fat with every option on, the
    others from JAX's default_params; the port's kernel at those hypers."""
    rng = np.random.default_rng(42)
    X = rng.standard_normal((n, d))
    fam = {"const": jk.Const, "lin_one": jk.LinOne, "lin_ard": jk.LinArd,
           "se_iso": jk.SeIso, "se_fat": jk.SeFat}[name]
    if name == "se_fat":
        jp = fam.Params(
            d=2, log_sf2=jnp.asarray(0.3),
            tproj=jnp.asarray(rng.standard_normal((d, 2))),
            log_hetero_skedasticity=jnp.asarray(rng.standard_normal(m) - 2.0),
            log_multiscales_m05=jnp.asarray(0.3 * rng.standard_normal((m, 2))),
        )
    else:
        jp = fam.default_params(jnp.asarray(X), m, key=jax.random.PRNGKey(0))
    k = port_kernel(fam, jp)
    Z = k.inducing_from_inputs(t(X[:m])).detach()
    return k, Z, t(X), t(rng.standard_normal(n))


@pytest.mark.parametrize("name", FAMILIES)
def test_check_deriv_hyper(name):
    k, Z, X, _ = _data(name)
    assert check_deriv_hyper(k, Z, X) >= 1


@pytest.mark.parametrize("variational", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_self_test(name, variational):
    k, Z, X, y = _data(name)
    n_checked = self_test(k, Z, X, y, SIGMA2, variational=variational)
    # sigma2 is always checked; families with inducing hypers check them all
    expected_min = 2 + (Z.numel() if type(k).learn_inducing_default else 0)
    assert n_checked >= expected_min


class Broken(SeIso):
    """SE-iso whose prior variances lose their sf2 derivative: the
    realistic custom-kernel bug (autograd sees zero, finite differences the
    real slope)."""

    name = "broken"

    def k_diag(self, X):
        return torch.exp(self.log_sf2).detach().expand(X.shape[0])


def test_harness_catches_wrong_gradient():
    _, Z, X, y = _data("se_iso")
    k = Broken(0.0, 0.0, device="cpu", dtype=F64)
    with pytest.raises(DerivMismatch, match="dkn_diag"):
        check_deriv_hyper(k, Z, X)
    with pytest.raises(DerivMismatch, match="evidence gradient"):
        self_test(k, Z, X, y, SIGMA2)


def test_bf16_stochastic_unbiased_and_bit_equal_to_jax():
    x = torch.full((20000,), 1.0 + 2.0 ** -9)  # exactly between bf16 steps
    q = utils.to_bf16_stochastic(torch.Generator().manual_seed(0), x)
    assert q.dtype == torch.bfloat16
    # round-to-nearest would give 1.0 or 1.0078125 for ALL entries; the
    # stochastic mean recovers the true value within sampling noise
    assert abs(float(q.float().mean()) - float(x[0])) < 2e-4
    assert len(torch.unique(q.float())) == 2
    # JAX's construction on its own noise bits (gpr_tpu/utils.py:123-146)
    xs = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    xs *= np.float32(10.0) ** np.random.default_rng(2).integers(-30, 30, 4096)
    key = jax.random.PRNGKey(7)
    want = jutils.to_bf16_stochastic(key, jnp.asarray(xs))
    noise = jax.random.randint(key, xs.shape, 0, 1 << 16, dtype=jnp.uint32)
    got = utils._round_bits(torch.as_tensor(xs),
                            torch.as_tensor(np.asarray(noise, np.int64)))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


def test_debug_checks_and_contexts(tmp_path):
    bad = torch.tensor([1.0, float("nan")])
    asym = torch.tensor([[1.0, 2.0], [0.0, 1.0]])
    utils.check_finite("off", bad)  # config.debug is off: a no-op
    utils.check_symmetric("off", asym)
    config.debug = True
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            utils.check_finite("x", torch.ones(2), bad)
        with pytest.raises(AssertionError, match="asymmetry"):
            utils.check_symmetric("a", asym)
        utils.check_symmetric("eye", torch.eye(3))
    finally:
        config.debug = False

    stream = io.StringIO()
    with utils.timing("region", stream=stream):
        pass
    assert stream.getvalue().startswith("region: ")
    with utils.JsonlLogger(tmp_path / "log.jsonl") as log:
        log.write(iter=3, l=torch.tensor(-1.5, dtype=F64))
    event = json.loads((tmp_path / "log.jsonl").read_text())
    assert event["iter"] == 3 and event["l"] == -1.5 and "ts" in event

    with utils.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert len(prof.key_averages()) > 0

    x = torch.tensor([-1.0], requires_grad=True)
    with utils.debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()


def test_plot_fit_renders(tmp_path):
    from gpr_tpu_torch.viz import plot_fit

    rng = np.random.default_rng(42)
    n = 120
    x = np.sort(rng.uniform(-5, 5, n))
    f = np.sin(x)
    y = f + 0.3 * rng.standard_normal(n)
    var = 0.05 + 0.01 * rng.uniform(size=n)
    ax = plot_fit(
        x, y, f, var, 0.09,
        true_fn=np.sin,
        inducing=np.linspace(-4, 4, 7),
        samples=np.stack([f + 0.1 * rng.standard_normal(n) for _ in range(3)]),
        fic_samples=np.stack([f + 0.1 * rng.standard_normal(n)]),
    )
    out = tmp_path / "fit.png"
    ax.figure.savefig(out)
    assert out.stat().st_size > 10_000
    labels = {t.get_text() for t in ax.get_legend().get_texts()}
    assert {"data", "true f", "posterior mean", "inducing",
            "posterior samples", "FIC samples", "95% (latent)",
            "95% (predictive)"} <= labels


def test_plot_artifacts_renders(tmp_path):
    from gpr_tpu_torch.viz import plot_artifacts

    rng = np.random.default_rng(42)
    n = 80
    x = np.sort(rng.uniform(-5, 5, n))
    arts = {
        "inputs": x,
        "targets": np.sin(x) + 0.2 * rng.standard_normal(n),
        "means": np.sin(x),
        "variances": 0.05 + 0.01 * rng.uniform(size=n),
        "sigma2": np.asarray(0.04),
        "inducing_points": np.linspace(-4, 4, 6),
        "fitc_samples": np.stack([np.sin(x) + 0.1 * rng.standard_normal(n)
                                  for _ in range(2)]),
        "fic_samples": np.sin(x)[None, :],
    }
    for name, arr in arts.items():
        np.savetxt(os.path.join(tmp_path, name), np.atleast_1d(arr))
    out = tmp_path / "fit.png"
    plot_artifacts(str(tmp_path), str(out))
    assert out.stat().st_size > 10_000
