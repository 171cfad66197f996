"""The port's command line in its iterative exact GP mode (``-exact -cg``)
against gpr_tpu's, in f64 on the CPU.

Both CLIs run in process on the same CSV (150 rows, ``-kernel se_iso``,
``-seed 0``).  With ``-max-iter 0`` no SGD step runs, so the two artifacts
differ only by the final CG solve's anchor rows (the port's come from a
``torch.Generator``): the median-distance init, sigma2, the stored inputs
and the anchor count are equal, alpha within the solve's tolerance.  A
trained artifact (``-max-iter 3``) of either CLI is served by the port:
its means are the library's ``predict_means_iter`` on the artifact (1e-10
against JAX's ``predict_means``) and print as JAX's CLI prints them; its
``-with-stddev`` standard deviations come from CG solves at tol 1e-4 and
lie within 1e-4 (relative to the largest) of the dense exact posterior's
(``models/exact.py``), as JAX's CLI's do.  JAX's refusals of -cg's flag
combinations print the same messages.
"""

import numpy as np
import pytest
import torch

import gpr_tpu.kernels as jk
from gpr_tpu.io import checkpoint as jckpt
from gpr_tpu.models import predict as jpred
from gpr_tpu_torch.convert import params_from_artifact
from gpr_tpu_torch.io import checkpoint as tckpt
from gpr_tpu_torch.models import exact as texact
from gpr_tpu_torch.models.iterative import IterTrained, predict_means_iter
from test_torch_cli import (  # noqa: F401  (the autouse fixtures)
    _csv,
    _on_cpu,
    _train,
    _trusted_jax_csv_library,
    run,
)
from torch_laplace import one_torch_thread  # noqa: F401  (autouse)

CG = ["-exact", "-cg", "-kernel", "se_iso", "-n-inducing", "16", "-seed",
      "0"]
N_TEST = 25


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((150, 3))
    y = np.sin(2.0 * X[:, 0] - X[:, 1]) + 0.1 * rng.standard_normal(150)
    Xs = rng.standard_normal((N_TEST, 3))
    return _csv(X, y), _csv(Xs), Xs


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """-max-iter 3 artifacts of both CLIs and their -verbose stderr."""
    tmp = tmp_path_factory.mktemp("cg")
    out = {}
    # (module scope: set up before the function-scoped _on_cpu)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPR_TPU_PLATFORM", "cpu")
        for pkg in ("jax", "torch"):
            path = tmp / f"{pkg}.npz"
            _, err = _train(pkg, path, CG + ["-max-iter", "3", "-verbose"],
                            data[0])
            out[pkg] = (str(path), err)
    return out


def _pieces(path):
    art, extra = tckpt.load_model(path)
    return art, {k: np.asarray(v) for k, v in extra.items()}


def test_init_and_final_solve_match_jax(data, tmp_path):
    csv = data[0]
    for pkg in ("jax", "torch"):
        _train(pkg, tmp_path / f"{pkg}.npz", CG + ["-max-iter", "0"], csv)
    (ja, jx), (ta, tx) = (_pieces(str(tmp_path / f"{p}.npz"))
                          for p in ("jax", "torch"))
    assert ta.family_name == ja.family_name == "se_iso"
    # the same numpy draws; sf2 and sigma2 from the target variance, a dot
    # product each package sums in its own order
    for k in ("log_ell", "log_sf2"):
        np.testing.assert_allclose(ta.kernel_params[k], ja.kernel_params[k],
                                   rtol=1e-14, err_msg=k)
    np.testing.assert_allclose(ta.sigma2, ja.sigma2, rtol=1e-14)
    for k in ("inducing", "chol_km", "r_mat", "input_means",
              "input_stddevs"):
        np.testing.assert_array_equal(getattr(ta, k), getattr(ja, k), k)
    assert set(tx) == set(jx) == {"exact_cg", "cg_x", "cg_anchors"}
    for k in tx:
        np.testing.assert_array_equal(tx[k], jx[k], k)
    # the final solve's relative residual is 1e-6 on either anchor draw
    np.testing.assert_allclose(ta.coeffs, ja.coeffs, rtol=0,
                               atol=1e-4 * np.abs(ja.coeffs).max())


def test_training_reports(trained):
    for pkg in ("jax", "torch"):
        err = trained[pkg][1]
        assert err.count("sgd step") == 2, (pkg, err)  # steps 0 and 2
        assert "final solve:" in err, (pkg, err)
    art, extra = _pieces(trained["torch"][0])
    assert art.coeffs.shape == (150,) and int(extra["cg_anchors"]) == 16
    assert np.all(np.isfinite(art.coeffs)) and art.sigma2 > 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_served_means_and_stddevs(writer, trained, data):
    _, test_csv, Xs = data
    path = trained[writer][0]
    art, _ = _pieces(path)
    xs = (Xs - art.input_means) / art.input_stddevs
    kernel, z, s2 = params_from_artifact(art, device="cpu",
                                         dtype=torch.float64)
    alpha = torch.as_tensor(art.coeffs)
    mu = predict_means_iter(kernel, IterTrained(z=z, sigma2=s2, alpha=alpha,
                                                iters=0, relres=s2),
                            torch.as_tensor(xs))
    # the library against JAX's on the same artifact
    jart, _ = jckpt.load_model(path)
    jmu = jpred.predict_means(
        jk.SeIso, jart.kernel_params,
        jpred.MeanPredictor(z=jart.inducing, coeffs=jart.coeffs), xs)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jmu)).max())
    want = [f"{v:f}" for v in mu.numpy() + art.target_mean]

    # the dense exact posterior at the artifact's hypers is the oracle of
    # the CG variances (tol 1e-4 on each solve's relative residual)
    with torch.no_grad():
        dense = texact.ExactTrained(
            model=texact.calc_exact(kernel, z, s2), y=alpha, alpha=alpha,
            l=s2)
        sd_dense = torch.sqrt(texact.predict_variances_exact(
            kernel, dense, torch.as_tensor(xs), predictive=False)).numpy()

    for reader in ("torch", "jax"):
        rc, out, err = run(reader, ["-cmd", "test", "-model", path],
                           test_csv)
        assert rc == 0, err
        assert out.split() == want, reader
        rc, out, err = run(reader, ["-cmd", "test", "-model", path,
                                    "-with-stddev"], test_csv)
        assert rc == 0, err
        rows = np.array([[float(v) for v in line.split(",")]
                         for line in out.splitlines()])
        assert [line.split(",")[0] for line in out.splitlines()] == want
        np.testing.assert_allclose(rows[:, 1], sd_dense, rtol=0,
                                   atol=1e-4 * sd_dense.max(),
                                   err_msg=reader)


REFUSED = {
    "cg with loo": ["-exact", "-cg", "-loo"],
    "cg with restarts": ["-exact", "-cg", "-restarts", "2"],
    "cg with streaming": ["-exact", "-cg", "-block-size", "8"],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_match_jax(case, data, tmp_path):
    argv = ["-cmd", "train", "-model", str(tmp_path / "m.npz"),
            *REFUSED[case]]
    got = run("torch", argv, data[0])
    assert got[0] == 1 and got == run("jax", argv, data[0])
