"""The port's command line in its EP and multi-class modes == gpr_tpu's, in
f64 on the CPU.

Both CLIs run in process on the same CSV (``-kernel se_iso -n-inducing 6
-trainer device -inducing-init first -seed 0 -max-iter 2 -verbose``):
``-classify -approx ep`` (0/1 labels) and ``-classify`` on labels 0, 1, 2
(dense, and streaming with ``-block-size 64``) write the same artifact
(1e-8 relative, the extras included: the multi-class state's
``mc_a_tilde``/``mc_b_tilde``) with the same stdout and stderr.  Either
artifact serves from both CLIs: EP's text is the same; the multi-class
standard-deviation columns are the same, and its probability columns,
Monte Carlo averages over each package's own draws, are the port
library's ``multiclass_predict_from_state`` with the generator seed 0 as
printed and within 0.1 of the JAX package's.  A checkpointed run resumes
bit-equal on the uninterrupted one.
"""

import os

import numpy as np
import pytest
import torch

from gpr_tpu.io import native as jnative
from gpr_tpu_torch.convert import params_from_artifact
from gpr_tpu_torch.io import checkpoint as tckpt
from gpr_tpu_torch.io import native as tnative
from gpr_tpu_torch.models.classify_multi import multiclass_predict_from_state
from test_torch_cli import (  # noqa: F401  (the autouse fixtures)
    _assert_same_artifact,
    _csv,
    _on_cpu,
    _train,
    _trusted_jax_csv_library,
    run,
)
from test_torch_cli_laplace import LAPLACE
from torch_laplace import one_torch_thread  # noqa: F401  (autouse)

CLASSES = 3
N_TEST = 17


@pytest.fixture(scope="module")
def data():
    """CSVs of binary and 3-class labels over one draw of 150 rows, the
    test rows, and the test inputs."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((150, 2))
    latent = np.sin(2.0 * X[:, 0] - X[:, 1])
    noisy = latent + 0.4 * rng.standard_normal(150)
    Xs = rng.standard_normal((N_TEST, 2))
    return ({"binary01": _csv(X, (noisy > 0) * 1.0),
             "multi": _csv(X, np.digitize(noisy, [-0.4, 0.4]) * 1.0)},
            _csv(Xs), Xs)


CASES = {
    "ep": ("binary01", ["-classify", "-approx", "ep"]),
    "multi": ("multi", ["-classify"]),
    "multi-stream": ("multi", ["-classify", "-block-size", "64"]),
}


def library_probs(model, Xs):
    """The port library's probability columns of a multi-class artifact at
    the raw test inputs, as -cmd test prints them."""
    art, extra = tckpt.load_model(str(model))
    kernel, z, _ = params_from_artifact(art, device="cpu",
                                        dtype=torch.float64)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    with torch.no_grad():
        probs, _, _ = multiclass_predict_from_state(
            kernel, z, t(art.coeffs), t(extra["mc_a_tilde"]),
            t(extra["mc_b_tilde"]),
            t((Xs - art.input_means) / art.input_stddevs), n_samples=2048,
            generator=torch.Generator("cpu").manual_seed(0))
    return [",".join(f"{v:f}" for v in row) for row in probs.numpy()]


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request, data, tmp_path_factory):
    """Both CLIs' artifacts of a mode, their training output, and the text
    each package serves from each artifact, with and without
    -with-stddev."""
    which, flags = CASES[request.param]
    csvs, test_csv, _ = data
    tmp = tmp_path_factory.mktemp(request.param)
    served = {}
    with pytest.MonkeyPatch.context() as mp:
        # the function-scoped fixtures of test_torch_cli.py, for the module
        mp.setenv("GPR_TPU_PLATFORM", "cpu")
        assert tnative.get_lib() is not None
        mp.setattr(jnative, "_LIB", str(tnative._lib_path()))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        outs = {pkg: _train(pkg, tmp / f"{pkg}.npz", LAPLACE + flags,
                            csvs[which]) for pkg in ("jax", "torch")}
        for writer in ("jax", "torch"):
            for server in ("jax", "torch"):
                for serve in ((), ("-with-stddev",)):
                    got = run(server, ["-cmd", "test", "-model",
                                       str(tmp / f"{writer}.npz"), *serve],
                              test_csv)
                    assert got[0] == 0, got[2][-2000:]
                    served[writer, server, serve] = got[1].splitlines()
    return request.param, tmp, outs, served


def test_artifact_matches_jax(trained):
    _, tmp, outs, _ = trained
    assert outs["torch"] == outs["jax"]
    _assert_same_artifact(tmp / "torch.npz", tmp / "jax.npz")
    extra = tckpt.load_model(str(tmp / "torch.npz"))[1]
    if "mc_a_tilde" in extra:
        assert int(extra["classify"]) == CLASSES
        assert extra["mc_b_tilde"].shape == (CLASSES, CLASSES, 6, 6)
    else:
        assert int(extra["ep"]) == 1 and int(extra["classify"]) == 2


def test_served_text(trained, data):
    """EP: one text whichever package writes or serves.  Multi-class: the
    standard-deviation columns so; the probabilities of the port the
    library's, in [0, 1], summing to 1 per row, within 0.1 of JAX's."""
    case, tmp, _, served = trained
    for key, lines in served.items():
        assert len(lines) == N_TEST, key
    if case == "ep":
        assert len({tuple(v) for v in served.values()
                    if len(v[0].split(",")) == 1}) == 1
        assert len({tuple(v) for v in served.values()
                    if len(v[0].split(",")) == 2}) == 1
        probs = np.array([float(v) for v in served["torch", "torch", ()]])
        assert ((probs > 0) & (probs < 1)).all()
        return
    for writer in ("jax", "torch"):
        sd = {server: [line.split(",")[CLASSES:] for line in
                       served[writer, server, ("-with-stddev",)]]
              for server in ("jax", "torch")}
        assert sd["torch"] == sd["jax"]
        for serve in ((), ("-with-stddev",)):
            got = [line.split(",")[:CLASSES]
                   for line in served[writer, "torch", serve]]
            assert [",".join(row) for row in got] == library_probs(
                tmp / f"{writer}.npz", data[2])
            p = np.array(got, dtype=float)
            want = np.array([line.split(",")[:CLASSES] for line in
                             served[writer, "jax", serve]], dtype=float)
            assert ((p >= 0) & (p <= 1)).all()
            np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=5e-6)
            assert np.abs(p - want).max() <= 0.1


@pytest.mark.parametrize("case", ["ep", "multi-stream"])
def test_checkpoint_resume_bit_equal(case, data, tmp_path):
    which, flags = CASES[case]
    csv = data[0][which]
    flags = LAPLACE[:LAPLACE.index("-max-iter")] + flags
    ckpt = str(tmp_path / "run.ckpt.npz")
    _train("torch", tmp_path / "full.npz", flags + ["-max-iter", "4"], csv)
    _train("torch", tmp_path / "part.npz",
           flags + ["-max-iter", "2", "-checkpoint", ckpt], csv)
    assert os.path.exists(ckpt)
    _train("torch", tmp_path / "resumed.npz",
           flags + ["-max-iter", "4", "-checkpoint", ckpt, "-resume"], csv)
    _assert_same_artifact(tmp_path / "resumed.npz", tmp_path / "full.npz",
                          rtol=0)
