"""The port's command line with ``-trainer sharded -devices DxM`` (the 2-D
data x model mesh) == gpr_tpu's, in f64 on the CPU.

Both CLIs run in process on the same CSV (``-kernel se_iso -n-inducing 4
-inducing-init first -seed 0 -max-iter 3``); the port spawns D M gloo CPU
ranks (``GPR_TPU_PLATFORM=cpu``), the JAX package meshes D M of the pytest
run's virtual CPU devices.  At 2x2 and 1x2 the artifacts agree within 1e-6
relative and the port's serves.  In f64 both packages accumulate the raw
Gram and whiten it after the sum, which amplifies rounding by cond(Km):
with 6 inducing rows this draw's fit reaches a lengthscale where the two
packages' 2x2 artifacts differ by 3e-6 after 3 iterations (23
evaluations), as the port's 2x2 and 1-D ones do; with 4 they agree to
5e-9.  The JAX package's checks hold in its order: an extension flag with
-devices DxM exits with its message, and an m that the model axis does not
divide raises its ValueError before any artifact is written.
"""

import os

import numpy as np
import pytest

from test_torch_cli import (  # noqa: F401  (the autouse fixtures)
    _assert_same_artifact,
    _csv,
    _on_cpu,
    _train,
    _trusted_jax_csv_library,
    run,
)

BASE = ["-kernel", "se_iso", "-n-inducing", "4", "-inducing-init", "first",
        "-seed", "0", "-max-iter", "3"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((151, 2))
    y = np.sin(2.0 * X[:, 0] - X[:, 1]) + 0.1 * rng.standard_normal(151)
    return _csv(X, y), _csv(rng.standard_normal((13, 2)))


@pytest.mark.parametrize("shape", ["2x2", "1x2"])
def test_mesh2d_trainer_matches(shape, data, tmp_path):
    csv, test_csv = data
    flags = BASE + ["-trainer", "sharded", "-devices", shape]
    got, want = tmp_path / "torch.npz", tmp_path / "jax.npz"
    _train("torch", got, flags, csv)
    _train("jax", want, flags, csv)
    _assert_same_artifact(got, want, rtol=1e-6)
    rc, out, err = run("torch", ["-cmd", "test", "-model", str(got)],
                       test_csv)
    assert rc == 0 and len(out.splitlines()) == 13, err
    assert np.isfinite(np.loadtxt(out.splitlines())).all()


def test_mesh2d_refusals(data, tmp_path):
    """An extension with DxM exits with the JAX package's message; m = 5
    at M = 2 raises its ValueError and writes no artifact."""
    csv, _ = data
    model = str(tmp_path / "m.npz")
    argv = ["-cmd", "train", "-model", model, *BASE, "-trainer", "sharded",
            "-devices", "2x2", "-warp", "2"]
    got = run("torch", argv, csv)
    assert got[0] != 0 and "-devices N" in got[2]
    assert got == run("jax", argv, csv)
    argv = ["-cmd", "train", "-model", model, "-kernel", "se_iso",
            "-n-inducing", "5", "-inducing-init", "first", "-seed", "0",
            "-max-iter", "1", "-trainer", "sharded", "-devices", "1x2"]
    for pkg in ("torch", "jax"):
        with pytest.raises(ValueError, match=r"m \(5\) must be divisible "
                           r"by the model axis \(2\)"):
            run(pkg, argv, csv)
        assert not os.path.exists(model)
