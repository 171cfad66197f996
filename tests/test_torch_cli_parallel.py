"""The port's command line with ``-trainer sharded -devices N`` == gpr_tpu's,
in f64 on the CPU.

Both CLIs run in process on the same CSV (``-kernel se_iso -n-inducing 6
-inducing-init first -seed 0 -max-iter 3``); the port spawns two gloo CPU
ranks (``GPR_TPU_PLATFORM=cpu``), the JAX package shards over two of the
pytest run's virtual CPU devices.  Regression and the binary Laplace
(``-classify``) write the artifact of the JAX package's ``-trainer
sharded -devices 2`` and of the port's ``-trainer device`` within 1e-6
relative, and it serves.  A ^C to a sharded run (a real process, its
ranks spawned) stops every rank after the same chunk and writes the last
completed state, as ``-trainer device`` does.  ``-devices DxM`` (the 2-D
mesh): ``test_torch_cli_mesh2d.py``.
"""

import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from test_torch_cli import (  # noqa: F401  (the autouse fixtures)
    REPO,
    _assert_same_artifact,
    _csv,
    _on_cpu,
    _train,
    _trusted_jax_csv_library,
    run,
)

BASE = ["-kernel", "se_iso", "-n-inducing", "6", "-inducing-init", "first",
        "-seed", "0", "-max-iter", "3"]
SHARDED = ["-trainer", "sharded", "-devices", "2"]
CASES = {"regression": ("regression", []),
         "classify": ("labels", ["-classify"])}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((151, 2))
    latent = np.sin(2.0 * X[:, 0] - X[:, 1])
    return {
        "regression": _csv(X, latent + 0.1 * rng.standard_normal(151)),
        "labels": _csv(X, (latent + 0.5 * rng.standard_normal(151) > 0)
                       * 1.0),
    }, _csv(rng.standard_normal((13, 2)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_trainer_matches(case, data, tmp_path):
    which, flags = CASES[case]
    csvs, test_csv = data
    paths = {name: tmp_path / f"{name}.npz"
             for name in ("torch", "jax", "device")}
    _train("torch", paths["torch"], BASE + flags + SHARDED, csvs[which])
    _train("jax", paths["jax"], BASE + flags + SHARDED, csvs[which])
    _train("torch", paths["device"], BASE + flags + ["-trainer", "device"],
           csvs[which])
    _assert_same_artifact(paths["torch"], paths["jax"], rtol=1e-6)
    _assert_same_artifact(paths["torch"], paths["device"], rtol=1e-6)
    rc, out, err = run("torch", ["-cmd", "test", "-model",
                                 str(paths["torch"])], test_csv)
    assert rc == 0 and len(out.splitlines()) == 13, err


def test_sharded_interrupt_writes_last_state(data, tmp_path):
    """SIGINT reaches the CLI before its ranks start; they read it after
    their first chunk (50 iterations of the 94 this fit needs to converge
    on one device), stop together, and the CLI writes that state."""
    csvs, test_csv = data
    model = tmp_path / "m.npz"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpr_tpu_torch.cli", "-cmd", "train",
         "-model", str(model), "-kernel", "se_iso", "-n-inducing", "12",
         "-inducing-init", "first", "-seed", "0", "-max-iter", "400",
         "-eps", "1e-9", *SHARDED, "-verbose"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "GPR_TPU_PLATFORM": "cpu"})
    watchdog = threading.Timer(150.0, proc.kill)  # a hang fails, not waits
    watchdog.start()
    try:
        proc.stdin.write(csvs["regression"])
        proc.stdin.close()
        err = []
        for line in proc.stderr:
            err.append(line)
            if line.startswith("-trainer sharded: 2 ranks"):
                proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0, "".join(err)
    finally:
        watchdog.cancel()
        proc.kill()
        proc.wait()
    chunks = re.findall(r"^iter +(\d+):", "".join(err), re.M)
    assert chunks == ["50"], "".join(err)
    rc, out, err = run("torch", ["-cmd", "test", "-model", str(model)],
                       test_csv)
    assert rc == 0, err
    assert np.isfinite(np.loadtxt(out.splitlines())).all()
