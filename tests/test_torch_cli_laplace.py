"""The port's command line in its Laplace modes == gpr_tpu's, in f64 on the
CPU: the binary and ordinal modes here, the count modes in
``test_torch_cli_count.py``.

Both CLIs run in process on the same CSV (``-kernel se_iso -n-inducing 6
-trainer device -inducing-init first -seed 0 -max-iter 2 -verbose``):
``-classify`` (0/1 labels, dense; -1/+1 labels streaming) and
``-ordinal`` write the same artifact (1e-8 relative, the extras included:
the cutpoints) with the same stdout and stderr, and either artifact serves
the same text from both CLIs, with and without -with-stddev.  Targets the
JAX package refuses get its messages.
"""

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

LAPLACE = ["-kernel", "se_iso", "-n-inducing", "6", "-trainer", "device",
           "-inducing-init", "first", "-seed", "0", "-max-iter", "2",
           "-verbose"]


@pytest.fixture(scope="module")
def data():
    """CSVs of each mode's targets over one draw of 120 rows, and the test
    rows."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((120, 2))
    latent = np.sin(2.0 * X[:, 0] - X[:, 1])
    trials = rng.integers(1, 6, 120)
    targets = {
        "binary01": (latent + 0.5 * rng.standard_normal(120) > 0) * 1.0,
        "counts": rng.poisson(np.exp(latent)) * 1.0,
        "ordinal": np.digitize(latent, [-0.5, 0.0, 0.5]) * 1.0,
    }
    targets["binarypm"] = 2.0 * targets["binary01"] - 1.0
    csvs = {k: _csv(X, y) for k, y in targets.items()}
    csvs["binomial"] = _csv(X, np.column_stack([
        trials, rng.binomial(trials, 1.0 / (1.0 + np.exp(-latent)))]))
    return csvs, _csv(rng.standard_normal((17, 2)))


CASES = {
    "classify": ("binary01", ["-classify"]),
    "classify-stream": ("binarypm", ["-classify", "-block-size", "64"]),
    "ordinal": ("ordinal", ["-ordinal"]),
}


def assert_mode_matches_jax(which, flags, data, tmp_path):
    """Both CLIs train the same artifact with the same stdout and stderr,
    and either artifact serves the same text from both."""
    csvs, test_csv = data
    jout = _train("jax", tmp_path / "jax.npz", LAPLACE + flags, csvs[which])
    tout = _train("torch", tmp_path / "torch.npz", LAPLACE + flags,
                  csvs[which])
    assert tout == jout
    _assert_same_artifact(tmp_path / "torch.npz", tmp_path / "jax.npz")
    for model in ("jax.npz", "torch.npz"):
        for serve in ([], ["-with-stddev"]):
            cmd = ["-cmd", "test", "-model", str(tmp_path / model), *serve]
            got = run("torch", cmd, test_csv)
            assert got[0] == 0 and got == run("jax", cmd, test_csv)
            assert len(got[1].splitlines()) == 17


@pytest.mark.parametrize("case", sorted(CASES))
def test_laplace_mode_matches_jax(case, data, tmp_path):
    assert_mode_matches_jax(*CASES[case], data, tmp_path)


def _rows(targets, extra=None):
    cols = [np.linspace(-1.0, 1.0, len(targets))]
    if extra is not None:
        cols.append(extra)
    return _csv(np.column_stack(cols), np.asarray(targets, float))


BAD = {
    "classify fractions": (["-classify"], _rows([0.0, 0.5, 1.0, 1.0])),
    "poisson negative": (["-poisson"], _rows([1.0, -1.0, 2.0, 0.0])),
    "poisson fractions": (["-poisson"], _rows([1.0, 1.5, 2.0, 0.0])),
    "binomial two columns": (["-binomial"], _rows([1.0, 0.0, 1.0, 0.0])),
    "binomial successes over trials": (
        ["-binomial"], _rows([3.0, 0.0, 1.0, 2.0], [2.0, 1.0, 1.0, 2.0])),
    "negbin zero dispersion": (["-negbin", "0"], _rows([1.0, 0.0, 2.0, 3.0])),
    "ordinal one category": (["-ordinal"], _rows([0.0, 0.0, 0.0, 0.0])),
    "ordinal fractions": (["-ordinal"], _rows([0.0, 1.5, 2.0, 1.0])),
    "ep multi-class": (["-classify", "-approx", "ep"],
                       _rows([0.0, 1.0, 2.0, 1.0])),
    "ep streaming": (["-classify", "-approx", "ep", "-block-size", "4"],
                     _rows([0.0, 1.0, 1.0, 0.0])),
    "host trainer": (["-poisson", "-trainer", "host"],
                     _rows([1.0, 0.0, 2.0, 3.0])),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_targets_messages(case, tmp_path):
    """rc, stdout and stderr of the JAX CLI, no artifact."""
    flags, csv = BAD[case]
    if "-trainer" not in flags:
        flags = flags + ["-trainer", "device"]
    argv = ["-cmd", "train", "-model", str(tmp_path / "m.npz"), *flags]
    got = run("torch", argv, csv)
    assert got[0] == 1 and got == run("jax", argv, csv)
    assert not (tmp_path / "m.npz").exists()
