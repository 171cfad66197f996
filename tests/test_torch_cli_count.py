"""The port's command line in its count modes == gpr_tpu's, in f64 on the
CPU: ``-poisson``, ``-binomial`` (the CSV's last two columns trials,
successes) and ``-negbin 2`` write the same artifact (1e-8 relative, the
learned dispersion in the extras) with the same stdout and stderr, and
either artifact serves the same text from both CLIs, with and without
-with-stddev (``test_torch_cli_laplace.py`` has the flags and the data)."""

import pytest

from test_torch_cli import (  # noqa: F401  (the autouse fixtures)
    _on_cpu,
    _trusted_jax_csv_library,
)
from test_torch_cli_laplace import assert_mode_matches_jax, data  # noqa: F401

CASES = {
    "poisson": ("counts", ["-poisson"]),
    "binomial": ("binomial", ["-binomial"]),
    "negbin": ("counts", ["-negbin", "2"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_mode_matches_jax(case, data, tmp_path):  # noqa: F811
    assert_mode_matches_jax(*CASES[case], data, tmp_path)
