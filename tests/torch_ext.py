"""Shared helpers of the port's Gaussian-likelihood extension tests
(``test_torch_robust.py``, ``test_torch_warped.py``, ``test_torch_pitc.py``,
``test_torch_online.py``, ``test_torch_exact.py``,
``test_torch_multitask.py``): numpy to tensors, the relative comparison
against a JAX array, a JAX params leaf by dotted name, and the fixture of
the tests that need the card."""

import numpy as np
import pytest
import torch

F64 = torch.float64
RTOL = 1e-10


def t(a, dtype=F64, device="cpu"):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def close(got, want, rtol=RTOL, name=""):
    """``got`` (a tensor) within ``rtol`` of ``want``, relative to the
    largest entry of ``want``."""
    if torch.is_tensor(want):
        want = want.detach().cpu()
    want = np.asarray(want)
    np.testing.assert_allclose(
        torch.as_tensor(got).detach().cpu().numpy(), want, rtol=rtol,
        atol=rtol * max(np.abs(want).max(), 1e-300), err_msg=name)


def jax_leaf(jp, name):
    """The field ``name`` (dotted for a combinator) of JAX params."""
    for part in name.split("."):
        jp = jp[int(part)] if part.isdigit() else getattr(jp, part)
    return jp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")
