"""The port's block-diagonal numerics and tall-skinny QR == gpr_tpu's, in
f64 on the CPU, on tests/test_linalg.py's cases (and scipy's answers): the
blockwise Cholesky and inverse, identity padding, ``copy``, the squareness
check, and ``tsqr_r`` against ``qr_r_positive`` with and without a block
count that divides the rows.  The math is the same LAPACK calls in both
packages, so the bar is rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from gpr_tpu.numerics import block_diag as jbd
from gpr_tpu.numerics import qr_r_positive as j_qr_r_positive
from gpr_tpu.numerics import tsqr_r as j_tsqr_r
from gpr_tpu_torch.numerics import block_diag as tbd
from gpr_tpu_torch.numerics import qr_r_positive, tsqr_r

RTOL = 1e-10


def spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("rows, n_blocks", [(64, 8), (64, 1), (63, 8)],
                         ids=["blocked", "one", "indivisible"])
def test_tsqr_matches_qr(rng, rows, n_blocks):
    a = rng.standard_normal((rows, 5))
    r = tsqr_r(torch.as_tensor(a), n_blocks=n_blocks)
    assert torch.all(torch.diagonal(r) > 0)
    _close(r, j_tsqr_r(jnp.asarray(a), n_blocks=n_blocks))
    _close(r, qr_r_positive(torch.as_tensor(a)).numpy())
    _close(r, j_qr_r_positive(jnp.asarray(a)))


def test_block_diag_potrf_potri(rng):
    blocks = np.stack([spd(rng, 4) for _ in range(3)])
    bd = tbd.create(torch.as_tensor(blocks))
    jbd_ = jbd.create(jnp.asarray(blocks))
    assert (bd.n_blocks, bd.block_size) == (jbd_.n_blocks, jbd_.block_size)
    ch = tbd.potrf(bd)
    inv = tbd.potri(ch)
    _close(ch.data, jbd.potrf(jbd_).data)
    _close(inv.data, jbd.potri(jbd.potrf(jbd_)).data)
    for i in range(3):
        _close(ch.data[i], sla.cholesky(blocks[i], lower=False))
        _close(inv.data[i], np.linalg.inv(blocks[i]), 1e-8)
    _close(torch.block_diag(*inv.data.unbind()),
           jbd.to_dense(jbd.potri(jbd.potrf(jbd_))))
    jit = tbd.potrf(bd, jitter=0.5)
    _close(jit.data, jbd.potrf(jbd_, jitter=0.5).data)


def test_block_diag_padded_copy_and_checks(rng):
    b1, b2 = spd(rng, 3), spd(rng, 5)
    bd = tbd.create_padded([torch.as_tensor(b1), torch.as_tensor(b2)])
    want = jbd.create_padded([jnp.asarray(b1), jnp.asarray(b2)])
    assert tuple(bd.data.shape) == (2, 5, 5)
    _close(bd.data, want.data, 0)
    listed = tbd.create([torch.as_tensor(b2), torch.as_tensor(b2)])
    assert listed.n_blocks == 2
    dup = tbd.copy(bd)
    dup.data[0, 0, 0] = -1.0
    assert bd.data[0, 0, 0] == b1[0, 0]
    with pytest.raises(ValueError, match="square"):
        tbd.create(torch.zeros(2, 3, 4))
    failed = tbd.potrf(tbd.create(-torch.as_tensor(np.stack([b2, b2]))))
    assert torch.isnan(failed.data).all()
