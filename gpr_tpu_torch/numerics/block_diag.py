"""Block-diagonal matrices with blockwise Cholesky and inverse: the
counterpart of ``gpr_tpu/numerics/block_diag.py`` (the reference's
``Block_diag``, lib/block_diag.ml:22-47).

Equal-sized blocks are stacked on a leading axis and factored by one
batched call; unequal ones are padded with the identity.
"""

from __future__ import annotations

import dataclasses

import torch

from .linalg import cholesky_upper, ichol


@dataclasses.dataclass(frozen=True)
class BlockDiag:
    """Stack of square blocks: ``data`` has shape (n_blocks, k, k)."""

    data: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[-1]


def create(blocks) -> BlockDiag:
    """From a sequence of equal-size square blocks or a stacked tensor;
    raises ValueError unless they are square (lib/block_diag.ml:24-34)."""
    data = (torch.stack([torch.as_tensor(b) for b in blocks])
            if isinstance(blocks, (list, tuple)) else torch.as_tensor(blocks))
    if data.ndim != 3 or data.shape[-1] != data.shape[-2]:
        raise ValueError(f"blocks must be square, got shape "
                         f"{tuple(data.shape)}")
    return BlockDiag(data=data)


def create_padded(blocks) -> BlockDiag:
    """From unequal square blocks, each padded with the identity to the
    largest size."""
    k = max(b.shape[-1] for b in blocks)
    padded = []
    for b in blocks:
        b = torch.as_tensor(b)
        p = torch.eye(k, dtype=b.dtype, device=b.device)
        p[:b.shape[-1], :b.shape[-1]] = b
        padded.append(p)
    return BlockDiag(data=torch.stack(padded))


def copy(bd: BlockDiag) -> BlockDiag:
    """A copy that owns its data (lib/block_diag.mli:30)."""
    return BlockDiag(data=bd.data.clone())


def potrf(bd: BlockDiag, jitter: float = 0.0) -> BlockDiag:
    """Blockwise upper Cholesky factors of ``data + jitter I``, batched
    (lib/block_diag.ml:41-43); a block that is not positive definite gives
    NaN, as in the JAX package."""
    return BlockDiag(data=cholesky_upper(bd.data, jitter=jitter))


def potri(bd: BlockDiag) -> BlockDiag:
    """Blockwise inverses from the blockwise Cholesky factors
    (lib/block_diag.ml:45-47)."""
    return BlockDiag(data=ichol(bd.data))
