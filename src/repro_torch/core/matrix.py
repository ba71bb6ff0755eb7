"""SUNMatrix analogs: dense and low-storage block-diagonal matrices.

Counterpart of ``repro.core.matrix``: :class:`BlockDiagMatrix` stores
``data: (nblocks, b, b)`` (the blocks dense, the block layout implicit
and shared) with an optional shared ``(b, b)`` sparsity ``mask``; the
ops mirror SUNMatScaleAdd, SUNMatScaleAddI and SUNMatMatvec.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BlockDiagMatrix(NamedTuple):
    """Block-diagonal matrix: n = nblocks * b, blocks stacked densely."""

    data: torch.Tensor                  # (nblocks, b, b)
    mask: Optional[torch.Tensor] = None  # (b, b) shared sparsity or None

    @property
    def nblocks(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self):
        n = self.nblocks * self.block_size
        return (n, n)


def bd_zero_like(A: BlockDiagMatrix) -> BlockDiagMatrix:
    return BlockDiagMatrix(torch.zeros_like(A.data), A.mask)


def bd_scale_add(c, A: BlockDiagMatrix, B: BlockDiagMatrix) -> BlockDiagMatrix:
    """A <- c*A + B   (SUNMatScaleAdd)."""
    return BlockDiagMatrix(c * A.data + B.data, A.mask)


def bd_scale_addi(c, A: BlockDiagMatrix) -> BlockDiagMatrix:
    """A <- c*A + I   (SUNMatScaleAddI): the Newton matrix I - gamma*J
    for c = -gamma."""
    eye = torch.eye(A.block_size, dtype=A.data.dtype, device=A.data.device)
    return BlockDiagMatrix(c * A.data + eye[None, :, :], A.mask)


def bd_matvec(A: BlockDiagMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape (nblocks*b,) or (nblocks, b)."""
    xb = x.reshape(A.nblocks, A.block_size)
    data = A.data if A.mask is None else A.data * A.mask[None]
    return torch.einsum("nij,nj->ni", data, xb).reshape(x.shape)


def bd_from_jacfn(jac_blocks: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> BlockDiagMatrix:
    return BlockDiagMatrix(jac_blocks, mask)


def dense_scale_addi(c, A: torch.Tensor) -> torch.Tensor:
    return c * A + torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
