"""Batched block-diagonal direct linear solver.

Counterpart of ``repro.core.direct``: the cuSolverSp batchQR analog,
solving n independent small systems ``A_j x_j = b_j`` at once.
:func:`block_solve` routes as the reference does (``direct.py:59-71``):
the plain backend (``ExecPolicy(backend="torch")``) runs
:func:`gauss_jordan_batched`, Gauss-Jordan with partial pivoting; the
kernel backends transpose to the SoA layout and call
``dispatch.block_solve_soa``, the no-pivot row-scaled Gauss-Jordan of
PERF.md row 8 (its plain version for CPU tensors), as the reference's
Pallas backend calls ``kernels.ops.block_solve``.
:func:`block_lu_factor` / :func:`block_lu_solve` use
``torch.linalg.lu_factor`` / ``lu_solve``, as the reference uses
``jax.scipy`` outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import dispatch as dv
from .matrix import BlockDiagMatrix
from .policies import DEFAULT, ExecPolicy


class DirectStats(NamedTuple):
    nblocks: int
    block_size: int


def gauss_jordan_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan with partial pivoting over a block batch:
    A (nb, n, n), b (nb, n) -> x (nb, n); the reference's arithmetic
    step for step (a row swap by gather, then one elimination)."""
    nb, n, _ = A.shape
    M = torch.cat([A, b[:, :, None]], dim=2)             # (nb, n, n+1)
    rows = torch.arange(n, device=A.device)[None, :]
    batch = torch.arange(nb, device=A.device)[:, None]
    for k in range(n):
        piv = torch.argmax(M[:, k:, k].abs(), dim=1) + k        # (nb,)
        perm = torch.where(rows == k, piv[:, None],
                           torch.where(rows == piv[:, None], k, rows))
        M = M[batch, perm, :]
        pivrow = M[:, k, :] / M[:, k, k][:, None]            # (nb, n+1)
        factors = M[:, :, k]                                 # (nb, n)
        M = M - factors[:, :, None] * pivrow[:, None, :]
        M[:, k, :] = pivrow
    return M[:, :, n]


def _masked(A: BlockDiagMatrix) -> torch.Tensor:
    return A.data if A.mask is None else A.data * A.mask[None]


def block_solve(A: BlockDiagMatrix, b: torch.Tensor,
                policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """Solve the block-diagonal system; b flat (nb*bs,) or (nb, bs)."""
    nb, bs = A.nblocks, A.block_size
    data = _masked(A)
    bb = b.reshape(nb, bs)
    if (policy or DEFAULT).backend_for("block_solve_soa") == "torch":
        xb = gauss_jordan_batched(data, bb)
    else:
        xb = dv.block_solve_soa(data.permute(1, 2, 0).contiguous(),
                                bb.T.contiguous(), policy).T
    return xb.reshape(b.shape)


def block_lu_factor(A: BlockDiagMatrix):
    """Factor once / solve many (SUNLinSolSetup / SUNLinSolSolve)."""
    return torch.linalg.lu_factor(_masked(A))


def block_lu_solve(factors, b: torch.Tensor, block_size: int) -> torch.Tensor:
    lu, piv = factors
    bb = b.reshape(lu.shape[0], block_size)
    return torch.linalg.lu_solve(lu, piv, bb[..., None])[..., 0] \
        .reshape(b.shape)
