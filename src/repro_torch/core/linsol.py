"""Linear solvers for the ensemble Newton iteration (SoA batch surface).

Counterpart of ``repro.core.linsol`` lines 116-124 and 466-495:
``newton_blocks_soa`` and ``BlockDiagGJ`` with ``factor_once=True``,
CVODE's lsetup/lsolve split — lsetup inverts every Newton block once,
each Newton iteration is one block-diagonal SpMV against the saved
inverse, scaled by ``2/(1+gamrat)`` for the gamma drift since lsetup.
``factor_once=False`` waits for ``block_solve_soa`` (ROADMAP queue B
rows 8-9); the Krylov and sparse solvers for ROADMAP queue A item 6.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import dispatch as dv


def newton_blocks_soa(Jsoa: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Dense SoA Newton blocks M = I - gamma*J: Jsoa (n,n,nsys), gamma
    (nsys,) -> (n,n,nsys)."""
    n = Jsoa.shape[0]
    eye = torch.eye(n, dtype=Jsoa.dtype, device=Jsoa.device)
    return eye[:, :, None] - gamma[None, None, :] * Jsoa


@dataclass(frozen=True)
class BlockDiagGJ:
    """Batched block-diagonal Gauss-Jordan over the SoA dispatch ops."""

    name = "blockdiag_gj"
    factor_once: bool = True

    def __post_init__(self):
        if not self.factor_once:
            raise NotImplementedError(
                "BlockDiagGJ(factor_once=False) needs block_solve_soa, "
                "which waits for ROADMAP queue B rows 8-9")

    def soa_setup(self, Jsoa, gamma, policy=None):
        """lsetup: the saved inverse of M = I - gamma*J, (n,n,nsys)."""
        return dv.block_inverse_soa(newton_blocks_soa(Jsoa, gamma), policy)

    def soa_solve(self, MJ, gamma, gamrat, rhs, policy=None):
        """lsolve: ``(dz, nli, npsolves)``; direct, so both counts are 0."""
        corr = 2.0 / (1.0 + gamrat)
        return corr[None, :] * dv.blockdiag_spmv_soa(MJ, rhs, policy), 0, 0

    def soa_carry_init(self, n, nsys, dtype, device):
        return torch.zeros((n, n, nsys), dtype=dtype, device=device)

    def soa_workspace_shapes(self, n, nsys):
        return [("newton_blocks", (n, n, nsys))]
