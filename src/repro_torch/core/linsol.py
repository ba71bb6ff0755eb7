"""Linear solvers for the ensemble Newton iteration (SoA batch surface).

Counterpart of ``repro.core.linsol`` lines 116-124 and 466-495:
``newton_blocks_soa`` and ``BlockDiagGJ``.  The Krylov and sparse
solvers wait for ROADMAP queue A item 6.
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
    """Batched block-diagonal Gauss-Jordan over the SoA dispatch ops.

    ``factor_once=True`` (the default, CVODE's lsetup/lsolve split):
    lsetup inverts every Newton block once and each Newton iteration is
    one block-diagonal SpMV against the saved inverse, scaled by
    ``2/(1+gamrat)`` for the gamma drift since lsetup.
    ``factor_once=False`` keeps the bare Jacobian and solves
    ``(I - gamma*J) dz = rhs`` with the current gamma every iteration.
    """

    name = "blockdiag_gj"
    factor_once: bool = True

    def soa_setup(self, Jsoa, gamma, policy=None):
        """lsetup: the saved inverse of M = I - gamma*J, (n,n,nsys), or
        the bare Jacobian for ``factor_once=False``."""
        if not self.factor_once:
            return Jsoa
        return dv.block_inverse_soa(newton_blocks_soa(Jsoa, gamma), policy)

    def soa_solve(self, MJ, gamma, gamrat, rhs, policy=None):
        """lsolve: ``(dz, nli, npsolves)``; direct, so both counts are 0."""
        if not self.factor_once:
            return dv.block_solve_soa(newton_blocks_soa(MJ, gamma), rhs,
                                      policy), 0, 0
        corr = 2.0 / (1.0 + gamrat)
        return corr[None, :] * dv.blockdiag_spmv_soa(MJ, rhs, policy), 0, 0

    def soa_carry_init(self, n, nsys, dtype, device):
        return torch.zeros((n, n, nsys), dtype=dtype, device=device)

    def soa_workspace_shapes(self, n, nsys):
        return [("newton_blocks", (n, n, nsys))]
