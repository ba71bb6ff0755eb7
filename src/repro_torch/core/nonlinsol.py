"""Pluggable nonlinear solvers: the SUNNonlinearSolver object layer.

Counterpart of ``repro.core.nonlinsol``: :class:`NewtonSolver` (wraps
:func:`repro_torch.core.kinsol.newton_solve`; tolerances from
:meth:`NewtonSolver.from_options`, the one place they are defined) and
:class:`FixedPointSolver` (wraps
:func:`repro_torch.core.kinsol.fixed_point_solve`, Anderson acceleration;
the ``adams`` family's solver).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from . import kinsol
from .policies import ExecPolicy


@dataclass(frozen=True)
class NewtonSolver:
    """Config of the Newton iteration (SUNNonlinSol_Newton): ``tol`` is
    the WRMS step-tolerance factor (CVODE's ``epcon``), ``max_iters``
    the iterations a solve may take."""

    tol: float = 0.1
    max_iters: int = 4
    damping: float = 1.0

    @classmethod
    def from_options(cls, opts) -> "NewtonSolver":
        """The integrators' Newton tolerances from ODEOptions."""
        return cls(tol=opts.newton_tol_fac, max_iters=opts.newton_max)

    def solve(self, gfun: Callable, z0, lin_solve: Callable, *,
              wnorm: Optional[Callable] = None,
              policy: Optional[ExecPolicy] = None):
        return kinsol.newton_solve(gfun, z0, lin_solve, wnorm=wnorm,
                                   tol=self.tol, max_iters=self.max_iters,
                                   damping=self.damping, policy=policy)


@dataclass(frozen=True)
class FixedPointSolver:
    """Config of the Anderson fixed point (SUNNonlinSol_FixedPoint)."""

    m: int = 3
    tol: float = 1e-9
    max_iters: int = 50

    @classmethod
    def from_options(cls, opts, m: int = 2) -> "FixedPointSolver":
        return cls(m=m, tol=opts.newton_tol_fac * opts.atol + 1e-12,
                   max_iters=10)

    def solve(self, gfun: Callable, y0, *, wnorm: Optional[Callable] = None):
        return kinsol.fixed_point_solve(gfun, y0, m=self.m, tol=self.tol,
                                        max_iters=self.max_iters,
                                        wnorm=wnorm)
