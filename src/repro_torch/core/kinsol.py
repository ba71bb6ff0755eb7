"""Nonlinear solvers (SUNNonlinearSolver / KINSOL analogs).

Counterpart of ``repro.core.kinsol`` (``kinsol.py:32-80``):
:func:`newton_solve`, the (modified/inexact) Newton iteration of the
implicit integrators, with the linear solve as a callback.

The reference's ``lax.while_loop`` is a host loop here: each iteration
ends with ONE device->host read of its ``(converged, diverged)`` test
(counted in :data:`repro_torch.core.loops.loop_counts`, ``newton_trips``
and ``host_syncs``), so the iteration count and the outcome are host
values.  ``fixed_point_solve`` (Anderson acceleration, the ``adams``
family's solver) waits for ROADMAP queue A item 7 and raises.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import dispatch as dv
from . import vector as nv
from .loops import loop_counts, read
from .policies import ExecPolicy

_FIXED_POINT = ("fixed_point_solve (Anderson acceleration) comes with the "
                "adams family, ROADMAP queue A item 7")


class NonlinStats(NamedTuple):
    iters: int                  # Newton iterations run (host)
    fnorm: torch.Tensor         # the last correction's norm (device, 0-d)
    converged: bool             # converged and not diverging (host)


def newton_solve(gfun: Callable, z0, lin_solve: Callable, *,
                 wnorm: Optional[Callable] = None, tol: float = 0.1,
                 max_iters: int = 4, damping: float = 1.0,
                 policy: Optional[ExecPolicy] = None):
    """Solve G(z) = 0 by Newton iteration.

    gfun      : z -> G(z)
    lin_solve : (z, rhs) -> dz  with  J_G(z) dz ~ rhs
    wnorm     : vector -> 0-d tensor; the test is ``wnorm(dz) * min(1,
                crate) < tol`` with the CVODE rate estimate ``crate``
                (default: the RMS norm through ``dispatch.dot``).
    Returns ``(z, NonlinStats)``.
    """
    if wnorm is None:
        n_static = nv.tree_size(z0)

        def wnorm(v):
            return torch.sqrt(dv.dot(v, v, policy) / n_static)

    z, it, conv, div = z0, 0, False, False
    dn = prev = None
    while not conv and not div and it < max_iters:
        g = gfun(z)
        dz = lin_solve(z, nv.scale(-1.0, g))
        z = dv.axpy(damping, dz, z, policy)
        dn = wnorm(dz)
        if it == 0:             # crate = 1: min(1, crate) = 1 exactly
            test = torch.stack([dn < tol, torch.zeros_like(dn, dtype=bool)])
        else:
            crate = dn / torch.clamp(prev, min=1e-30)
            test = torch.stack([dn * torch.clamp(crate, max=1.0) < tol,
                                crate > 2.0])
        loop_counts["newton_trips"] += 1
        conv, div = read(test)
        prev, it = dn, it + 1
    if dn is None:
        dn = torch.zeros((), device=nv.leaves(z0)[0].device)
    return z, NonlinStats(iters=it, fnorm=dn, converged=conv and not div)


def fixed_point_solve(gfun: Callable, y0, **kw):
    raise NotImplementedError(_FIXED_POINT)
