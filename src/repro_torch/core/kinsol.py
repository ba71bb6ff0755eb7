"""Nonlinear solvers (SUNNonlinearSolver / KINSOL analogs).

Counterpart of ``repro.core.kinsol`` (``kinsol.py:32-134``):

* :func:`newton_solve` — the (modified/inexact) Newton iteration of the
  implicit integrators, with the linear solve as a callback;
* :func:`fixed_point_solve` — fixed-point iteration with Anderson
  acceleration of depth m (KINSOL FP, CVODE's functional iteration, the
  ``adams`` family's solver).

The reference's ``lax.while_loop``s are host loops here: each iteration
ends with ONE device->host read of its convergence test (counted in
:data:`repro_torch.core.loops.loop_counts`, ``newton_trips`` for both
solvers' iterations, and ``host_syncs``), so the iteration count and the
outcome are host values.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import dispatch as dv
from . import vector as nv
from .linsol import _ravel
from .loops import loop_counts, read
from .policies import ExecPolicy


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


def fixed_point_solve(gfun: Callable, y0, *, m: int = 3, tol: float = 1e-9,
                      max_iters: int = 50, wnorm: Optional[Callable] = None):
    """Solve y = G(y) by Anderson-accelerated fixed-point iteration.

    Depth-m Anderson, as the reference: keep the last m residual and
    value differences, solve the regularized ``m x m`` normal equations
    of min ||F_k - dF gamma|| (``torch.linalg.solve`` on the device, no
    kernel in the reference either), combine; the first iteration is a
    plain Picard step.  The test is the RMS of the step, ``< tol``;
    ``wnorm`` is accepted and unused, as in the reference.  Returns
    ``(y, NonlinStats)``; ``fnorm`` is the RMS of ``G(y) - y`` at the
    result (one more evaluation of G, as the reference's).
    """
    flat0, unravel = _ravel(y0)
    shape = flat0.shape
    yf = flat0.reshape(-1)
    n = yf.numel()
    dtype, dev = yf.dtype, yf.device

    def gf(v):
        return _ravel(gfun(unravel(v.reshape(shape))))[0].reshape(-1)

    dF = torch.zeros((m, n), dtype=dtype, device=dev)   # f_k - f_{k-1}
    dG = torch.zeros((m, n), dtype=dtype, device=dev)   # g_k - g_{k-1}
    eye = 1e-12 * torch.eye(m, dtype=dtype, device=dev)
    y, f_prev, g_prev, it, conv = yf, None, None, 0, False
    while not conv and it < max_iters:
        g = gf(y)
        f = g - y                                       # residual
        if it == 0:                                     # plain Picard
            y_next = g
        else:
            # shift the difference histories; the newest row is last
            dF = torch.cat([dF[1:], (f - f_prev)[None]])
            dG = torch.cat([dG[1:], (g - g_prev)[None]])
            k = min(it, m)                              # valid rows
            valid = (torch.arange(m, device=dev) >= m - k)[:, None]
            zero = torch.zeros((), dtype=dtype, device=dev)
            dFm = torch.where(valid, dF, zero)
            gamma = torch.linalg.solve(dFm @ dFm.T + eye, dFm @ f)
            y_next = g - gamma @ torch.where(valid, dG, zero)
        dn = torch.sqrt(torch.sum((y_next - y) ** 2) / n)
        loop_counts["newton_trips"] += 1
        conv = bool(read(dn < tol))
        y, f_prev, g_prev, it = y_next, f, g, it + 1
    fn = torch.sqrt(torch.sum((gf(y) - y) ** 2) / n)
    return unravel(y.reshape(shape)), NonlinStats(iters=it, fnorm=fn,
                                                  converged=conv)
