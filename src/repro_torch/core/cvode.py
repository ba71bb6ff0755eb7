"""CVODE analog: adaptive BDF (orders 1-5) for stiff ODEs, Adams for
nonstiff ones, and the tables and history rebuild they share with the
ensemble BDF.

Counterpart of ``repro.core.cvode``:

* the uniform-grid BDF coefficients and the Lagrange rebuild matrix
  (``cvode.py:36-87``): :func:`lagrange_matrix_soa` (from
  :mod:`repro_torch.kernels.newton`, where it is the plain version of
  ``lagrange_rescale``'s W) builds one matrix per system with the
  system axis LAST; :func:`_lagrange_matrix` is the scalar one, built
  from it;
* :func:`bdf_integrate` — fixed-leading-coefficient BDF on a uniform
  history window, Newton corrector, order ramped 1 -> ``order``, the
  CV_* retcodes and their escalation (``cvode.py:90-274``);
* :func:`bdf_fixed` — fixed-step BDF with an exact DP5 startup, for
  convergence orders (``cvode.py:277-363``);
* :func:`adams_integrate` — CVODE's functional iteration: a trapezoid
  (Adams-Moulton 2) corrector solved by Anderson fixed point, AB2
  predictor (``cvode.py:366-447``).

The scalar integrators are written against the dispatch ops (on the
card: the WRMS kernel for the error and Newton tests, the linear
combination for the Newton update) and the solver callbacks.  The
reference's ``lax.while_loop`` step loop is a host loop: each attempt
ends with ONE device->host read (counted in
:data:`repro_torch.core.loops.loop_counts`, ``step_trips`` and
``host_syncs``) of what the host decides on, and the Newton and
fixed-point iterations read their tests once an iteration.  The
history products are plain PyTorch, as the reference's are outside any
kernel, and each sums in the order XLA gives the reference's
expression on the CPU: the predictor and ``psi`` (``c @ Z``) through
``torch.matmul``, a chain of fused multiply-adds on the CPU as there;
the rebuilds ``Z_new = W Z`` (an ``einsum``) through :func:`_rebuild`.
Every constant and branch of the reference is kept.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import torch

from ..kernels.newton import LAGRANGE_Q1, lagrange_matrix_soa
from ..observability.telemetry import ring_init, ring_record
from . import controller as ctrl
from . import dispatch as dv
from . import status
from .arkode import (ODEOptions, _bind_lin_solver, _Counts, _F64,
                     _initial_h, _time, erk_fixed)
from .butcher import DORMAND_PRINCE
from .linsol import _ravel
from .loops import loop_counts, read
from .nonlinsol import FixedPointSolver, NewtonSolver
from .policies import ExecPolicy

#: highest BDF order: the history holds QMAX + 1 rows, the rows of the
#: Lagrange rebuild matrix that ``lagrange_rescale`` forms
QMAX = LAGRANGE_Q1 - 1

# Uniform-grid BDF coefficients, normalized alpha_0 = 1:
#   sum_j alpha_j y_{n+1-j} = h * beta * f_{n+1}
_BDF_ALPHA = [
    [1.0, -1.0, 0.0, 0.0, 0.0, 0.0],
    [1.0, -4 / 3, 1 / 3, 0.0, 0.0, 0.0],
    [1.0, -18 / 11, 9 / 11, -2 / 11, 0.0, 0.0],
    [1.0, -48 / 25, 36 / 25, -16 / 25, 3 / 25, 0.0],
    [1.0, -300 / 137, 300 / 137, -200 / 137, 75 / 137, -12 / 137],
]
_BDF_BETA = [1.0, 2 / 3, 6 / 11, 12 / 25, 60 / 137]

# Extrapolation predictor coefficients on a uniform grid, by polynomial
# DEGREE p (row p uses Z[0..p]):  y_pred = sum_j (-1)^j C(p+1, j+1) y_{n-j}.
_PREDP = [[1.0] + [0.0] * QMAX]
for _p in range(1, QMAX + 1):
    _row = [((-1.0) ** j) * math.comb(_p + 1, j + 1) for j in range(_p + 1)]
    _PREDP.append(_row + [0.0] * (QMAX + 1 - len(_row)))


def bdf_tables(dtype, device):
    """``(alpha, beta, predp)`` as tensors, laid out for column gathers
    by a per-system index: alpha ``(QMAX+1, QMAX)`` (column ``q-1``),
    beta ``(QMAX,)``, predp ``(QMAX+1, QMAX+1)`` (column = degree)."""
    alpha = torch.tensor(_BDF_ALPHA, dtype=torch.float64).T
    beta = torch.tensor(_BDF_BETA, dtype=torch.float64)
    predp = torch.tensor(_PREDP, dtype=torch.float64).T
    return tuple(x.to(dtype=dtype, device=device).contiguous()
                 for x in (alpha, beta, predp))


def _lagrange_matrix(eta: torch.Tensor, q_cur) -> torch.Tensor:
    """The scalar rebuild matrix ``W (QMAX+1, QMAX+1)``: eta a 0-d
    tensor, q_cur an int or a 0-d integer tensor (the one-system case
    of :func:`lagrange_matrix_soa`)."""
    q = q_cur.reshape(1) if torch.is_tensor(q_cur) else torch.full(
        (1,), q_cur, dtype=torch.int32, device=eta.device)
    return lagrange_matrix_soa(eta.reshape(1), q)[:, :, 0]


def _flat_problem(f, y0):
    """``(y0 flat (n,), unravel, f_flat)`` for a tensor or tuple state."""
    flat0, unravel_tree = _ravel(y0)
    shape = flat0.shape

    def unravel(v):
        return unravel_tree(v.reshape(shape))

    def f_flat(t, yf):
        return _ravel(f(t, unravel(yf)))[0].reshape(-1)

    return flat0.reshape(-1), unravel, f_flat


def _rebuild(W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``Z_new = W Z`` for the history ``Z (QMAX+1, n)``, summed as XLA's
    CPU dot sums the reference's ``einsum("ji,ik->jk", W, Z)``, since
    one ulp here can move the step sequence (``torch.matmul``'s blocked
    gemm sums otherwise): row by row with each product rounded, and for
    one column (a scalar ODE) in XLA's vector-tile order,
    ``((p0 + p2) + (p1 + p3)) + fma(w5, z5, p4)`` with ``p_i = w_i z_i``.
    The last column of another odd count takes a third order in XLA,
    which no summation tree of the six products reproduces; it goes row
    by row here."""
    if Z.shape[1] == 1:
        z = Z[:, 0]
        p = W * z
        return (((p[:, 0] + p[:, 2]) + (p[:, 1] + p[:, 3]))
                + torch.addcmul(p[:, 4], W[:, 5], z[5].expand(W.shape[0]))
                )[:, None]
    acc = W[:, :1] * Z[0]
    for i in range(1, Z.shape[0]):
        acc = acc + W[:, i:i + 1] * Z[i]
    return acc


def bdf_integrate(f: Callable, y0, t0, tf, *, order: int = 5,
                  opts: ODEOptions = ODEOptions(),
                  lin_solver: Optional[Callable] = None,
                  dense_jac: bool = False,
                  nonlin_solver: Optional[NewtonSolver] = None,
                  mem=None, telemetry: Optional[int] = None):
    """Integrate stiff y' = f(t, y) with BDF up to ``order``.

    ``lin_solver`` is a :class:`repro_torch.core.linsol.LinearSolver`
    or a callable ``(t, z, gamma, rhs) -> dz`` solving
    (I - gamma J) dz = rhs (``z``, ``rhs`` shaped as ``y0``); defaults
    to matrix-free SPGMR, or :class:`~repro_torch.core.linsol.DenseGJ`
    with ``dense_jac=True``.  ``nonlin_solver`` defaults to the
    ODEOptions Newton tolerances; ``mem`` registers the history
    workspace.  Returns ``(y(tf), stats)`` with ``stats.retcode`` a 0-d
    int32 CV_* code; ``telemetry=K`` records each attempt in a K-slot
    ring on y0's device (reference ``cvode.py:235-265``: no lsetup
    trigger, always active) and returns ``(y, stats, ring)``.
    """
    if not 1 <= order <= QMAX:
        raise ValueError(f"order must lie in 1..{QMAX}, got {order}")
    if lin_solver is None and dense_jac:
        from .linsol import DenseGJ
        lin_solver = DenseGJ()
    lin_solve = _bind_lin_solver(lin_solver, f, opts, mem)
    nls = nonlin_solver or NewtonSolver.from_options(opts)
    pol = opts.policy
    y0_flat, unravel, f_flat = _flat_problem(f, y0)
    n, dtype, dev = y0_flat.numel(), y0_flat.dtype, y0_flat.device
    if mem is not None:
        mem.register("bdf.history", (QMAX + 1, n), dtype)

    def lin_solve_flat(t, zf, gamma, rhsf):
        dz = lin_solve(t, unravel(zf), gamma, unravel(rhsf))
        return _ravel(dz)[0].reshape(-1)

    t, tf_t = _time(t0, dev), _time(tf, dev)
    t_host, tf_host = float(t0), float(tf)
    h = _time(opts.h0, dev) if opts.h0 > 0 else _initial_h(
        lambda tt, y: unravel(f_flat(tt, _ravel(y)[0].reshape(-1))),
        t, y0, tf_t, opts.rtol, opts.atol, pol)
    alpha_t, _, predp_t = bdf_tables(dtype, dev)
    #: the controller's exponent q+1 per order, as device scalars
    p_of = {q: _time(q + 1, dev) for q in range(1, QMAX + 1)}
    one = torch.ones((), dtype=_F64, device=dev)
    cst = ctrl.ControllerState(one, one)
    Z = torch.zeros((QMAX + 1, n), dtype=dtype, device=dev)
    Z[0] = y0_flat
    q, rc, ncf_cur, nef_cur = 1, status.SUCCESS, 0, 0
    n_ = _Counts()
    last_h = h
    ring = None if telemetry is None else ring_init(telemetry, (), dtype, dev)
    while (t_host < tf_host * (1 - 1e-12) - 1e-300
           and n_.attempts < opts.max_steps and rc == status.SUCCESS):
        h_use = torch.minimum(h, tf_t - t)
        # valid history entries: steps+1 -> the usable degree
        nvalid_m1 = min(n_.steps, QMAX)
        # h clipped to hit tf: rescale the history accordingly
        Z = _rebuild(_lagrange_matrix(h_use / h, nvalid_m1), Z)
        alphas = alpha_t[:, q - 1]                   # (QMAX+1,)
        y_pred = torch.matmul(predp_t[:, min(nvalid_m1, q)], Z)
        # alphas[j] multiplies y_{n+1-j}; Z[i] = y_{n-i}
        psi = -torch.matmul(alphas[1:], Z[:-1])
        gamma = _BDF_BETA[q - 1] * h_use
        t_new = t + h_use
        w_flat = 1.0 / (opts.rtol * Z[0].abs() + opts.atol)

        def wnorm(v, w=w_flat):
            return dv.wrms_norm(v, w, pol)

        def gfun(z, gamma=gamma, t_new=t_new, psi=psi):
            return z - gamma * f_flat(t_new, z) - psi

        def nsolve(z, rhs, gamma=gamma, t_new=t_new):
            return lin_solve_flat(t_new, z, gamma, rhs)

        z, nst = nls.solve(gfun, y_pred, nsolve, wnorm=wnorm, policy=pol)
        nl_ok = nst.converged
        # LTE estimate ~ C_q (y - y_pred), C_q = 1/(q+1) (uniform grid)
        err_raw = wnorm(z - y_pred) / (q + 1.0)
        finite = torch.isfinite(err_raw)
        bad = ~finite if nl_ok else torch.ones_like(finite)
        err = torch.where(bad, 2.0, err_raw)
        accept = (err <= 1.0) & ~bad
        eta, cst_new = ctrl.eta_from_error(
            opts.controller, cst, err, p_of[q],
            after_failure=~accept if nl_ok else torch.zeros_like(accept))
        if not nl_ok:
            eta = torch.full_like(eta, opts.eta_cf)
        cst = ctrl.ControllerState(*(torch.where(accept, a, b)
                                     for a, b in zip(cst_new, cst)))
        # accepted: shift the history and put z in slot 0
        Z = torch.where(accept, torch.cat([z[None], Z[:-1]]), Z)
        # rebuild on the new grid over the rows that hold values
        eta = torch.clamp(eta, 0.1, 10.0)
        nval_after = torch.clamp(n_.steps + accept.to(torch.int32),
                                 max=QMAX)
        Z = _rebuild(_lagrange_matrix(eta, nval_after), Z)
        # relative underflow (t + h == t); stiff problems legitimately
        # visit tiny absolute h near transients and recover
        hfail = t + h_use * eta == t
        if ring is not None:
            ring = ring_record(ring, (t_new, h_use, q, nst.iters, err, False,
                                      nl_ok, accept, True))
        t = torch.where(accept, t_new, t)
        h = torch.clamp(h_use * eta, min=opts.hmin, max=opts.hmax)
        last_h = h_use
        loop_counts["step_trips"] += 1
        acc, fin, hf, t_host = read(torch.stack([
            accept.to(_F64), finite.to(_F64), hfail.to(_F64), t]))
        acc, fin, hf = bool(acc), bool(fin), bool(hf)
        # CV_*-style escalation: consecutive-failure ceilings, h
        # underflow, a non-finite error with a converged Newton
        ncf_cur = 0 if acc else ncf_cur + (not nl_ok)
        nef_cur = 0 if acc else nef_cur + (nl_ok and fin)
        if nef_cur >= status.MXNEF or (hf and nl_ok):
            rc = status.ERR_FAILURE
        if ncf_cur >= status.MXNCF or (hf and not nl_ok):
            rc = status.CONV_FAILURE
        if nl_ok and not fin:
            rc = status.RHSFUNC_FAIL
        if acc:
            q = min(q + 1, order)
        n_.steps += acc
        n_.attempts += 1
        n_.nfi += 1 + nst.iters
        n_.nni += nst.iters
        n_.netf += (not acc) and nl_ok
        n_.ncfn += not nl_ok
    success = t_host >= tf_host * (1 - 1e-10)
    # a healthy retcode with tf unreached: the attempts ceiling fired
    if rc == status.SUCCESS and not success:
        rc = status.TOO_MUCH_WORK
    st = n_.stats(last_h, t, success, dev)._replace(
        retcode=torch.tensor(rc, dtype=torch.int32, device=dev))
    if ring is not None:
        return unravel(Z[0]), st, ring
    return unravel(Z[0]), st


def bdf_fixed(f: Callable, y0, t0, tf, n_steps: int, *, order: int = 2,
              lin_solver: Optional[Callable] = None, dense_jac: bool = True,
              newton_iters: Optional[int] = None,
              policy: Optional[ExecPolicy] = None,
              opts: Optional[ODEOptions] = None):
    """Fixed-step BDF(order) with its startup history from DP5 fixed
    steps, for convergence-order tests (global error ~ h^order).

    The Newton depth is ``opts.newton_max`` floored at 8 (fixed-step
    Newton has no retry path) at tolerance 1e-10; the bare
    ``newton_iters`` / ``policy`` keywords are the reference's
    deprecated shims and warn."""
    if opts is None:
        opts = ODEOptions()
    newton_depth = max(opts.newton_max, 8)
    if newton_iters is not None:
        warnings.warn("repro-compat: bdf_fixed(newton_iters=...) is "
                      "deprecated; pass opts=ODEOptions(newton_max=...)",
                      DeprecationWarning, stacklevel=2)
        newton_depth = newton_iters
    if policy is not None:
        warnings.warn("repro-compat: bdf_fixed(policy=...) is deprecated; "
                      "pass opts=ODEOptions(policy=...)",
                      DeprecationWarning, stacklevel=2)
        opts = opts._replace(policy=policy)
    if lin_solver is None and dense_jac:
        from .linsol import DenseGJ
        lin_solver = DenseGJ()
    lin_solve = _bind_lin_solver(lin_solver, f, opts)
    pol = opts.policy
    y0_flat, unravel, f_flat = _flat_problem(f, y0)
    n, dev = y0_flat.numel(), y0_flat.device
    h = (tf - t0) / n_steps
    alphas = bdf_tables(y0_flat.dtype, dev)[0][:, order - 1]
    beta = _BDF_BETA[order - 1]
    # startup: the history from DP5 fixed steps (accurate enough)
    hist, y_cur = [y0_flat], y0
    for k in range(order - 1):
        y_cur = erk_fixed(f, y_cur, t0 + k * h, t0 + (k + 1) * h, 4,
                          DORMAND_PRINCE, pol)
        hist.insert(0, _ravel(y_cur)[0].reshape(-1))
    Z = torch.stack(hist + [torch.zeros_like(y0_flat)]
                    * (QMAX + 1 - len(hist)))           # Z[0] most recent
    gamma = beta * h
    # tol 1e-10: the nonlinear error stays far below the discretization
    # error the order tests measure
    nls = NewtonSolver(tol=1e-10, max_iters=newton_depth)

    def wnorm(v):
        return torch.sqrt(dv.dot(v, v, pol) / n)

    for k in range(n_steps - (order - 1)):
        t_new = _time(t0 + (k + order) * h, dev)
        psi = -torch.matmul(alphas[1:], Z[:-1])

        def gfun(z, t_new=t_new, psi=psi):
            return z - gamma * f_flat(t_new, z) - psi

        def nsolve(z, rhs, t_new=t_new):
            dz = lin_solve(t_new, unravel(z), gamma, unravel(rhs))
            return _ravel(dz)[0].reshape(-1)

        z, _ = nls.solve(gfun, Z[0], nsolve, wnorm=wnorm, policy=pol)
        Z = torch.cat([z[None], Z[:-1]])
    return unravel(Z[0])


def adams_integrate(f: Callable, y0, t0, tf,
                    opts: ODEOptions = ODEOptions(), m_aa: int = 2,
                    nonlin_solver: Optional[FixedPointSolver] = None,
                    mem=None):
    """CVODE's functional-iteration mode for nonstiff problems: an
    Adams-Moulton(2) (trapezoid) corrector solved by Anderson fixed
    point, an AB2 predictor, h adapted from the predictor-corrector
    difference.  ``nonlin_solver`` defaults to the ODEOptions-derived
    :class:`~repro_torch.core.nonlinsol.FixedPointSolver` of depth
    ``m_aa``.  Returns ``(y(tf), stats)``; its retcode stays None, as
    in the reference."""
    fps = nonlin_solver or FixedPointSolver.from_options(opts, m=m_aa)
    pol = opts.policy
    y0_flat, unravel, f_flat = _flat_problem(f, y0)
    n, dev = y0_flat.numel(), y0_flat.device
    if mem is not None:
        mem.register("adams.anderson", (2 * fps.m, n), y0_flat.dtype)
    t, tf_t = _time(t0, dev), _time(tf, dev)
    t_host, tf_host = float(t0), float(tf)
    h = _time(opts.h0, dev) if opts.h0 > 0 else _initial_h(
        lambda tt, y: unravel(f_flat(tt, _ravel(y)[0].reshape(-1))),
        t, y0, tf_t, opts.rtol, opts.atol, pol)
    p = _time(3, dev)                   # the controller's exponent
    one = torch.ones((), dtype=_F64, device=dev)
    cst = ctrl.ControllerState(one, one)
    y, fprev = y0_flat, torch.zeros_like(y0_flat)
    n_, last_h, give_up = _Counts(), h, False
    while (t_host < tf_host * (1 - 1e-12) - 1e-300
           and n_.attempts < opts.max_steps and not give_up):
        h_use = torch.minimum(h, tf_t - t)
        fn = f_flat(t, y)
        # AB2 predictor; Euler on the first step (no valid fprev yet)
        if n_.steps == 0:
            y_pred = y + h_use * fn
        else:
            y_pred = y + h_use * (1.5 * fn - 0.5 * fprev)
        t_new = t + h_use

        def gfun(z, y=y, fn=fn, h_use=h_use, t_new=t_new):
            return y + 0.5 * h_use * (fn + f_flat(t_new, z))

        z, fst = fps.solve(gfun, y_pred)
        w = 1.0 / (opts.rtol * y.abs() + opts.atol)
        err = dv.wrms_norm(z - y_pred, w, pol) / 6.0
        bad = ~torch.isfinite(err)
        if not fst.converged:
            bad = torch.ones_like(bad)
        err = torch.where(bad, 2.0, err)
        accept = (err <= 1.0) & ~bad
        eta, cst_new = ctrl.eta_from_error(opts.controller, cst, err, p,
                                           after_failure=~accept)
        if not fst.converged:
            eta = torch.full_like(eta, opts.eta_cf)
        cst = ctrl.ControllerState(*(torch.where(accept, a, b)
                                     for a, b in zip(cst_new, cst)))
        t = torch.where(accept, t_new, t)
        y = torch.where(accept, z, y)
        fprev = torch.where(accept, fn, fprev)
        h = torch.clamp(h_use * eta, min=opts.hmin, max=opts.hmax)
        last_h = h_use
        loop_counts["step_trips"] += 1
        acc, give_up, t_host = read(torch.stack([
            accept.to(_F64), (h_use * eta < 1e-14).to(_F64), t]))
        acc, give_up = bool(acc), bool(give_up)
        n_.steps += acc
        n_.attempts += 1
        n_.nfe += 2 + fst.iters
        n_.netf += not acc
    return unravel(y), n_.stats(last_h, t, t_host >= tf_host * (1 - 1e-10),
                                dev)
