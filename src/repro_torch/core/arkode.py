"""ARKODE analog: adaptive explicit, implicit and IMEX additive Runge-Kutta.

Counterpart of ``repro.core.arkode`` (``arkode.py:35-429``).  The
integrators are written only against the vector ops of
:mod:`repro_torch.core.dispatch` (on the card: the linear-combination
kernel for stage sums, the WRMS kernel for the error test, the initial
step and the Newton convergence test) and the solver callbacks, the
paper's design point: the same integrator runs on any vector.

* :func:`erk_integrate`  — adaptive explicit RK (embedded pairs);
* :func:`dirk_integrate` — adaptive diagonally implicit RK + Newton;
* :func:`imex_integrate` — adaptive additive IMEX-ARK;
* ``*_fixed``            — fixed-step variants (convergence orders).

A state ``y`` is a tensor or a tuple of tensors.  Times and step sizes
are 0-d float64 tensors on the state's device, so every stage time and
coefficient is computed there.  The reference's ``lax.while_loop`` step
loop is a host loop: each step attempt ends with ONE device->host read
of ``(accept, give_up, t)`` as one small tensor, and each Newton
iteration with one read of its ``(converged, diverged)`` test
(:func:`repro_torch.core.kinsol.newton_solve`); both are counted in
:data:`repro_torch.core.loops.loop_counts` (``step_trips``,
``newton_trips``, ``host_syncs``), and the matrix-free Krylov solver
adds one read per restart cycle.  The counters of
:class:`IntegratorStats` are then host integers until the end, where
they become 0-d device tensors.  Every constant and every branch of the
reference is kept.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from . import controller as ctrl
from . import dispatch as dv
from . import vector as nv
from .butcher import ButcherTable, IMEXTable
from .controller import ControllerConfig
from .loops import loop_counts, read
from .nonlinsol import NewtonSolver
from .policies import DEFAULT, ExecPolicy

_F64 = torch.float64


class IntegratorStats(NamedTuple):
    steps: torch.Tensor         # accepted steps
    attempts: torch.Tensor      # step attempts
    nfe: torch.Tensor           # explicit RHS evals
    nfi: torch.Tensor           # implicit RHS evals
    nni: torch.Tensor           # Newton iterations
    netf: torch.Tensor          # error-test failures
    ncfn: torch.Tensor          # nonlinear convergence failures
    last_h: torch.Tensor
    t: torch.Tensor
    success: torch.Tensor
    retcode: Optional[torch.Tensor] = None   # not threaded (as in the
    # reference's ARKODE integrators)


class ODEOptions(NamedTuple):
    rtol: float = 1e-6
    atol: float = 1e-9
    h0: float = 0.0             # 0 -> auto
    hmin: float = 0.0
    hmax: float = math.inf
    max_steps: int = 100_000
    newton_max: int = 4
    newton_tol_fac: float = 0.1   # Newton tol = fac * (error-test tol 1.0)
    controller: ControllerConfig = ControllerConfig()
    eta_cf: float = 0.25          # h reduction after a Newton failure
    policy: ExecPolicy = DEFAULT  # kernel or plain version per op


def _device(y) -> torch.device:
    return nv.leaves(y)[0].device


def _dtype(y) -> torch.dtype:
    return functools.reduce(torch.promote_types,
                            (t.dtype for t in nv.leaves(y)))


def _time(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=_F64, device=device).reshape(())


def _tree_where(pred, a, b):
    return nv.tmap(lambda x, y: torch.where(pred, x, y), a, b)


def _ewt(y, rtol, atol):
    """SUNDIALS error weights: ewt_i = 1/(rtol*|y_i| + atol)."""
    return nv.tmap(lambda yl: 1.0 / (rtol * yl.abs() + atol), y)


def _initial_h(f, t0, y0, tf, rtol, atol, policy=None, norm=None):
    """Cheap h0 heuristic (Hairer-Wanner-style, simplified); t0 and tf
    are 0-d float64 tensors, the result is one too."""
    norm = norm or dv.wrms_norm
    w = _ewt(y0, rtol, atol)
    f0 = f(t0, y0)
    d0 = norm(y0, w, policy)
    d1 = norm(f0, w, policy)
    span = tf - t0
    h = torch.where(d1 > 1e-10, 0.01 * d0 / torch.clamp(d1, min=1e-10),
                    1e-6 * span).to(_F64)
    h = torch.clamp(h, min=1e-12 * span, max=0.1 * span)
    return torch.clamp(h, min=1e-14)


class _Counts:
    """The step loop's counters, host integers until :meth:`stats`."""

    def __init__(self):
        self.steps = self.attempts = self.nfe = self.nfi = 0
        self.nni = self.netf = self.ncfn = 0

    def stats(self, last_h, t, success: bool, device) -> IntegratorStats:
        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        return IntegratorStats(
            steps=i32(self.steps), attempts=i32(self.attempts),
            nfe=i32(self.nfe), nfi=i32(self.nfi), nni=i32(self.nni),
            netf=i32(self.netf), ncfn=i32(self.ncfn), last_h=last_h, t=t,
            success=torch.tensor(success, device=device))


def _go_on(t: float, tf: float, attempts: int, give_up: bool,
           opts: ODEOptions) -> bool:
    """The reference's loop condition, on host numbers."""
    return (t < tf * (1 - 1e-12) - 1e-300 and attempts < opts.max_steps
            and not give_up)


def _end(accept, give_up, t) -> tuple:
    """The step attempt's one host read: (accept, give_up, t)."""
    loop_counts["step_trips"] += 1
    acc, gu, t_host = read(torch.stack([accept.to(_F64), give_up.to(_F64),
                                        t]))
    return bool(acc), bool(gu), t_host


# ----------------------------------------------------------------------------
# Explicit RK
# ----------------------------------------------------------------------------


def _erk_step(f, t, y, h, table: ButcherTable, policy=None):
    """One explicit step: returns (y_new, y_err, nfe)."""
    s = table.stages
    ks = []
    for i in range(s):
        if i == 0:
            yi = y
        else:
            coeffs = [1.0] + [h * table.A[i][j] for j in range(i)]
            yi = dv.linear_combination(coeffs, [y] + ks, policy)
        ks.append(f(t + table.c[i] * h, yi))
    y_new = dv.linear_combination([1.0] + [h * bi for bi in table.b],
                                  [y] + ks, policy)
    if table.b_emb is not None:
        dcoef = [h * (bi - bh) for bi, bh in zip(table.b, table.b_emb)]
        y_err = dv.linear_combination(dcoef, ks, policy)
    else:
        y_err = nv.const_like(0.0, y)
    return y_new, y_err, s


def erk_integrate(f: Callable, y0, t0, tf, table: ButcherTable,
                  opts: ODEOptions = ODEOptions(), mem=None, norm=None):
    """Adaptive explicit RK from t0 to tf.  Returns (y(tf), stats).

    ``norm(v, w, policy)``: the WRMS norm of the error test and the
    initial step (None: ``dispatch.wrms_norm``); a state sharded across
    ranks passes one that reduces across them, so that every rank takes
    the same steps (``optim.gradflow``)."""
    norm = norm or dv.wrms_norm
    dev, dtype = _device(y0), _dtype(y0)
    if mem is not None:
        mem.register("erk.stages", (table.stages, nv.tree_size(y0)), dtype)
    t, tf_t = _time(t0, dev), _time(tf, dev)
    t_host, tf_host = float(t0), float(tf)
    h = _time(opts.h0, dev) if opts.h0 > 0 else _initial_h(
        f, t, y0, tf_t, opts.rtol, opts.atol, opts.policy, norm)
    p = _time(max(table.emb_order + 1, 2), dev)   # controller exponent
    one = torch.ones((), dtype=_F64, device=dev)
    cst = ctrl.ControllerState(one, one)
    y, n, last_h, give_up = y0, _Counts(), h, False
    while _go_on(t_host, tf_host, n.attempts, give_up, opts):
        h_use = torch.minimum(h, tf_t - t)
        y_new, y_err, nfe = _erk_step(f, t, y, h_use, table, opts.policy)
        w = _ewt(y, opts.rtol, opts.atol)
        err = norm(y_err, w, opts.policy)
        # guard NaN/Inf: treat as a failed step
        bad = ~torch.isfinite(err)
        err = torch.where(bad, 2.0, err)
        accept = (err <= 1.0) & ~bad
        eta, cst_new = ctrl.eta_from_error(opts.controller, cst, err, p,
                                           after_failure=~accept)
        cst = ctrl.ControllerState(*(torch.where(accept, a, b)
                                     for a, b in zip(cst_new, cst)))
        t = torch.where(accept, t + h_use, t)
        y = _tree_where(accept, y_new, y)
        h = torch.clamp(h_use * eta, min=opts.hmin, max=opts.hmax)
        give_up_t = h_use * eta < 1e-14
        if opts.hmin > 0:
            give_up_t = give_up_t | (h <= opts.hmin)
        last_h = h_use
        acc, give_up, t_host = _end(accept, give_up_t, t)
        n.steps += acc
        n.attempts += 1
        n.nfe += nfe
        n.netf += not acc
    return y, n.stats(last_h, t, t_host >= tf_host * (1 - 1e-10), dev)


def erk_fixed(f: Callable, y0, t0, tf, n_steps: int, table: ButcherTable,
              policy: Optional[ExecPolicy] = None):
    """Fixed-step ERK (convergence-order tests)."""
    h = (tf - t0) / n_steps
    t, y = _time(t0, _device(y0)), y0
    for _ in range(n_steps):
        y, _, _ = _erk_step(f, t, y, h, table, policy)
        t = t + h
    return y


# ----------------------------------------------------------------------------
# Implicit stage machinery (shared by DIRK and IMEX)
# ----------------------------------------------------------------------------


def default_lin_solver(fi: Callable, policy: Optional[ExecPolicy] = None):
    """Matrix-free Newton linear solver (legacy helper): the bound form
    of :class:`repro_torch.core.linsol.SPGMR`."""
    from .linsol import SPGMR
    return SPGMR().bind(fi, policy=policy)


def dense_lin_solver(fi: Callable):
    """Direct dense Newton solver via jacfwd (legacy helper): the bound
    form of :class:`repro_torch.core.linsol.DenseGJ`."""
    from .linsol import DenseGJ
    return DenseGJ().bind(fi)


def _bind_lin_solver(lin_solver, fi, opts, mem=None):
    """lin_solver (LinearSolver object | legacy callable | None) as the
    callable ``(t, z, gamma, rhs) -> dz``."""
    from .linsol import SPGMR, as_lin_solve
    return as_lin_solve(lin_solver, fi, policy=opts.policy, mem=mem,
                        default=SPGMR())


def _implicit_stage(fi, t_i, r, h_aii, z0, lin_solve, wnorm, opts,
                    nls: Optional[NewtonSolver] = None):
    """Solve z = r + h*aii*fi(t_i, z) by Newton; returns (z, iters, ok)
    with host ``iters`` and ``ok``."""
    gamma = h_aii
    nls = nls or NewtonSolver.from_options(opts)

    def gfun(z):
        return dv.linear_combination([1.0, -gamma, -1.0],
                                     [z, fi(t_i, z), r], opts.policy)

    def nlin_solve(z, rhs):
        return lin_solve(t_i, z, gamma, rhs)

    z, st = nls.solve(gfun, z0, nlin_solve, wnorm=wnorm, policy=opts.policy)
    return z, st.iters, st.converged


# ----------------------------------------------------------------------------
# IMEX-ARK (and DIRK as the fe=0 special case)
# ----------------------------------------------------------------------------


def _ark_step(fe, fi, t, y, h, tab: IMEXTable, lin_solve, wnorm, opts,
              nls: Optional[NewtonSolver] = None):
    """One additive RK step: (y_new, y_err, nfe, nfi, nni, ok), the
    counts and ``ok`` on the host.  Every stage runs, as in the
    reference, even after a stage's Newton failed."""
    AE, AI = tab.expl.A, tab.impl.A
    bE, bI = tab.expl.b, tab.impl.b
    cE, cI = tab.expl.c, tab.impl.c
    s = tab.impl.stages
    kE, kI = [], []
    nni, ok = 0, True
    for i in range(s):
        coeffs, vecs = [1.0], [y]
        for j in range(i):
            if AE[i][j] != 0.0:
                coeffs.append(h * AE[i][j])
                vecs.append(kE[j])
            if AI[i][j] != 0.0:
                coeffs.append(h * AI[i][j])
                vecs.append(kI[j])
        r = dv.linear_combination(coeffs, vecs, opts.policy)
        aii = AI[i][i]
        if aii == 0.0:
            z = r
        else:
            z, it, conv = _implicit_stage(fi, t + cI[i] * h, r, h * aii, r,
                                          lin_solve, wnorm, opts, nls)
            nni += it
            ok = ok and conv
        kE.append(fe(t + cE[i] * h, z))
        kI.append(fi(t + cI[i] * h, z))
    y_new = dv.linear_combination(
        [1.0] + [h * b for b in bE] + [h * b for b in bI],
        [y] + kE + kI, opts.policy)
    if tab.expl.b_emb is not None:
        dE = [h * (b - bh) for b, bh in zip(bE, tab.expl.b_emb)]
        dI = [h * (b - bh) for b, bh in zip(bI, tab.impl.b_emb)]
        y_err = dv.linear_combination(dE + dI, kE + kI, opts.policy)
    else:
        y_err = nv.const_like(0.0, y)
    # fi evals: one per stage k_I plus one per Newton iteration (G eval)
    return y_new, y_err, s, s + nni, nni, ok


def imex_integrate(fe: Callable, fi: Callable, y0, t0, tf, tab: IMEXTable,
                   opts: ODEOptions = ODEOptions(),
                   lin_solver: Optional[Callable] = None,
                   nonlin_solver: Optional[NewtonSolver] = None, mem=None):
    """Adaptive IMEX-ARK: y' = fe(t,y) + fi(t,y); fe explicit, fi implicit.

    ``lin_solver`` is a :class:`repro_torch.core.linsol.LinearSolver`
    or a callable ``(t, z, gamma, rhs) -> dz`` solving
    (I - gamma*J_fi) dz = rhs; the default is matrix-free SPGMR.
    ``nonlin_solver`` defaults to the ODEOptions Newton tolerances;
    ``mem`` is an optional :class:`~repro_torch.core.memory.MemoryHelper`.
    Returns (y(tf), stats).
    """
    lin_solve = _bind_lin_solver(lin_solver, fi, opts, mem)
    nls = nonlin_solver or NewtonSolver.from_options(opts)
    dev, dtype = _device(y0), _dtype(y0)
    if mem is not None:
        mem.register("ark.stages", (2 * tab.impl.stages, nv.tree_size(y0)),
                     dtype)
    pol = opts.policy
    t, tf_t = _time(t0, dev), _time(tf, dev)
    t_host, tf_host = float(t0), float(tf)

    def ftot(t, y):
        return dv.linear_sum(1.0, fe(t, y), 1.0, fi(t, y), pol)

    h = _time(opts.h0, dev) if opts.h0 > 0 else _initial_h(
        ftot, t, y0, tf_t, opts.rtol, opts.atol, pol)
    p = _time(max(tab.emb_order + 1, 2), dev)
    one = torch.ones((), dtype=_F64, device=dev)
    cst = ctrl.ControllerState(one, one)
    y, n, last_h, give_up = y0, _Counts(), h, False
    while _go_on(t_host, tf_host, n.attempts, give_up, opts):
        h_use = torch.minimum(h, tf_t - t)
        w = _ewt(y, opts.rtol, opts.atol)

        def wnorm(v, w=w):
            return dv.wrms_norm(v, w, pol)

        y_new, y_err, nfe, nfi, nni, nl_ok = _ark_step(
            fe, fi, t, y, h_use, tab, lin_solve, wnorm, opts, nls)
        err = dv.wrms_norm(y_err, w, pol)
        bad = ~torch.isfinite(err)
        if not nl_ok:
            bad = torch.ones_like(bad)
        err = torch.where(bad, 2.0, err)
        accept = (err <= 1.0) & ~bad
        eta, cst_new = ctrl.eta_from_error(
            opts.controller, cst, err, p,
            after_failure=~accept if nl_ok else torch.zeros_like(accept))
        if not nl_ok:       # Newton failure: ARKODE's fixed shrink etacf
            eta = torch.full_like(eta, opts.eta_cf)
        cst = ctrl.ControllerState(*(torch.where(accept, a, b)
                                     for a, b in zip(cst_new, cst)))
        t = torch.where(accept, t + h_use, t)
        y = _tree_where(accept, y_new, y)
        h = torch.clamp(h_use * eta, min=opts.hmin, max=opts.hmax)
        last_h = h_use
        acc, give_up, t_host = _end(accept, h_use * eta < 1e-14, t)
        n.steps += acc
        n.attempts += 1
        n.nfe += nfe
        n.nfi += nfi
        n.nni += nni
        n.netf += (not acc) and nl_ok
        n.ncfn += not nl_ok
    return y, n.stats(last_h, t, t_host >= tf_host * (1 - 1e-10), dev)


def _dirk_as_imex(table: ButcherTable) -> IMEXTable:
    """The DIRK table with a zero explicit partner."""
    s = table.stages
    return IMEXTable(expl=ButcherTable(A=[[0.0] * s for _ in range(s)],
                                       b=[0.0] * s, c=table.c,
                                       order=table.order,
                                       b_emb=([0.0] * s if table.b_emb
                                              is not None else None),
                                       emb_order=table.emb_order),
                     impl=table, order=table.order,
                     emb_order=table.emb_order)


def _zero_rhs(t, y):
    return nv.const_like(0.0, y)


def dirk_integrate(fi: Callable, y0, t0, tf, table: ButcherTable,
                   opts: ODEOptions = ODEOptions(),
                   lin_solver: Optional[Callable] = None,
                   nonlin_solver: Optional[NewtonSolver] = None, mem=None):
    """Adaptive DIRK for stiff y' = fi(t, y) (zero explicit part)."""
    return imex_integrate(_zero_rhs, fi, y0, t0, tf, _dirk_as_imex(table),
                          opts, lin_solver, nonlin_solver=nonlin_solver,
                          mem=mem)


def imex_fixed(fe, fi, y0, t0, tf, n_steps: int, tab: IMEXTable,
               lin_solver: Optional[Callable] = None,
               opts: ODEOptions = ODEOptions(newton_max=12)):
    """Fixed-step IMEX (convergence tests); the Newton tolerance is
    tightened so the nonlinear solve never pollutes the measured
    order."""
    lin_solve = _bind_lin_solver(lin_solver, fi, opts)
    h = (tf - t0) / n_steps

    def wnorm(v):
        return torch.sqrt(dv.dot(v, v, opts.policy) / nv.tree_size(v))

    o = opts._replace(newton_tol_fac=1e-10, newton_max=12)
    t, y = _time(t0, _device(y0)), y0
    for _ in range(n_steps):
        y, *_ = _ark_step(fe, fi, t, y, h, tab, lin_solve, wnorm, o)
        t = t + h
    return y


def dirk_fixed(fi, y0, t0, tf, n_steps, table: ButcherTable,
               lin_solver=None):
    return imex_fixed(_zero_rhs, fi, y0, t0, tf, n_steps,
                      _dirk_as_imex(table), lin_solver)
