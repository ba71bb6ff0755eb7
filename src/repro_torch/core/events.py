"""Root finding / event detection (the CVodeRootInit analog).

Counterpart of ``repro.core.events`` (``events.py:29-154``): integrate
with the adaptive ERK step of :mod:`repro_torch.core.arkode`, after
each accepted step look for a sign change of any component of
``g(t, y)`` over the step, and localize the first root by bisection on
the cubic Hermite interpolant of the step (y and f at both ends, the
dense output CVODE uses between mesh points).

The reference's ``lax.while_loop`` is a host loop: each step attempt
ends with ONE device->host read of ``(accept, crossed, t)`` (counted in
:data:`repro_torch.core.loops.loop_counts`), and the reference's
``lax.cond`` around the localization becomes a host branch on it.  The
bisection runs its ``n_bisect`` halvings on the device with no read.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import controller as ctrl
from . import dispatch as dv
from . import vector as nv
from .arkode import (ODEOptions, _device, _erk_step, _ewt, _F64,
                     _initial_h, _time)
from .butcher import ButcherTable
from .loops import loop_counts, read


class EventResult(NamedTuple):
    t_event: torch.Tensor     # time of the first root (or tf if none)
    y_event: object           # state at the root
    found: torch.Tensor       # bool
    which: torch.Tensor       # index of the triggered g_i
    steps: torch.Tensor


def _hermite(t0, y0, f0, t1, y1, f1, t):
    """Cubic Hermite dense output on [t0, t1] (CVODE's interpolant)."""
    h = t1 - t0
    s = (t - t0) / h
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s * s * (3 - 2 * s)
    h11 = s * s * (s - 1)
    return nv.tmap(
        lambda a, fa, b, fb: h00 * a + h10 * h * fa + h01 * b + h11 * h * fb,
        y0, f0, y1, f1)


def _g(g, t, y) -> torch.Tensor:
    return torch.atleast_1d(g(t, y))


def erk_integrate_with_events(f: Callable, g: Callable, y0, t0, tf,
                              table: ButcherTable,
                              opts: ODEOptions = ODEOptions(),
                              n_bisect: int = 40) -> EventResult:
    """Integrate y' = f(t, y), stopping at the first root of any
    component of the vector-valued ``g(t, y)``.  Returns the event, or
    ``tf`` with ``found`` False."""
    dev = _device(y0)
    pol = opts.policy
    t, tf_t = _time(t0, dev), _time(tf, dev)
    t_host, tf_host = float(t0), float(tf)
    h = _time(opts.h0, dev) if opts.h0 > 0 else _initial_h(
        f, t, y0, tf_t, opts.rtol, opts.atol, pol)
    p = _time(max(table.emb_order + 1, 2), dev)
    one = torch.ones((), dtype=_F64, device=dev)
    cst = ctrl.ControllerState(one, one)
    y, gv = y0, _g(g, t, y0)
    steps, attempts, found = 0, 0, False
    hit_t = tf_t
    hit_which = torch.zeros((), dtype=torch.int32, device=dev)
    while (t_host < tf_host * (1 - 1e-12) - 1e-300 and not found
           and attempts < opts.max_steps):
        h_use = torch.minimum(h, tf_t - t)
        y_new, y_err, _ = _erk_step(f, t, y, h_use, table, pol)
        err = dv.wrms_norm(y_err, _ewt(y, opts.rtol, opts.atol), pol)
        bad = ~torch.isfinite(err)
        err = torch.where(bad, 2.0, err)
        accept = (err <= 1.0) & ~bad
        eta, cst_new = ctrl.eta_from_error(opts.controller, cst, err, p,
                                           after_failure=~accept)
        cst = ctrl.ControllerState(*(torch.where(accept, a, b)
                                     for a, b in zip(cst_new, cst)))
        t1 = t + h_use
        g1 = _g(g, t1, y_new)
        # a root lies in (t, t1] iff some component changes sign
        crossed = (torch.sign(gv) * torch.sign(g1) < 0) | (g1 == 0.0)
        any_cross = accept & crossed.any()
        loop_counts["step_trips"] += 1
        acc, cross, t1_host = read(torch.stack([
            accept.to(_F64), any_cross.to(_F64), t1]))
        if cross:
            which = torch.argmax(crossed.to(torch.int32)).to(torch.int32)
            f0, f1v = f(t, y), f(t1, y_new)
            lo, hi = t, t1
            for _ in range(n_bisect):
                mid = 0.5 * (lo + hi)
                gm = _g(g, mid, _hermite(t, y, f0, t1, y_new, f1v,
                                         mid))[which]
                glo = _g(g, lo, _hermite(t, y, f0, t1, y_new, f1v,
                                         lo))[which]
                same = torch.sign(gm) == torch.sign(glo)
                lo, hi = torch.where(same, mid, lo), torch.where(same, hi,
                                                                 mid)
            hit_t, hit_which, found = 0.5 * (lo + hi), which, True
        if acc:
            t, y, gv, t_host = t1, y_new, g1, t1_host
        h = torch.clamp(h_use * eta, min=opts.hmin, max=opts.hmax)
        steps += bool(acc)
        attempts += 1
    if found:
        # the state at the event: one ERK step from the last accepted
        # point (just past the root) back to it
        y_event = _erk_step(f, t, y, hit_t - t, table, pol)[0]
    else:
        y_event = y
    return EventResult(t_event=hit_t if found else tf_t, y_event=y_event,
                       found=torch.tensor(found, device=dev),
                       which=hit_which,
                       steps=torch.tensor(steps, dtype=torch.int32,
                                          device=dev))
