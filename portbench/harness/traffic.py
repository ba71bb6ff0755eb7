"""The one traffic generator: the calls a cell makes.

A solve integrates every group from the configuration's start ``t0``
through its output times, one ``integrate`` call an output, as the
configuration's source reports its solution.  Its ``t1``, ``tmult``
and ``nout`` (CVODE's examples' ``T1``, ``TMULT``, ``NOUT``) put the
outputs at ``t1 * tmult^k``, ``k = 0 .. nout - 1``.

The first call of a solve starts cold from the inputs' ``y0``; each
later one resumes the solver session the call before it returned, so a
solve is one integration that stops at each output.  The mix
(``workloads/<traffic>.json``) gives ``nsys``, the groups each call
advances, and ``checked_lanes``, how many lanes, drawn from the seed,
are compared with the reference after the window.

Solves run back to back; the generator never ends, the window stops it
after a solve's last call.
"""
from __future__ import annotations

import itertools
from typing import Iterator, NamedTuple


class Call(NamedTuple):
    index: int      # position in the run
    seq: int        # solve number
    t0: float
    t1: float
    cold: bool      # the solve's first call, from y0
    last: bool      # the solve's last call


def outputs(cfg: dict) -> list:
    """The output times of one solve, increasing."""
    t0, t1, nout = float(cfg["t0"]), float(cfg["t1"]), int(cfg["nout"])
    outs = [t1 * float(cfg["tmult"]) ** k for k in range(nout)]
    if nout < 1 or any(b <= a for a, b in zip([t0] + outs, outs)):
        raise ValueError(f"output times {outs} do not increase from {t0}")
    return outs


def calls(cfg: dict) -> Iterator[Call]:
    outs = outputs(cfg)
    starts = [float(cfg["t0"])] + outs[:-1]
    index = 0
    for seq in itertools.count():
        for k, (t0, t1) in enumerate(zip(starts, outs)):
            yield Call(index, seq, t0, t1, k == 0, k == len(outs) - 1)
            index += 1
