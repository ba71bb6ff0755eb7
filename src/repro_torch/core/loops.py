"""Counted device->host reads of the port's host loops.

The reference runs its step, Newton and Krylov loops as
``lax.while_loop``s on the device; the port runs them as Python loops
that read each loop condition with ONE device->host sync per trip
(:func:`read`).  :data:`loop_counts` sums those reads and the loops'
trip counts over every call since the last :func:`reset_loop_counts`
(``batched.loop_counts`` is the same dict), and the ensemble BDF's
lsetups (each one call of the solver's ``soa_setup``).

:func:`region` marks a hot loop's trip (the ensemble integrators'
Newton iterations): :data:`regions` holds the names of the regions the
host is in, innermost last, and sunlint's dispatch walker
(``analysis/hotloop.py``) reads it to keep the ops of those trips.  It
costs a list append and pop a trip and touches no tensor.
"""
from __future__ import annotations

import contextlib

import torch

loop_counts = {"host_syncs": 0, "step_trips": 0, "newton_trips": 0,
               "krylov_trips": 0, "lsetups": 0}


def reset_loop_counts() -> None:
    for key in loop_counts:
        loop_counts[key] = 0


def read(x: torch.Tensor):
    """One counted device->host read of a small tensor."""
    loop_counts["host_syncs"] += 1
    return x.tolist()


#: names of the hot-loop regions the host is in, innermost last
regions: list = []


@contextlib.contextmanager
def region(name: str):
    """Mark the ops run inside the ``with`` block as one trip of the hot
    loop ``name``."""
    regions.append(name)
    try:
        yield
    finally:
        regions.pop()
