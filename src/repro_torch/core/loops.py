"""Counted device->host reads of the port's host loops.

The reference runs its step, Newton and Krylov loops as
``lax.while_loop``s on the device; the port runs them as Python loops
that read each loop condition with ONE device->host sync per trip
(:func:`read`).  :data:`loop_counts` sums those reads and the loops'
trip counts over every call since the last :func:`reset_loop_counts`
(``batched.loop_counts`` is the same dict).
"""
from __future__ import annotations

import torch

loop_counts = {"host_syncs": 0, "step_trips": 0, "newton_trips": 0,
               "krylov_trips": 0}


def reset_loop_counts() -> None:
    for key in loop_counts:
        loop_counts[key] = 0


def read(x: torch.Tensor):
    """One counted device->host read of a small tensor."""
    loop_counts["host_syncs"] += 1
    return x.tolist()
