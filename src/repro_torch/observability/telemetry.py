"""Step telemetry: a bounded ring of per-attempt records on the solve's
device, written by the step loops.

Counterpart of ``repro.observability.telemetry``.  One record per step
attempt, per system::

    (t, h, q, newton_iters, err_ratio, lsetup_fired, converged,
     accepted, active)

``t`` and ``h`` are the attempt's target time and step size, ``q`` the
BDF order before the attempt (the method's order for DIRK), ``err_ratio``
the weighted local-error ratio the accept test compared with 1, and the
flags the lsetup trigger, Newton convergence, the accept decision and
whether the system was integrating at all.

The reference threads the ring through a ``lax.while_loop`` carry and
writes slot ``idx % K`` with ``.at[].set``.  The port's step loops are
host loops that know their trip count, so ``idx`` is a host integer and
:func:`ring_record` is nine slice stores into device tensors: no host
read, and each record copies values the step computed anyway.

:class:`StepTelemetry` (``Solution.telemetry``) keeps its per-record
tensors on the ring's device, in chronological order, and reduces there;
``summary()`` moves only its results to the host.  While the ring has
not wrapped its records are views of the ring, not a copy.

This module imports nothing of ``repro_torch.core``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

#: record field order, as passed to :func:`ring_record`
RECORD_FIELDS = ("t", "h", "q", "nni", "err", "lsetup", "conv",
                 "accept", "active")

#: bins of the log10 h histogram of :meth:`StepTelemetry.summary`
H_BINS = 12


class TelemetryRing(NamedTuple):
    """The ring: ``idx`` counts the records ever written (a host int);
    each field buffer is ``(capacity,) + tail`` with ``tail`` ``()`` for
    scalar integrators and ``(nsys,)`` for ensembles."""

    idx: int
    t: torch.Tensor         # attempt target time
    h: torch.Tensor         # attempted step size
    q: torch.Tensor         # int32 order
    nni: torch.Tensor       # int32 Newton iterations this attempt
    err: torch.Tensor       # weighted local-error ratio
    lsetup: torch.Tensor    # bool: lsetup trigger fired
    conv: torch.Tensor      # bool: Newton converged
    accept: torch.Tensor    # bool: step accepted
    active: torch.Tensor    # bool: system still integrating

    @property
    def capacity(self) -> int:
        return int(self.t.shape[0])


def ring_init(capacity: int, tail_shape: Tuple[int, ...], dtype,
              device) -> TelemetryRing:
    """A zeroed ring of ``capacity`` slots on ``device``."""
    K = int(capacity)
    if K < 1:
        raise ValueError(f"telemetry capacity must be >= 1; got {K}")
    shape = (K,) + tuple(tail_shape)

    def zeros(dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return TelemetryRing(
        idx=0, t=zeros(dtype), h=zeros(dtype), q=zeros(torch.int32),
        nni=zeros(torch.int32), err=zeros(dtype), lsetup=zeros(torch.bool),
        conv=zeros(torch.bool), accept=zeros(torch.bool),
        active=zeros(torch.bool))


def ring_record(ring: TelemetryRing, rec: Sequence) -> TelemetryRing:
    """Store one record (values ordered as :data:`RECORD_FIELDS`;
    tensors on the ring's device or Python scalars, broadcast over the
    tail) in slot ``idx % capacity``, overwriting the oldest record once
    the ring is full.  The stores are queued on the device; nothing is
    read back."""
    slot = ring.idx % ring.capacity
    for buf, v in zip(ring[1:], rec):
        buf[slot] = v
    return ring._replace(idx=ring.idx + 1)


class StepTelemetry:
    """A completed integration's ring, in chronological order (what
    ``Solution.telemetry`` holds).

    Per-record tensors (``t``, ``h``, ``q``, ``newton_iters``,
    ``err_ratio``, ``lsetup_fired``, ``converged``, ``accepted``,
    ``active``) have shape ``(records,)`` for scalar integrators or
    ``(records, nsys)`` for ensembles, on the ring's device.  With a
    ``live`` mask (a padded bundle) dead lanes are zeroed out of every
    count, as ``EnsembleStats.masked`` zeroes the stats.
    """

    def __init__(self, ring: TelemetryRing, live=None):
        idx = int(ring.idx)
        K = ring.capacity
        self.capacity = K
        self.total_records = idx
        self.truncated = idx > K
        self.records = min(idx, K)
        if self.truncated:
            # the oldest surviving record lives at slot idx % K
            s = idx % K
            take = lambda buf: torch.cat([buf[s:], buf[:s]])
        else:
            take = lambda buf: buf[:self.records]
        self.t = take(ring.t)
        self.h = take(ring.h)
        self.q = take(ring.q)
        self.newton_iters = take(ring.nni)
        self.err_ratio = take(ring.err)
        self.lsetup_fired = take(ring.lsetup)
        self.converged = take(ring.conv)
        self.accepted = take(ring.accept)
        self.active = take(ring.active)
        self.live = None if live is None else torch.as_tensor(
            live, dtype=torch.bool, device=ring.t.device)
        if self.live is not None and self.t.ndim == 2:
            live_b = self.live[None, :]
            self.newton_iters = torch.where(live_b, self.newton_iters, 0)
            for name in ("lsetup_fired", "accepted", "active", "converged"):
                setattr(self, name, getattr(self, name) & live_b)

    # -- reconciliation surface (axis 0 = records), on the device -----------

    def steps(self) -> torch.Tensor:
        """Accepted steps per system (reconciles with ``stats.steps``
        while the ring was not truncated)."""
        return self.accepted.sum(dim=0)

    def attempts(self) -> torch.Tensor:
        return self.active.sum(dim=0)

    def newton_iters_total(self) -> torch.Tensor:
        return self.newton_iters.sum(dim=0)

    def lsetups(self) -> torch.Tensor:
        return self.lsetup_fired.sum(dim=0)

    def summary(self) -> dict:
        """The SUNLogger-style roll-up of the reference: totals, the
        histogram of log10 h over accepted steps (numpy's edges and
        last-bin rule), order occupancy, and the times where active
        systems failed to converge.  Computed on the device; only these
        results reach the host."""
        acc = self.accepted
        fail = self.active & ~self.converged
        steps, attempts, nni, lsetups, nfail = torch.stack([
            acc.sum(), self.active.sum(),
            self.newton_iters.sum(dtype=torch.int64),
            self.lsetup_fired.sum(), fail.sum()]).tolist()
        out = {"records": self.records, "capacity": self.capacity,
               "truncated": self.truncated, "steps": steps,
               "attempts": attempts, "newton_iters": nni,
               "lsetups": lsetups}
        if steps:
            logh = torch.log10(torch.clamp(self.h[acc], min=1e-300))
            lo, hi = torch.stack([logh.min(), logh.max()]).tolist()
            if hi - lo < 1e-12:
                hi = lo + 1e-12
            edges = np.linspace(lo, hi, H_BINS + 1)
            out["h_hist_log10"] = {"edges": edges.tolist(),
                                   "counts": _histogram(logh, lo, hi, edges)}
            occ = torch.bincount(self.q[acc].long()).tolist()
            out["order_occupancy"] = {q: n / steps for q, n in enumerate(occ)
                                      if n}
        else:
            out["h_hist_log10"] = {"edges": [], "counts": []}
            out["order_occupancy"] = {}
        out["newton_failures"] = nfail
        out["newton_failure_times"] = torch.unique(torch.round(
            self.t[fail], decimals=12))[:16].tolist() if nfail else []
        return out

    def __repr__(self) -> str:
        s = self.summary()
        return (f"StepTelemetry(records={s['records']}, "
                f"steps={s['steps']}, attempts={s['attempts']}, "
                f"newton_iters={s['newton_iters']}, "
                f"truncated={self.truncated})")


def _histogram(x: torch.Tensor, lo: float, hi: float, edges) -> list:
    """``np.histogram(x, bins=len(edges) - 1, range=(lo, hi))[0]`` on
    x's device, by numpy's own index rule: the scaled index, then one
    step down or up where it disagrees with the edges, the last bin
    closed on the right."""
    nb = len(edges) - 1
    e = torch.as_tensor(edges, dtype=x.dtype, device=x.device)
    idx = (((x - lo) / (hi - lo)) * nb).long()
    idx = torch.where(idx == nb, nb - 1, idx)
    idx = idx - (x < e[idx]).long()
    idx = idx + ((x >= e[idx + 1]) & (idx != nb - 1)).long()
    return torch.bincount(idx, minlength=nb).tolist()
