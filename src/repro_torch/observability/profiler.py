"""SUNProfiler analog: nestable, device-synchronising host region timers.

Counterpart of ``repro.observability.profiler``.  SUNProfiler brackets
named regions and, on GPU builds, synchronises the device before it
reads the clock, so work launched asynchronously is charged to the
region that launched it.  Here:

* ``with prof.region("integrate.execute"):`` — nestable regions; with
  ``sync`` on, exit calls ``torch.cuda.synchronize`` on the profiler's
  device (a no-op for a CPU device; on the card a failed synchronise
  raises);
* ``prof.add_span(name, t0, t1)`` — a span timed on another clock;
* ``prof.summary()`` / ``prof.render()`` — the per-region roll-up
  (count, total, mean, max);
* ``prof.chrome_trace()`` / ``prof.export_chrome_trace(path)`` — the
  spans as Chrome-trace JSON (chrome://tracing or Perfetto).

A disabled profiler hands out one shared no-op region and records
nothing.  An enabled, synchronising profiler runs on the card unless it
is given another device: without CUDA it raises, as the entry points do.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..core.policies import resolve_device


@dataclass(frozen=True)
class Span:
    """One closed region instance on the profiler's timebase."""

    name: str
    t0: float
    t1: float
    tid: int = 0            # OS thread ident (pump thread vs caller)
    depth: int = 0          # nesting depth at entry (render indent)
    cat: str = "host"
    args: Optional[dict] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _NullRegion:
    """The disabled-profiler region: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_REGION = _NullRegion()


def device_sync(device=None) -> Callable[[], None]:
    """The synchronise of ``device`` (None: the card): waits for every
    kernel queued there (SUNProfiler's ``cudaDeviceSynchronize``); a
    no-op for a CPU device.  Without CUDA, a CUDA device raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return lambda: None
    return lambda: torch.cuda.synchronize(dev)


class _Region:
    """An active region; created per ``with`` entry (regions nest)."""

    __slots__ = ("_prof", "name", "cat", "sync", "args", "_t0", "_depth",
                 "_tid")

    def __init__(self, prof: "Profiler", name: str, cat: str, sync: bool,
                 args: Optional[dict]):
        self._prof = prof
        self.name = name
        self.cat = cat
        self.sync = sync
        self.args = args

    def __enter__(self):
        tl = self._prof._tls
        self._depth = getattr(tl, "depth", 0)
        tl.depth = self._depth + 1
        self._tid = threading.get_ident()
        self._t0 = self._prof.clock()
        return self

    def __exit__(self, *exc):
        if self.sync:
            self._prof._sync()
        t1 = self._prof.clock()
        self._prof._tls.depth = self._depth
        self._prof.add_span(self.name, self._t0, t1, cat=self.cat,
                            args=self.args, tid=self._tid,
                            depth=self._depth)
        return False


class Profiler:
    """Region timers + span store (thread-safe appends; the serving
    pump thread and the caller thread interleave freely)."""

    def __init__(self, enabled: bool = True, sync: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 sync_fn: Optional[Callable[[], None]] = None,
                 device=None):
        """``sync_fn`` replaces the device synchronise; without one, the
        first region that synchronises takes :func:`device_sync` of
        ``device`` (None: the card)."""
        self.enabled = bool(enabled)
        self.sync = bool(sync)
        self.clock = clock
        self.device = device
        self._sync_fn = sync_fn
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.spans: List[Span] = []

    def _sync(self) -> None:
        if self._sync_fn is None:
            self._sync_fn = device_sync(self.device)
        self._sync_fn()

    # -- recording ---------------------------------------------------------

    def now(self) -> float:
        """The profiler timebase (for mapping foreign clocks onto it)."""
        return self.clock()

    def region(self, name: str, cat: str = "host",
               sync: Optional[bool] = None, **args):
        """A nestable timed region; no-op when disabled."""
        if not self.enabled:
            return _NULL_REGION
        return _Region(self, name, cat,
                       self.sync if sync is None else bool(sync),
                       args or None)

    def add_span(self, name: str, t0: float, t1: float, *,
                 cat: str = "host", args: Optional[dict] = None,
                 tid: Optional[int] = None, depth: int = 0) -> None:
        """Record one closed span on the profiler timebase (used for
        events timed elsewhere, e.g. serving queue wait per bundle)."""
        if not self.enabled:
            return
        span = Span(name=name, t0=float(t0), t1=float(t1),
                    tid=tid if tid is not None else threading.get_ident(),
                    depth=depth, cat=cat, args=args)
        with self._lock:
            self.spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self.spans = []

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, dict]:
        """Per-region roll-up: count / total_s / mean_s / max_s."""
        with self._lock:
            spans = list(self.spans)
        out: Dict[str, dict] = {}
        for s in spans:
            row = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += s.dur
            row["max_s"] = max(row["max_s"], s.dur)
        for row in out.values():
            row["mean_s"] = row["total_s"] / row["count"]
        return out

    def render(self) -> str:
        """The SUNProfiler-style text table, sorted by total time."""
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        width = max([len(name) for name, _ in rows] + [6])
        lines = [f"{'region':<{width}}  {'count':>7} {'total_s':>10} "
                 f"{'mean_s':>10} {'max_s':>10}"]
        for name, r in rows:
            lines.append(f"{name:<{width}}  {r['count']:>7d} "
                         f"{r['total_s']:>10.6f} {r['mean_s']:>10.6f} "
                         f"{r['max_s']:>10.6f}")
        return "\n".join(lines)

    def chrome_trace(self) -> dict:
        """Chrome-trace JSON (``traceEvents`` of complete ``"X"``
        events, microsecond timestamps relative to the first span) —
        loadable in chrome://tracing or Perfetto."""
        with self._lock:
            spans = list(self.spans)
        base = min((s.t0 for s in spans), default=0.0)
        tids = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.tid, len(tids) + 1)
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": (s.t0 - base) * 1e6, "dur": s.dur * 1e6,
                "pid": 1, "tid": tid, "args": dict(s.args or {})})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path
