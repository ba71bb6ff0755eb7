"""Shape-bucketed bundle cache: steady-state traffic builds nothing.

Counterpart of ``repro.serve.solver.trace_cache``.  The reference maps
each :class:`TraceKey` — (bucket key, padded nsys, ExecPolicy) — to an
AOT-compiled executable, because tracing and compiling one bundle
integration costs far more than running it.  Eager PyTorch has no trace
or compile step, so here an entry is a **prepared bundle runner** (see
``SolverServer._compile``): the family's callables bound to the bucket's
tolerance class, options, method, order and linear solver; ``build_s``,
the wall time of building it (the kernel libraries' load included); and
the ``Solution`` metadata (method, solver names, workspace bytes),
taken from the entry's first run.  The names ``TraceKey``, ``compile``
and ``serve.compile`` stay the reference's, as its metrics and spans
use them.

The cache and its counters are the reference's as they are: after the
warm-up window (the first touch of each key) every bundle is a hit, and
``steady_misses`` audits that.  Eviction is LRU with a bounded entry
count; an evicted key is rebuilt on its next touch, and counted.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional, Tuple

from .queue import BucketKey


class TraceKey(NamedTuple):
    """What one bundle runner is specialised on: the bucket key
    (family, n, method, tol class, dtype), the padded lane count, and
    the ExecPolicy (a hashable frozen dataclass: backend and device; a
    policy change is a different runner)."""

    bucket: BucketKey
    nsys: int
    policy: Any


class TraceCache:
    """LRU cache of bundle runners with hit/miss/evict accounting.

    ``get(key, build)`` returns ``(entry, hit)``; on a miss the
    ``build`` thunk is invoked (this is where the server builds the
    runner) and its result stored.  ``build=None`` makes a miss
    raise ``KeyError`` — the inspection path.
    """

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._entries: "OrderedDict[TraceKey, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: TraceKey) -> bool:
        return key in self._entries

    def keys(self) -> Tuple[TraceKey, ...]:
        return tuple(self._entries)

    def get(self, key: TraceKey,
            build: Optional[Callable[[], Any]] = None):
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry, True
        if build is None:
            raise KeyError(key)
        self.misses += 1
        entry = build()
        self._entries[key] = entry
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry, False

    def stats(self) -> dict:
        """The counters that ``context_metrics`` exports (the
        reference's ``Context.dispatch_report()`` embeds them too)."""
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "hit_rate": (self.hits / total) if total else 0.0}

    def clear(self) -> None:
        self._entries.clear()
