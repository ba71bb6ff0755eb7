"""ObservabilityConfig: the one switchboard for the SUNLogger and
SUNProfiler analogs.

Counterpart of ``repro.observability.config``, with the same fields and
defaults.  Everything is off by default, and then ``integrate`` takes
the code path it takes without this package: no ring, no profiler
region, no log event.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ObservabilityConfig:
    """Per-:class:`~repro_torch.core.context.Context` switches.

    profile            : the SUNProfiler analog (``ctx.profiler``):
                         regions around ``integrate``'s build and
                         execute stages, and ``Solution.timings``.
    profile_sync       : synchronise the profiler's device at region
                         exit, so queued device work is charged to the
                         region that launched it.
    telemetry          : record step telemetry (a ring of per-attempt
                         records on the solve's device) in the
                         ``bdf``, ``ensemble_dirk`` and ``ensemble_bdf``
                         loops, surfaced as ``Solution.telemetry``.
    telemetry_capacity : ring slots per integration; the ring reconciles
                         exactly with the Solution's counters while the
                         loop makes no more attempts than this.
    log_level          : the SUNLogger analog (``ctx.logger``) at this
                         level ("ERROR" | "WARNING" | "INFO" | "DEBUG");
                         None keeps it off.
    log_path           : an optional JSON-lines file for the events
                         (they are also kept in a bounded deque).
    """

    profile: bool = False
    profile_sync: bool = True
    telemetry: bool = False
    telemetry_capacity: int = 512
    log_level: Optional[str] = None
    log_path: Optional[str] = None

    @property
    def enabled(self) -> bool:
        """Any instrumentation on at all?"""
        return bool(self.profile or self.telemetry
                    or self.log_level is not None)
