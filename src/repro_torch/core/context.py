"""SUNContext analog: one object owning the run-wide execution state.

Counterpart of ``repro.core.context.Context``: the
:class:`~repro_torch.core.policies.ExecPolicy`, the
:class:`~repro_torch.core.memory.MemoryHelper` (SUNMemoryHelper), the
run-wide counters accumulated across ``integrate`` calls, and the
observability switchboard with its lazily built profiler and logger
(SUNProfiler, SUNLogger).  ``trace_cache`` stays None until the serving
tier exists (ROADMAP queue A.5); ``autotune`` and ``dispatch_report``
wait for the autotuner (A.8) and raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..observability.config import ObservabilityConfig
from .memory import MemoryHelper
from .policies import DEFAULT, ExecPolicy


def _counter_dict():
    return {"integrations": 0, "steps": 0, "step_attempts": 0,
            "newton_iters": 0, "lin_iters": 0}


@dataclass
class Context:
    """ExecPolicy + MemoryHelper + run-wide counters + observability."""

    policy: ExecPolicy = DEFAULT
    memory: MemoryHelper = field(default_factory=MemoryHelper)
    counters: dict = field(default_factory=_counter_dict)
    #: the serving tier's trace cache (ROADMAP queue A.5); None here
    trace_cache: Optional[Any] = None
    #: observability switchboard, everything off by default
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    _profiler: Optional[Any] = field(default=None, repr=False,
                                     compare=False)
    _logger: Optional[Any] = field(default=None, repr=False,
                                   compare=False)

    # -- observability singletons (SUNProfiler / SUNLogger analogs) ----------

    @property
    def profiler(self) -> Any:
        """The context's :class:`~repro_torch.observability.profiler.
        Profiler`, built on first use from :attr:`observability` (a
        disabled one when ``profile=False``); it synchronises the
        policy's device (None: the card)."""
        if self._profiler is None:
            from ..observability.profiler import Profiler
            obs = self.observability
            self._profiler = Profiler(enabled=obs.profile,
                                      sync=obs.profile_sync,
                                      device=self.policy.device)
        return self._profiler

    @property
    def logger(self) -> Any:
        """The context's :class:`~repro_torch.observability.logger.
        EventLogger` (dropping every event when ``log_level`` is None)."""
        if self._logger is None:
            from ..observability.logger import EventLogger
            obs = self.observability
            self._logger = EventLogger(level=obs.log_level,
                                       path=obs.log_path)
        return self._logger

    def options(self, **kw) -> Any:
        """:class:`~repro_torch.core.arkode.ODEOptions` bound to this
        context's policy (kwargs override any field, including policy)."""
        from .arkode import ODEOptions
        kw.setdefault("policy", self.policy)
        return ODEOptions(**kw)

    # -- cost-model-driven dispatch (ROADMAP queue A.8) -----------------------

    @property
    def autotune(self) -> Any:
        raise NotImplementedError("the autotuner waits for ROADMAP queue "
                                  "A.8")

    def dispatch_report(self) -> dict:
        raise NotImplementedError("dispatch_report waits for the autotuner, "
                                  "ROADMAP queue A.8")

    # -- counter accumulation ------------------------------------------------

    def record(self, stats: Any, nli=None) -> None:
        """Fold one integration's per-system stats into the counters."""
        self.counters["integrations"] += 1
        for key, name in (("steps", "steps"),
                          ("step_attempts", "attempts"),
                          ("newton_iters", "nni")):
            v = getattr(stats, name, None)
            if v is not None:
                self.counters[key] += int(v.sum())
        if nli is not None:
            self.counters["lin_iters"] += int(nli)
