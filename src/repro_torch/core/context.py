"""SUNContext analog: one object owning the run-wide execution state.

Counterpart of ``repro.core.context.Context``: the
:class:`~repro_torch.core.policies.ExecPolicy`, the
:class:`~repro_torch.core.memory.MemoryHelper` (SUNMemoryHelper), the
run-wide counters accumulated across ``integrate`` calls, and the
observability switchboard with its lazily built profiler and logger
(SUNProfiler, SUNLogger).  ``trace_cache`` is the slot a
:class:`~repro_torch.serve.solver.SolverServer` fills with its bundle
cache, so ``observability.context_metrics`` exports the cache's
counters.  ``autotune`` and ``dispatch_report`` front the ``"auto"``
resolver of the policy's device (:mod:`repro_torch.core.autotune`).
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
    #: the bundle cache of the SolverServer built on this context (its
    #: constructor sets it); None without a server
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

    # -- cost-model-driven dispatch ("auto") ----------------------------------

    @property
    def autotune(self) -> Any:
        """The :class:`~repro_torch.core.autotune.Resolver` of this
        context's policy (``policy.device_name()``: ``"cpu"`` for a CPU
        device, else the card's row, or ``"no-row"``), which
        loads the row's persisted cache at first use.  Resolvers are
        process-wide per row (the policy stays a hashable value), so the
        context fronts the one resolver, not a copy of it."""
        from . import autotune
        return autotune.get_resolver(self.policy.device_name())

    def dispatch_report(self) -> dict:
        """Every ``"auto"`` decision made for this context's row (per
        signature: backend, source, hits), with the model's audit over
        the row's whole cache (agreement, mispredictions); with the
        trace cache's counters under ``"trace_cache"`` when a
        :class:`~repro_torch.serve.solver.SolverServer` owns the
        context."""
        report = dict(self.autotune.report())
        if self.trace_cache is not None:
            report["trace_cache"] = self.trace_cache.stats()
        return report

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
