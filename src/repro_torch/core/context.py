"""SUNContext analog: the policy, the memory helper and run-wide counters.

Counterpart of ``repro.core.context.Context`` without the observability,
autotune and trace-cache parts (ROADMAP queue A items 9, 10 and 12).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .memory import MemoryHelper
from .policies import DEFAULT, ExecPolicy


def _counter_dict():
    return {"integrations": 0, "steps": 0, "step_attempts": 0,
            "newton_iters": 0, "lin_iters": 0}


@dataclass
class Context:
    """ExecPolicy + MemoryHelper + run-wide counters."""

    policy: ExecPolicy = DEFAULT
    memory: MemoryHelper = field(default_factory=MemoryHelper)
    counters: dict = field(default_factory=_counter_dict)

    def options(self, **kw) -> Any:
        """:class:`~repro_torch.core.arkode.ODEOptions` bound to this
        context's policy (kwargs override any field, including policy)."""
        from .arkode import ODEOptions
        kw.setdefault("policy", self.policy)
        return ODEOptions(**kw)

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
