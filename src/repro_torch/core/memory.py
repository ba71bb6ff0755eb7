"""Workspace accounting (the SUNMemoryHelper register/release audit).

Counterpart of the registration half of ``repro.core.memory``: solvers
and integrators register their working sets under a label, and the
helper keeps live bytes per label and the run's high-water mark.
PyTorch's caching allocator owns the buffers themselves; the measured
device peak is ``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class MemoryHelper:
    stats: dict = field(default_factory=lambda: {
        "live_bytes": 0, "high_water_bytes": 0})
    workspaces: dict = field(default_factory=dict)  # label -> live bytes

    @staticmethod
    def nbytes_of(shape, dtype) -> int:
        n = 1
        for s in shape:
            n *= int(s)
        return n * torch.empty((), dtype=dtype).element_size()

    def register(self, label: str, shape, dtype=torch.float64) -> int:
        """Account a workspace buffer under ``label``; returns its bytes.

        Idempotent per label: re-registering the same label only grows
        the accounted size if the new shape is larger."""
        nbytes = self.nbytes_of(shape, dtype)
        delta = max(0, nbytes - self.workspaces.get(label, 0))
        if delta == 0:
            return nbytes
        self.workspaces[label] = self.workspaces.get(label, 0) + delta
        self.stats["live_bytes"] += delta
        self.stats["high_water_bytes"] = max(self.stats["high_water_bytes"],
                                             self.stats["live_bytes"])
        return nbytes

    def release(self, label=None) -> None:
        """Release one labelled workspace (or all of them)."""
        labels = list(self.workspaces) if label is None else [label]
        for lb in labels:
            self.stats["live_bytes"] -= self.workspaces.pop(lb, 0)

    @property
    def high_water_bytes(self) -> int:
        return self.stats["high_water_bytes"]

    @property
    def live_bytes(self) -> int:
        return self.stats["live_bytes"]
