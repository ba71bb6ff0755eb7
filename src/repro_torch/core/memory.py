"""SUNMemoryHelper analog: allocate, wrap and copy between memory spaces,
and the workspace register/release audit.

Counterpart of ``repro.core.memory`` (``memory.py:29-160``).  The
paper's SUNMemoryHelper is a minimal memory abstraction with three jobs,
allocate, deallocate and copy between spaces (host, device, UVM,
pinned), and an ownership flag so a user's buffer is never freed by the
library.  On the card the spaces exist natively:

* ``DEVICE`` — the helper's device (the card unless ``device=`` names
  another; without CUDA it raises, as the entry points do);
* ``HOST``   — CPU memory;
* ``PINNED`` — page-locked CPU memory (``pin_memory()``) when the
  helper's device is the card; on a CPU helper plain host memory, with
  the request recorded in ``requested_type``;
* ``UVM``    — recorded as downgraded to ``DEVICE``, as the reference
  records it.

Deallocation is PyTorch's (reference counts and the caching allocator).
The reference's ``donate`` / ``donate_argnums_for`` have no counterpart:
the port's loops update their buffers in place.  ``stats`` counts bytes
allocated and copied and the copies each way; registered workspaces
count as allocated too, with live bytes per label and the high-water
mark (the measured device peak is ``torch.cuda.max_memory_allocated``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .policies import resolve_device


class MemoryType(enum.Enum):
    HOST = "host"            # plain host memory
    DEVICE = "device"        # the card's memory
    UVM = "uvm"              # recorded as DEVICE
    PINNED = "pinned_host"   # page-locked host memory


@dataclass
class SUNMemory:
    """A tensor with its memory type and ownership flag (paper §3)."""

    data: Any
    mem_type: MemoryType
    own: bool = True
    requested_type: Optional[MemoryType] = None  # e.g. UVM recorded as DEVICE


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class MemoryHelper:
    """Alloc / wrap / copy across memory spaces, plus the workspace
    audit.  ``device`` is DEVICE's device; None means the card."""

    device: Optional[Any] = None
    stats: dict = field(default_factory=lambda: {
        "alloc_bytes": 0, "copy_bytes": 0, "copies_h2d": 0, "copies_d2h": 0,
        "live_bytes": 0, "high_water_bytes": 0})
    workspaces: dict = field(default_factory=dict)  # label -> live bytes

    # -- workspace registration (high-water accounting) --------------------

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
        self.stats["alloc_bytes"] += delta
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

    # -- allocation ----------------------------------------------------------

    def alloc(self, shape, dtype=torch.float32,
              mem_type: MemoryType = MemoryType.DEVICE) -> SUNMemory:
        """A zeroed buffer in ``mem_type``'s space, owned by the helper."""
        requested = mem_type
        if mem_type == MemoryType.UVM:
            mem_type = MemoryType.DEVICE
        dev = resolve_device(self.device) if mem_type == MemoryType.DEVICE \
            else torch.device("cpu")
        data = torch.zeros(shape, dtype=dtype, device=dev)
        if mem_type == MemoryType.PINNED and \
                resolve_device(self.device).type == "cuda":
            data = data.pin_memory()     # a CPU helper has no pinned memory
        self.stats["alloc_bytes"] += _nbytes(data)
        return SUNMemory(data, mem_type, own=True, requested_type=requested)

    def wrap(self, data, mem_type: MemoryType = MemoryType.DEVICE
             ) -> SUNMemory:
        """Wrap a user's buffer: it stays the user's (``own=False``)."""
        return SUNMemory(data, mem_type, own=False)

    # -- copy between spaces -------------------------------------------------

    def copy(self, dst: SUNMemory, src: SUNMemory) -> SUNMemory:
        """Copy ``src``'s contents into ``dst``'s buffer (same shape and
        dtype; SUNMemoryHelper_Copy) and return ``dst``.  A copy between
        the host (or pinned) space and the device counts as h2d or d2h.
        It is queued on the current stream; a d2h copy waits for it."""
        if tuple(dst.data.shape) != tuple(src.data.shape) or \
                dst.data.dtype != src.data.dtype:
            raise ValueError(f"copy: dst is {tuple(dst.data.shape)} "
                             f"{dst.data.dtype}, src {tuple(src.data.shape)} "
                             f"{src.data.dtype}")
        dst.data.copy_(src.data)
        self.stats["copy_bytes"] += _nbytes(src.data)
        host = (MemoryType.HOST, MemoryType.PINNED)
        if src.mem_type in host and dst.mem_type == MemoryType.DEVICE:
            self.stats["copies_h2d"] += 1
        if src.mem_type == MemoryType.DEVICE and dst.mem_type in host:
            self.stats["copies_d2h"] += 1
        return dst
