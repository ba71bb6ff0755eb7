"""Execution policies: which implementation each dispatched op runs.

Counterpart of ``repro.core.policies.ExecPolicy``.  On the card there
are two implementations of every hot op: the hand-written CUDA kernel
and its plain PyTorch version.  The policy picks between them:

============  ==========================================================
backend       meaning
============  ==========================================================
``"auto"``    the kernel for a CUDA tensor, the plain version for a CPU
              tensor (the default)
``"torch"``   the plain versions on purpose, on any device (the
              comparison run of ``chip_smoke.py``)
``"cuda"``    the kernels; CPU tensors raise
============  ==========================================================

There is no ``interpret`` and no ``batch_tile``: the kernels bounds-check
the system axis, so no batch padding exists to tune.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

BACKENDS = ("auto", "torch", "cuda")


@dataclass(frozen=True)
class ExecPolicy:
    """backend : one of :data:`BACKENDS`.
    device  : where :func:`repro_torch.core.ivp.integrate` runs when the
              call names no device (None means ``"cuda"``)."""

    backend: str = "auto"
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"valid: {', '.join(BACKENDS)}")


DEFAULT = ExecPolicy()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.

    The entry points run on the card unless the caller asks for the CPU:
    without CUDA they raise instead of falling back silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
