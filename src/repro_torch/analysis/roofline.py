"""The device table of the port's dispatch cost model.

Counterpart of the reference's ``Device``, ``DEVICES`` and
``get_device`` (``repro/analysis/roofline.py:22-104``).  A row holds
what the cost model (:mod:`repro_torch.analysis.opcost`) and sunlint's
``kernel-contract`` rule read about one card:

peak_flops         : float64 peak without tensor cores [op/s] (no
                     kernel of the port uses them);
hbm_bw             : the memory's data-sheet bandwidth [B/s];
smem_optin_bytes   : the most dynamic shared memory one block may opt
                     into (``cudaFuncAttributeMaxDynamicSharedMemorySize``);
max_block_threads  : the most threads one block may have;
kernel_launch      : device time of one launch of a hand-written kernel
                     on a tiny input [s], back to back with others;
plain_launch       : the same for one plain PyTorch elementwise op [s];
cuda_bw / torch_bw : the streamed bandwidth each implementation sustains
                     [B/s]: a device-to-device copy, and a plain
                     elementwise op, over 1 GiB.

The reference's ``vmem_bytes``, ``pallas_step``, ``interp_op`` and
``interpret`` are dropped: a CUDA kernel has no VMEM tile to size (the
port's kernels bounds-check the system axis and take no tile), no grid
step that costs apart from its launch, and no interpret mode.  Its
``ici_bw`` serves the dry-run roofline, which waits with
``launch/dryrun.py`` (ROADMAP queue A.9).  No TPU row is kept: no number
taken on or for a TPU is the port's.

:func:`device_for` maps a card (``torch.cuda.get_device_name``) to its
row; a card with no row raises rather than borrow another card's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class Device:
    """One row of the device table (see the module docstring)."""

    name: str
    card: str
    peak_flops: float
    hbm_bw: float
    smem_optin_bytes: int
    max_block_threads: int
    kernel_launch: float
    plain_launch: float
    cuda_bw: float
    torch_bw: float

    def bw(self, backend: str) -> float:
        """Streamed bandwidth of one implementation, ``"cuda"`` or
        ``"torch"``."""
        return self.cuda_bw if backend == "cuda" else self.torch_bw


DEVICES: Dict[str, Device] = {
    # NVIDIA H100 SXM.  Data sheet: float64 34 TFLOP/s without tensor
    # cores, HBM3 3.35 TB/s (the bounds of PERF.md's kernel table);
    # CUDA's limits for compute capability 9.0: 227 KiB of dynamic
    # shared memory a block may opt into, 1024 threads a block.  The
    # launch costs and bandwidths: chip_smoke.py path O.1 on an NVIDIA
    # H100 80GB HBM3 at a 700.00 W power limit (PERF.md §6).
    "h100_sxm": Device(
        name="h100_sxm", card="NVIDIA H100 80GB HBM3",
        peak_flops=34e12, hbm_bw=3.35e12,
        smem_optin_bytes=227 * 1024, max_block_threads=1024,
        kernel_launch=1.958e-6, plain_launch=1.960e-6,
        cuda_bw=2.8965e12, torch_bw=2.8395e12),
}


def get_device(name: str) -> Device:
    """The row named ``name``; an unknown name raises ``ValueError``."""
    try:
        return DEVICES[name]
    except KeyError:
        raise ValueError(f"unknown roofline device {name!r}; "
                         f"known: {sorted(DEVICES)}") from None


@functools.lru_cache(maxsize=16)
def _card_row(card: str) -> str:
    for row in DEVICES.values():
        if row.card == card:
            return row.name
    raise ValueError(f"no roofline row for the card {card!r}; rows: "
                     + ", ".join(f"{r.name} ({r.card})"
                                 for r in DEVICES.values()))


def device_for(device) -> str:
    """Name of the row of the card ``device`` (a CUDA ``torch.device``,
    or its string or index): the row whose ``card`` is that card's
    ``torch.cuda.get_device_name``.  A card with no row, or a device
    that is not a card, raises ``ValueError``."""
    dev = torch.device(device) if not isinstance(device, int) else \
        torch.device("cuda", device)
    if dev.type != "cuda":
        raise ValueError(f"device_for: {dev} is not a CUDA device")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return _card_row(torch.cuda.get_device_name(index))
