"""The device table, and the roofline of a model step on it.

Counterpart of ``repro/analysis/roofline.py``.  A row of the device
table (:class:`Device`, :data:`DEVICES`, :func:`get_device`) holds what
the dispatch cost model (:mod:`repro_torch.analysis.opcost`), sunlint's
``kernel-contract`` rule and the roofline (:class:`Roofline`) read
about one card:

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
                     elementwise op, over 1 GiB;
bf16_dense_flops   : the dense bf16 tensor-core peak [FLOP/s], the
                     roofline's compute ceiling (a model step's matmuls);
nvlink_bw          : one card's NVLink bandwidth, one direction [B/s];
net_bw             : one card's share of the network between nodes [B/s];
node_cards         : the cards of one node, joined by NVLink.

The reference's ``vmem_bytes``, ``pallas_step``, ``interp_op`` and
``interpret`` are dropped: a CUDA kernel has no VMEM tile to size (the
port's kernels bounds-check the system axis and take no tile), no grid
step that costs apart from its launch, and no interpret mode.  Its
``ici_bw`` becomes ``nvlink_bw`` and ``net_bw``: a collective whose
group lies within one node runs over NVLink, one that spans nodes over
the network.  No TPU row is kept: no number taken on or for a TPU is
the port's.

The roofline of one step (:class:`Roofline`) has the reference's three
terms, per rank::

    compute    = flops / bf16_dense_flops
    memory     = bytes / hbm_bw
    collective = ring bytes within a node / nvlink_bw
                 + ring bytes across nodes / net_bw

Its counts come from :mod:`repro_torch.analysis.stepcost` (a step run
on abstract tensors, counted op by op) where the reference walks the
compiled HLO; the ring model (:func:`ring_bytes`) is the reference's
``_line_traffic``.  The terms are estimates from data-sheet ceilings,
not measurements.  :func:`active_param_count`, :func:`model_flops_for`
and :func:`summarize` are the reference's arithmetic on the port's
configs.

:func:`device_for` maps a card (``torch.cuda.get_device_name``) to its
row; a card with no row raises rather than borrow another card's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

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
    bf16_dense_flops: float = 0.0
    nvlink_bw: float = 0.0
    net_bw: float = 0.0
    node_cards: int = 1

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
    # H100 80GB HBM3 at a 700.00 W power limit (PERF.md §6).  The
    # roofline's ceilings, from the NVIDIA H100 Tensor Core GPU data
    # sheet (SXM form): dense bf16 989 TFLOP/s, NVLink 900 GB/s both
    # directions (450 one way), and a node of 8 cards whose network
    # gives each card one NDR InfiniBand port of 400 Gb/s (50 GB/s).
    "h100_sxm": Device(
        name="h100_sxm", card="NVIDIA H100 80GB HBM3",
        peak_flops=34e12, hbm_bw=3.35e12,
        smem_optin_bytes=227 * 1024, max_block_threads=1024,
        kernel_launch=1.958e-6, plain_launch=1.960e-6,
        cuda_bw=2.8965e12, torch_bw=2.8395e12,
        bf16_dense_flops=989e12, nvlink_bw=450e9, net_bw=50e9,
        node_cards=8),
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


# ---------------------------------------------------------------------------
# the roofline of one step
# ---------------------------------------------------------------------------

_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "collective_permute": "collective-permute"}


def ring_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes one rank sends in one collective of ``kind`` over a ring of
    ``group`` ranks, ``nbytes`` the size of the call's output: the
    reference's ``_line_traffic`` (all-gather out*(g-1)/g, all-reduce
    2*size*(g-1)/g, reduce-scatter size*(g-1), all-to-all size*(g-1)/g,
    collective-permute size).  ``kind`` in the port's spelling
    (``all_gather``) or XLA's (``all-gather``)."""
    base = _KINDS.get(kind, kind)
    g = max(int(group), 1)
    if base == "all-gather":
        return nbytes * (g - 1) / g
    if base == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if base == "reduce-scatter":
        return float(nbytes * (g - 1))
    if base == "all-to-all":
        return nbytes * (g - 1) / g
    if base == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class Roofline:
    """One cell's roofline, the reference's fields; the counts are per
    rank, ``coll_net_bytes`` the part of ``coll_bytes`` sent over groups
    that span more than one node."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per rank
    hlo_bytes: float             # per rank
    coll_bytes: float            # per rank
    model_flops: float           # analytic 6ND (dense) / 6 N_active D
    coll_net_bytes: float = 0.0  # per rank, over groups across nodes
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0    # model_flops / (chips * hlo_flops)
    mfu_bound: float = 0.0       # model_flops/chips/peak / max(terms)
    coll_detail: Optional[Dict] = None
    memory_per_chip: Optional[Dict] = None

    def finalize(self, device: str = "h100_sxm"):
        dev = get_device(device)
        peak = dev.bf16_dense_flops
        self.t_compute = self.hlo_flops / peak
        self.t_memory = self.hlo_bytes / dev.hbm_bw
        local = self.coll_bytes - self.coll_net_bytes
        self.t_collective = (local / dev.nvlink_bw
                             + self.coll_net_bytes / dev.net_bw)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        total = self.hlo_flops * self.chips
        self.useful_ratio = self.model_flops / total if total else 0.0
        t_dom = max(terms.values())
        ideal = self.model_flops / self.chips / peak
        self.mfu_bound = ideal / t_dom if t_dom > 0 else 0.0
        return self

    def to_dict(self):
        return dataclasses.asdict(self)


def active_param_count(cfg) -> int:
    """Parameters touched per token: experts scaled by top-k/E."""
    from ..models import Model
    from ..models.spec import tree_leaves

    total = 0
    for leaf in tree_leaves(Model(cfg).specs()):
        n = 1
        for d in leaf.shape:
            n *= d
        if "experts" in leaf.axes:
            n = int(n * cfg.experts_per_tok / max(cfg.n_experts, 1))
        total += n
    return total


def model_flops_for(cfg, shape_cfg) -> float:
    """6*N_active*D for train; 2*N_active*tokens for decode/prefill fwd."""
    n_active = active_param_count(cfg)
    tokens = shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "train":
        return 6.0 * n_active * tokens
    if shape_cfg.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape_cfg.global_batch


def summarize(rows) -> str:
    """A markdown table of :class:`Roofline` rows."""
    lines = ["| arch | shape | mesh | t_compute | t_memory | t_collective | "
             "bottleneck | useful | MFU-bound |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute:.3e} | "
            f"{r.t_memory:.3e} | {r.t_collective:.3e} | {r.bottleneck} | "
            f"{r.useful_ratio:.2f} | {r.mfu_bound:.2%} |")
    return "\n".join(lines)
