"""The cost of one step, counted op by op: flops, HBM bytes, collectives.

The port's counterpart of ``repro.analysis.hlocost``.  The reference
walks the post-SPMD HLO text of a compiled step; eager PyTorch has no
HLO, so :class:`StepCost` runs the step itself (on ``meta`` tensors in
the dry run, ``launch/dryrun.py``, or on real ones) and counts the same
three quantities a rank as the ops go by:

* **flops** from ``torch.utils.flop_counter.FlopCounterMode`` (the
  matmuls: 2 * out * contracted, hlocost's count for a dot), plus the
  flops of each call of a port kernel's row (below);
* **HBM bytes** from a ``TorchDispatchMode`` that adds the inputs and
  outputs of every aten op that materialises memory (views, allocations
  and metadata ops move nothing; a gather or index charges what it
  selects, not the whole table it selects from, and a scatter what it
  writes).  Unlike hlocost, which charges elementwise ops nothing
  (``_ELEMENTWISE``: XLA fuses them into their consumers), every
  elementwise op is charged: an eager step launches each one, reading
  its operands and writing its result;
* **collective bytes** from ``parallel.collectives.by_group()``, each
  group's calls read through the reference's ring model
  (``analysis.roofline.ring_bytes``), split into the bytes sent within
  one node and across nodes.

A call of a dispatch op (``core.dispatch``'s ``"auto"`` backend) whose
first tensor is abstract (``meta``, or fake) runs the kernel wrapper's
plain version, since no kernel runs on such a tensor; it is counted
under the kernel's row with ``analysis/opcost.py``'s kernel formulas
(``flops``, ``hbm_bytes``), and the plain version's own aten ops are
left out.  A call on real tensors is not touched: on the card it
launches its kernel, whose aten-free work the mode does not see, so a
real step's rows are not in its counts.

The mode also follows live bytes: each storage an op creates is added
when it appears and taken off when its last reference (Python or
autograd's saved tensors) goes, so :attr:`StepCost.peak_bytes` is the
step's high-water mark: its arguments' storages (``args``) and the most
that the step's own were at once.

:meth:`StepCost.top_ops` and :meth:`StepCost.top_collectives` are
hlocost's ``top_bytes`` and ``top_collectives`` by aten op and by
collective kind and group.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..core import dispatch
from ..parallel import collectives as coll
from . import opcost
from .roofline import get_device, ring_bytes

aten = torch.ops.aten

#: ops that allocate or describe memory and move none
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.empty_like.default, aten.lift_fresh.default,
    aten.detach.default, aten.alias.default,
    aten._local_scalar_dense.default, aten.sym_size.int,
    aten.sym_stride.int, aten.sym_numel.default, aten.is_same_size.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
}

#: ops that read only what they select from their first input
_GATHER = {
    aten.index.Tensor, aten.index_select.default, aten.gather.default,
    aten.embedding.default, aten.take_along_dim.default,
}

#: ops that write only the rows their index names into their first input
_SCATTER = {
    aten.index_put_.default, aten.index_put.default,
    aten._index_put_impl_.default, aten.index_add_.default,
    aten.index_add.default, aten.index_copy_.default,
    aten.index_copy.default, aten.scatter_add_.default,
    aten.scatter_add.default, aten.scatter_.src, aten.scatter.src,
    aten.scatter_.value, aten.scatter.value,
    aten.embedding_dense_backward.default,
}


def is_abstract(t) -> bool:
    """True for a tensor with no data: on ``meta``, or a fake tensor
    whatever device it names.  A tensor on the card or the CPU is not."""
    if t.device.type == "meta":
        return True
    if type(t) is not torch.Tensor:
        from torch._subclasses.fake_tensor import is_fake
        return is_fake(t)
    return False


def tensors(x) -> List[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Walker(TorchDispatchMode):
    """Bytes by aten op and live storages; paused inside a row's plain
    version."""

    def __init__(self, owner: "StepCost"):
        super().__init__()
        self.owner = owner
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        own = self.owner
        for t in tensors(out):
            own._track(t)
        if self.paused or func in _FREE or func.is_view:
            return out
        ins = tensors(args) + tensors(kwargs)
        outs = tensors(out)
        if func in _GATHER:
            moved = 2 * sum(_nbytes(t) for t in outs) + \
                sum(_nbytes(t) for t in ins[1:])
        elif func in _SCATTER:
            moved = 2 * sum(_nbytes(t) for t in ins[1:])
        else:                            # an in-place op's self: twice
            moved = sum(_nbytes(t) for t in ins + outs)
        own._op(func.overloadpacket.__name__, moved)
        return out


class StepCost:
    """Counts of one step run inside ``with StepCost() as sc:`` (a
    rank's: the step's own flops, bytes and collectives).

    ``args``: the step's arguments (any nest of tensors), alive before
    it: their storages are its ``baseline`` toward the peak, and an op
    that writes into one of them allocates nothing; ``node_cards``: the
    cards of one node, which decide whether a collective group crosses
    nodes (default: the ``h100_sxm`` row's)."""

    def __init__(self, args=(), node_cards: int = 0):
        self.node_cards = node_cards or get_device("h100_sxm").node_cards
        self.baseline = 0
        self._storages = {}             # id of a storage -> its bytes
        self._held = []                 # the arguments' storages
        for t in tensors(args):
            st = t.untyped_storage()
            if id(st) not in self._storages:
                self._storages[id(st)] = 0
                self._held.append(st)
                self.baseline += st.nbytes()
        self.ops: Dict[str, list] = {}          # name -> [calls, bytes]
        self.rows: Dict[str, list] = {}         # op -> [calls, flops, bytes]
        self.matmul_flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.collectives: Dict[str, Dict[Tuple[int, ...], Tuple[int, int]]] \
            = {}
        self.live = 0
        self.peak = 0

    # --- the walk -------------------------------------------------------
    def _op(self, name: str, moved: int) -> None:
        rec = self.ops.setdefault(name, [0, 0])
        rec[0] += 1
        rec[1] += moved

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def _row(self, op, kernel, args, kw):
        """The ``"auto"`` backend's call of ``op``: on abstract tensors,
        the plain version run unwalked and the row counted."""
        lead = dispatch._first_tensor(args)
        if lead is None or not is_abstract(lead):
            return kernel(*args, **kw)
        c = opcost.op_cost(opcost.signature(op, args))
        rec = self.rows.setdefault(op, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += c.flops
        rec[2] += c.hbm_bytes
        self._walker.paused += 1
        try:
            return kernel(*args, **kw)
        finally:
            self._walker.paused -= 1

    def __enter__(self):
        coll.reset_counts()
        self._flops = FlopCounterMode(display=False)
        self._walker = _Walker(self)
        self._prev_row = dispatch.ROW_RECORDER
        dispatch.ROW_RECORDER = self._row
        self._flops.__enter__()
        self._walker.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._walker.__exit__(*exc)
            self._flops.__exit__(*exc)
        finally:
            dispatch.ROW_RECORDER = self._prev_row
        self.collectives = coll.by_group()
        counts = self._flops.get_flop_counts().get("Global", {})
        self.flops_by_op = {getattr(k, "__name__", str(k)): float(v)
                            for k, v in counts.items()}
        self.matmul_flops = float(sum(self.flops_by_op.values()))
        return False

    # --- the three quantities ------------------------------------------
    @property
    def flops(self) -> float:
        """The step's flops: its matmuls and its kernel rows'."""
        return self.matmul_flops + sum(r[1] for r in self.rows.values())

    @property
    def bytes(self) -> float:
        """HBM bytes: every materialising aten op's inputs and outputs,
        and each kernel row's single pass."""
        return float(sum(r[1] for r in self.ops.values())
                     + sum(r[2] for r in self.rows.values()))

    @property
    def peak_bytes(self) -> int:
        """The most bytes alive during the step: ``baseline`` and the
        storages the step made."""
        return self.baseline + self.peak

    def _crosses(self, members: Tuple[int, ...]) -> bool:
        return len({r // self.node_cards for r in members}) > 1

    def coll_rows(self) -> List[dict]:
        """One record a (kind, group): calls, the inputs' bytes, the
        group's size, whether it crosses nodes, and the ring bytes this
        rank sends (the call's output: an all_gather's g inputs, a
        reduce_scatter's 1/g of its input)."""
        out = []
        for kind, groups in self.collectives.items():
            for members, (calls, nb) in groups.items():
                g = len(members)
                size = nb * g if kind == "all_gather" else \
                    nb / g if kind == "reduce_scatter" else nb
                out.append({"kind": kind, "group": g, "calls": calls,
                            "bytes": nb, "crosses_nodes":
                            self._crosses(members),
                            "ring_bytes": ring_bytes(kind, size, g)})
        return out

    @property
    def coll_bytes(self) -> float:
        """Ring bytes this rank sends in the step's collectives."""
        return float(sum(r["ring_bytes"] for r in self.coll_rows()))

    @property
    def coll_net_bytes(self) -> float:
        """The part of :attr:`coll_bytes` over groups across nodes."""
        return float(sum(r["ring_bytes"] for r in self.coll_rows()
                         if r["crosses_nodes"]))

    # --- reports --------------------------------------------------------
    def top_ops(self, k: int = 14) -> List[tuple]:
        """The ``k`` aten ops (and kernel rows) moving the most bytes:
        (bytes, name, calls, flops)."""
        rows = [(float(b), n, c, self.flops_by_op.get(n, 0.0))
                for n, (c, b) in self.ops.items()]
        rows += [(b, f"row:{n}", c, f) for n, (c, f, b) in self.rows.items()]
        return sorted(rows, reverse=True)[:k]

    def top_collectives(self, k: int = 12) -> List[tuple]:
        """The ``k`` (kind, group) pairs sending the most ring bytes:
        (ring bytes, kind, group size, calls, crosses nodes)."""
        rows = [(r["ring_bytes"], r["kind"], r["group"], r["calls"],
                 r["crosses_nodes"]) for r in self.coll_rows()]
        return sorted(rows, reverse=True)[:k]

    def summary(self) -> Dict[str, float]:
        """hlocost's ``analyze`` keys, with the port's additions."""
        out = {"flops": self.flops, "matmul_flops": self.matmul_flops,
               "bytes": self.bytes, "coll_total": self.coll_bytes,
               "coll_net": self.coll_net_bytes,
               "coll_count": float(sum(c for c, _ in coll.counts(
                   self.collectives).values())),
               "peak_bytes": float(self.peak_bytes)}
        for kind in coll.KINDS:
            out[f"coll_{kind}"] = float(sum(
                r["ring_bytes"] for r in self.coll_rows()
                if r["kind"] == kind))
        out["rows"] = {n: {"calls": c, "flops": f, "bytes": b}
                       for n, (c, f, b) in self.rows.items()}
        return out
