"""Every collective of the model-parallel layer, over named mesh axes,
counted.

The reference runs its sharded model under GSPMD, which inserts the
collectives a layout needs.  The port keeps each rank's local shards as
plain tensors and issues each collective itself, here and nowhere else:
``all_gather``, ``reduce_scatter``, ``all_to_all`` and ``all_reduce``
over a sub-group of one or more mesh axes (:class:`Comm`), each counted
in calls and bytes (the bytes a rank hands to the collective: its
input) by kind and group (:func:`by_group`: the global ranks of each
group, from which ``analysis.roofline.ring_bytes`` gives the bytes a
rank sends), and so by kind (:func:`counts`).  A
``meta`` tensor has no data: its call is counted and its output shaped,
and nothing is handed to the group (the dry run's fake group moves no
data either).  DTensor's own redistributions are not
used: they call the process group directly, and path R's ranks share
one card over gloo (NCCL refuses two ranks on one device), where gloo
runs no collective on CUDA tensors but all_reduce and broadcast.  So a
CUDA tensor on a gloo group is staged through the host explicitly
(:func:`_staged`), as ``core/batched.py``'s ``_all_gather_rows`` does,
and on an NCCL group it stays on the card.

A group of several axes orders its members as the reference orders a
tuple of mesh axes: the first axis slowest (``('model', 'data')`` on a
``('data', 'model')`` mesh is model-major).  PyTorch numbers a group's
ranks by global rank, so each group keeps the permutation between the
two and the collectives reorder their blocks by it.

The autograd functions at the end are the conjugate pairs of tensor
parallelism: :func:`copy_to` (identity, all_reduce of the gradient) and
:func:`reduce_from` (all_reduce, identity gradient), :func:`split_along`
and :func:`gather_along` (a block of a replicated activation and back),
:func:`gather_fsdp` (a parameter's all_gather, its gradient
reduce-scattered) and :func:`all_to_all` (its own adjoint).  The
convention: a tensor replicated over an axis holds the full, equal
gradient on every rank of it.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

# the names of PyTorch 2.13 and later, else their older ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

KINDS = ("all_gather", "reduce_scatter", "all_to_all", "all_reduce")
#: kind -> the global ranks of a group -> [calls, bytes]
_GROUPS: Dict[str, Dict[Tuple[int, ...], list]] = {k: {} for k in KINDS}


def by_group() -> Dict[str, Dict[Tuple[int, ...], Tuple[int, int]]]:
    """kind -> the global ranks of a group -> (calls, input bytes) since
    the last :func:`reset_counts`."""
    return {k: {m: (c, b) for m, (c, b) in v.items()}
            for k, v in _GROUPS.items()}


def counts(groups=None) -> Dict[str, Tuple[int, int]]:
    """kind -> (calls, input bytes) over every group: since the last
    :func:`reset_counts`, or of ``groups``, a :func:`by_group` record."""
    groups = by_group() if groups is None else groups
    return {k: (sum(c for c, _ in groups[k].values()),
                sum(b for _, b in groups[k].values())) for k in KINDS}


def reset_counts() -> None:
    for v in _GROUPS.values():
        v.clear()


def _count(kind: str, t: torch.Tensor, comm: "Comm", axes) -> None:
    rec = _GROUPS[kind].setdefault(comm.members(axes), [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Comm:
    """The groups of a ``DeviceMesh``'s named axes.  Every rank must ask
    for a group of several axes in the same order (SPMD code does): its
    creation is collective over the default group."""

    def __init__(self, mesh):
        self.mesh = mesh
        #: the default group its groups belong to (gone once it is)
        self.world = dist.group.WORLD if dist.is_initialized() else None
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, mesh.mesh.shape))
        self._groups = {}
        self._members = {}

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's position in the group of ``axes`` (first axis
        slowest)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.sizes[a] + self.mesh.get_local_rank(a)
        return idx

    def group(self, axes):
        """(process group, perm): ``perm[j]`` is the group rank of the
        member at position ``j``."""
        axes = _axes(axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = (self.mesh.get_group(axes[0]),
                                      list(range(self.sizes[axes[0]])))
            else:
                self._groups[axes] = self._new_group(axes)
        return self._groups[axes]

    def members(self, axes) -> Tuple[int, ...]:
        """The global ranks of this rank's group of ``axes``, sorted."""
        axes = _axes(axes)
        m = self._members.get(axes)
        if m is None:
            pg, _ = self.group(axes)
            m = self._members[axes] = tuple(sorted(
                dist.get_process_group_ranks(pg)))
        return m

    def _new_group(self, axes):
        grid = self.mesh.mesh
        dims = [self.names.index(a) for a in axes]
        rest = [d for d in range(grid.ndim) if d not in dims]
        rows = grid.permute(rest + dims).reshape(-1, self.size(axes))
        me = dist.get_rank()
        mine = None
        for row in rows.tolist():
            pg = dist.new_group(sorted(row))
            if me in row:
                mine = (pg, [sorted(row).index(r) for r in row])
        return mine


_COMMS: Dict[int, Comm] = {}


def comm_of(mesh) -> Comm:
    """The one :class:`Comm` of ``mesh`` (its groups made once)."""
    c = _COMMS.get(id(mesh))
    if c is None or c.mesh is not mesh:
        c = _COMMS[id(mesh)] = Comm(mesh)
    return c


def close() -> None:
    """Tear down this process's groups after its last collective: each
    group of several mesh axes a :class:`Comm` of the current default
    group made, then the meshes' axis groups with the default group
    (``destroy_process_group``).  Every :class:`Comm` is forgotten (one
    of a default group already destroyed holds no live group), so that
    no group is left for the interpreter's exit to tear down in no set
    order."""
    world = dist.group.WORLD if dist.is_initialized() else None
    for c in _COMMS.values():
        if world is not None and c.world is world:
            for axes, (pg, _) in c._groups.items():
                if len(axes) > 1:
                    dist.destroy_process_group(pg)
        c._groups.clear()
        c._members.clear()
    _COMMS.clear()
    if world is not None:
        dist.destroy_process_group()


def _staged(t: torch.Tensor, pg):
    """(tensor to hand to the group, device to return to): a CUDA tensor
    on a gloo group goes through the host."""
    if t.is_cuda and dist.get_backend(pg) == "gloo":
        return t.cpu(), t.device
    return t.contiguous(), None


def _back(t: torch.Tensor, dev):
    return t if dev is None else t.to(dev)


def all_gather(t: torch.Tensor, comm: Comm, axes, dim: int = 0):
    """The members' tensors concatenated along ``dim`` in member order."""
    pg, perm = comm.group(axes)
    n = len(perm)
    _count("all_gather", t, comm, axes)
    x, dev = _staged(t.movedim(dim, 0).contiguous(), pg)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if not x.is_meta:
        _ALL_GATHER(out, x, group=pg)
    if perm != list(range(n)):
        out = out.reshape((n,) + tuple(x.shape))[perm].reshape(out.shape)
    return _back(out, dev).movedim(0, dim)


def reduce_scatter(t: torch.Tensor, comm: Comm, axes, dim: int = 0):
    """The sum over the members of ``t``, of which this rank keeps the
    block at its position along ``dim``."""
    pg, perm = comm.group(axes)
    n = len(perm)
    _count("reduce_scatter", t, comm, axes)
    x, dev = _staged(t.movedim(dim, 0), pg)
    m = x.shape[0] // n
    if perm != list(range(n)):
        inv = [perm.index(g) for g in range(n)]
        x = x.reshape((n, m) + tuple(x.shape[1:]))[inv].reshape(x.shape)
    x = x.contiguous()
    out = x.new_empty((m,) + tuple(x.shape[1:]))
    if not x.is_meta:
        _REDUCE_SCATTER(out, x, group=pg)
    return _back(out, dev).movedim(0, dim)


def all_to_all_raw(t: torch.Tensor, comm: Comm, axes):
    """``t`` of shape (n, ...): block j goes to the member at position j;
    -> block j received from the member at position j."""
    pg, perm = comm.group(axes)
    n = len(perm)
    _count("all_to_all", t, comm, axes)
    x, dev = _staged(t, pg)
    ident = perm == list(range(n))
    if not ident:
        x = x[[perm.index(g) for g in range(n)]]
    x = x.contiguous()
    out = torch.empty_like(x)
    if not x.is_meta:
        dist.all_to_all_single(out, x, group=pg)
    if not ident:
        out = out[perm]
    return _back(out, dev)


def all_reduce(t: torch.Tensor, comm: Comm, axes, op: str = "sum"):
    """The members' elementwise sum (or ``op="max"``), a new tensor."""
    pg, _ = comm.group(axes)
    _count("all_reduce", t, comm, axes)
    x, dev = _staged(t, pg)
    x = x.clone() if dev is None else x
    if not x.is_meta:
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else
                        dist.ReduceOp.SUM, group=pg)
    return _back(x, dev)


def barrier() -> None:
    """Every rank of the default group (a mesh spans it) has reached
    this point."""
    dist.barrier()


# ---------------------------------------------------------------------------
# autograd: the conjugate pairs of tensor, sequence and data parallelism
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.comm, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return all_reduce(x, comm, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        n, i = comm.size(axes), comm.index(axes)
        m = x.shape[dim] // n
        return x.narrow(dim, i * m, m).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.comm, ctx.axes, ctx.dim), None, None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim, ctx.m = comm, axes, dim, x.shape[dim]
        return all_gather(x, comm, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.comm.index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.m, ctx.m).contiguous(), None, \
            None, None


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return all_gather(x, comm, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.comm, ctx.axes, ctx.dim), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return all_to_all_raw(x, comm, axes)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.comm, ctx.axes), None, None


def copy_to(x, comm: Comm, axes):
    """Identity; the gradient all-reduced over ``axes``: where a tensor
    replicated over ``axes`` enters compute split over them."""
    return _CopyTo.apply(x, comm, _axes(axes))


def reduce_from(x, comm: Comm, axes):
    """All-reduce (sum) over ``axes``; the gradient passes as it is:
    where partial results become one replicated tensor."""
    return _ReduceFrom.apply(x, comm, _axes(axes))


def split_along(x, comm: Comm, axes, dim: int):
    """This rank's block of a tensor replicated over ``axes``; the
    gradient all-gathered."""
    return _SplitAlong.apply(x, comm, _axes(axes), dim)


def gather_along(x, comm: Comm, axes, dim: int):
    """The blocks of ``axes`` concatenated into a replicated tensor; the
    gradient's own block kept."""
    return _GatherAlong.apply(x, comm, _axes(axes), dim)


def gather_fsdp(x, comm: Comm, axes, dim: int):
    """A parameter's blocks over ``axes`` concatenated at use; its
    gradient reduce-scattered (summed over the members)."""
    return _GatherFSDP.apply(x, comm, _axes(axes), dim)


def all_to_all(x, comm: Comm, axes):
    """:func:`all_to_all_raw` under autograd (its own adjoint)."""
    return _AllToAll.apply(x, comm, _axes(axes))


def gather_full(t: torch.Tensor, comm: Comm, dim_axes: Sequence) -> \
        torch.Tensor:
    """A sharded tensor's global value (no autograd): each dim gathered
    over its axes (``dim_axes[d]``, ``()`` for none)."""
    for d, ax in enumerate(dim_axes):
        if ax:
            t = all_gather(t, comm, ax, d)
    return t
