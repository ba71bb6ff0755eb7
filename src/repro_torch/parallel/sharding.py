"""Logical-axis sharding rules -> per-rank layouts (the distribution core).

The port of ``repro.parallel.sharding``.  Params and activations carry
*logical* axis names (``models/spec.py``); two rule tables map them onto
mesh axes:

* PARAM_RULES — FSDP over ('pod','data') on a non-TP dim + tensor/expert
  parallelism over 'model'.  Every large matrix is sharded on two dims.
* ACT_RULES   — batch over ('pod','data'), heads/mlp/vocab over 'model'.

``spec_for`` degrades gracefully, as the reference's does: a dim that is
not divisible by its mesh axes, or whose mesh axis is already used by an
earlier dim, falls back to replication (shrinking a tuple of axes from
the right first), and trailing ``None``s are trimmed.  A spec is a
tuple with one entry a dim: ``None``, a mesh axis name, or a tuple of
names (the first the slowest-varying), the reference's ``PartitionSpec``
as a plain tuple.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or any object
with ``axis_names`` and ``devices.shape``, the reference's test
``FakeMesh``, for the arithmetic alone).  Where the reference hands a
``NamedSharding`` to GSPMD, the port's :class:`NamedSharding` says which
block of a global tensor this rank holds: each rank keeps only its local
shard, and the model's layers run on local shards with explicit
collectives (``parallel.collectives``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]

PARAM_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    # experts are OWNED per rank when E divides model*data (weights-
    # stationary EP); spec_for shrinks to ('model',) when it does not
    # divide (e.g. dbrx's 16 experts on a 16x16 mesh).
    "experts": ("model", "data"),
    "expert_mlp": None,
    "q_lora": ("pod", "data"),
    "kv_lora": ("pod", "data"),
    "head_dim": None,
    "heads_x": ("model",),
    "embed_out": None,
    "layers": None,
}

ACT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "embed": None,
    "head_dim": None,
    "experts": ("model",),
    "layers": None,
}


def cache_rules_from(act_rules: Dict) -> Dict:
    """Cache-only rules (decode path): head_dim takes 'model' when
    heads/kv_heads could not (axis uniqueness), which shards a GQA KV
    cache whose kv-head count does not divide the model axis.  Not for
    train/prefill activations."""
    out = dict(act_rules)
    out["head_dim"] = ("model",)
    return out


# --- pure-FSDP profile (no tensor parallelism): every parameter matrix is
# sharded on its d_model ('embed') dim across ALL ranks; activations shard
# batch over (pod,data) and sequence over 'model'.
FSDP_PARAM_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("pod", "data", "model"),
    "vocab": None,
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "experts": ("model", "data"),
    "expert_mlp": None,
    "q_lora": ("pod", "data", "model"),
    "kv_lora": ("pod", "data", "model"),
    "head_dim": None,
    "heads_x": None,
    "embed_out": None,
    "layers": None,
}

FSDP_ACT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": None,
    "embed": None,
    "head_dim": None,
    "experts": None,
    "layers": None,
}

PROFILES = {
    "tp_fsdp": (PARAM_RULES, ACT_RULES),
    "fsdp": (FSDP_PARAM_RULES, FSDP_ACT_RULES),
}


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a ``FakeMesh``."""
    shape = (tuple(mesh.mesh.shape) if hasattr(mesh, "mesh_dim_names")
             else tuple(mesh.devices.shape))
    return dict(zip(axis_names(mesh), shape))


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_for(shape: Sequence[int], axes: LogicalAxes, mesh,
             rules: Dict[str, Tuple[str, ...]]) -> Spec:
    """The spec of a tensor of ``shape`` with logical ``axes`` on
    ``mesh``, honouring divisibility and axis uniqueness."""
    sizes = mesh_axis_sizes(mesh)
    used = set()
    out = []
    for dim, name in zip(shape, axes):
        entry = rules.get(name) if name is not None else None
        if not entry:
            out.append(None)
            continue
        # drop mesh axes already used or absent from this mesh
        cand = tuple(a for a in entry if a in sizes and a not in used)
        if not cand:
            out.append(None)
            continue
        # shrink from the right (e.g. ('pod','data') -> ('pod',))
        while cand and dim % math.prod(sizes[a] for a in cand) != 0:
            cand = cand[:-1]
        if not cand:
            out.append(None)
            continue
        used.update(cand)
        out.append(cand if len(cand) > 1 else cand[0])
    # trim trailing Nones for tidiness
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a global tensor each rank holds.
    Along a dim sharded over axes ``(a, b)`` the block index is
    ``index(a) * size(b) + index(b)``, the reference's order."""
    mesh: Any
    spec: Spec

    def dim_axes(self, ndim: int) -> Tuple[Tuple[str, ...], ...]:
        """The mesh axes of each of ``ndim`` dims (``()``: replicated)."""
        return tuple(spec_axes(self.spec[i]) if i < len(self.spec) else ()
                     for i in range(ndim))

    def used_axes(self) -> Tuple[str, ...]:
        return tuple(a for e in self.spec for a in spec_axes(e))

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        sizes = mesh_axis_sizes(self.mesh)
        return tuple(n // math.prod(sizes[a] for a in ax)
                     for n, ax in zip(shape, self.dim_axes(len(shape))))

    def global_shape(self, local: Sequence[int]) -> Tuple[int, ...]:
        """The global shape whose blocks have shape ``local``."""
        sizes = mesh_axis_sizes(self.mesh)
        return tuple(n * math.prod(sizes[a] for a in ax)
                     for n, ax in zip(local, self.dim_axes(len(local))))

    def block(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's slice of each dim of a global ``shape``."""
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for n, ax in zip(shape, self.dim_axes(len(shape))):
            idx = 0
            for a in ax:
                idx = idx * sizes[a] + self.mesh.get_local_rank(a)
            m = n // math.prod(sizes[a] for a in ax)
            out.append(slice(idx * m, (idx + 1) * m))
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``full``, contiguous."""
        return full[self.block(full.shape)].contiguous()

    def is_primary(self) -> bool:
        """Whether this rank is the first replica of its block: index 0
        on every mesh axis the spec does not use."""
        used = set(self.used_axes())
        return all(self.mesh.get_local_rank(a) == 0
                   for a in axis_names(self.mesh) if a not in used)

    def placements(self):
        """``DTensor`` placements, one a mesh dim (``Shard(d)`` or
        ``Replicate()``).  A dim sharded over several axes in an order
        other than the mesh's (e.g. ``('model', 'data')`` on a
        ``('data', 'model')`` mesh) has no such placement: ValueError."""
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        where = {}
        for d, e in enumerate(self.spec):
            ax = spec_axes(e)
            if list(ax) != sorted(ax, key=names.index):
                raise ValueError(f"dim {d} is sharded over {ax}, not in "
                                 f"the mesh's axis order {names}")
            where.update({a: d for a in ax})
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in names)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def _tree_map2(fn, shapes, axes):
    """``fn(leaf, axes)`` over nested dicts / NamedTuples whose axes
    leaves are tuples of names."""
    if _is_axes(axes):
        return fn(shapes, axes)
    if isinstance(shapes, dict):
        return {k: _tree_map2(fn, shapes[k], axes[k]) for k in sorted(shapes)}
    if hasattr(shapes, "_fields"):
        return type(shapes)(*(_tree_map2(fn, getattr(shapes, n),
                                         getattr(axes, n))
                              for n in shapes._fields))
    raise TypeError(f"no axes for a {type(shapes).__name__}")


def shardings_for_tree(shapes_tree, axes_tree, mesh, rules: Dict = None):
    """A NamedSharding for each leaf of ``shapes_tree`` (tensors, ``meta``
    ones included); ``axes_tree`` holds the logical-axes tuples with the
    same structure (nested dicts and NamedTuples)."""
    rules = rules or PARAM_RULES
    return _tree_map2(lambda s, ax: NamedSharding(
        mesh, spec_for(tuple(s.shape), ax, mesh, rules)), shapes_tree,
        axes_tree)


def param_shardings(abstract_tree, axes, mesh, rules: Dict = None):
    return shardings_for_tree(abstract_tree, axes, mesh, rules)


class ShardCst:
    """The activation-constraint callback under a mesh.  A layer's
    tensors are already this rank's local blocks in the layout the
    reference asks GSPMD for, so the call returns ``x``; the object
    carries the layout the layers read: the mesh, the activation rules
    and the parameter rules of their profile, the mesh's collectives
    (``comm``), and the axes a batch's sequence is split over
    (``seq_axes``: none but under the fsdp profile)."""

    seq_axes: Tuple[str, ...] = ()

    def __init__(self, mesh, rules: Dict = None):
        from .collectives import comm_of
        self.mesh = mesh
        self.rules = rules or ACT_RULES
        self.profile = "fsdp" if self.rules == FSDP_ACT_RULES else "tp_fsdp"
        self.param_rules = PROFILES[self.profile][0]
        self.comm = comm_of(mesh)

    def __call__(self, x, axes):
        return x

    def with_seq_axes(self, axes: Tuple[str, ...]) -> "ShardCst":
        """A copy whose activations split the sequence over ``axes``
        (``seq_axes``: the fsdp profile's, which attention reads)."""
        out = copy.copy(self)
        out.seq_axes = tuple(axes)
        return out

    def __repr__(self):
        return (f"ShardCst({dict(mesh_axis_sizes(self.mesh))}, "
                f"profile={self.profile})")


def make_cst(mesh, rules: Dict = None):
    """Activation sharding-constraint callback ``cst(x, logical_axes)``:
    the identity without a mesh, else a :class:`ShardCst`."""
    if mesh is None:
        return lambda x, axes: x
    return ShardCst(mesh, rules)


# --- cache logical axes (for serve-path layouts) ----------------------------


def cache_axes_like(cache_specs, cfg) -> Any:
    """A logical-axes tree matching the cache spec tree (nested dicts)."""

    def one(name, leaf):
        nd = len(leaf.shape)
        if name in ("k", "v"):
            return ("layers", "batch", "seq", "kv_heads", "head_dim")[:nd]
        if name in ("c_kv", "k_rope"):
            return ("layers", "batch", "seq", None)[:nd]
        if name == "pos":
            return ("layers",) * nd   # () unstacked, (L,) when stacked
        if name == "conv":
            return ("layers", "batch", None, "mlp")[:nd]
        if name == "ssm":
            return ("layers", "batch", "heads", "head_dim", None)[:nd]
        if name in ("C",):
            return ("layers", "batch", "heads", None, None)[:nd]
        if name in ("n", "m", "c", "h"):
            # xlstm scalar states: (pairs, B, ...) — shard batch
            return (("layers", "batch") + (None,) * (nd - 2))[:nd]
        return (None,) * nd

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        return one(name, tree)

    return walk(cache_specs, "")
