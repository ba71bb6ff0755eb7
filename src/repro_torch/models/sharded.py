"""A model's parameters on a mesh: local shards, gathered at use.

Each rank holds its block of every parameter (``parallel.sharding``'s
layout of the model's ParamSpecs under the profile's parameter rules).
At use, :meth:`Layout.use` all-gathers each dim the compute does not
keep split (``embed`` over ``('pod','data')``, ``q_lora``/``kv_lora``,
experts beyond the EP axes: FSDP), through
``collectives.gather_fsdp``, whose backward reduce-scatters the
gradient; a layer's gather runs inside its body, so under ``remat`` it
runs again in the recompute.  The dims kept split are those tensor and
expert parallelism compute on locally: ``heads``, ``kv_heads``,
``mlp``, ``vocab``, ``heads_x`` over ``model``, and ``experts`` over
the EP axes when ``moe_impl="ep"``.  Each gathered tensor carries the
mesh axes each of its dims stays split over (``_kept``), which the
layers read (:func:`repro_torch.models.layers.kept`); a dim that
``spec_for`` left replicated (36 heads on 16) is kept over none and
computes replicated, with no collective.

The batch is split over ``dp_axes`` (:meth:`Layout.local_batch`): every
rank passes the global batch and computes on its rows.  Gradients come
back in the parameters' layout: the FSDP dims reduce-scattered, and the
data-parallel axes a leaf is replicated over summed by
:meth:`Layout.reduce_grads`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel import collectives as coll
from ..parallel import sharding as shd
from .spec import tree_map

#: logical axes the tensor-parallel layers compute on locally (over 'model')
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "heads_x")


class Layout:
    """The layout of a model's parameters on ``pctx.mesh``."""

    def __init__(self, specs, pctx):
        cst = pctx.cst
        if not isinstance(cst, shd.ShardCst):
            cst = shd.ShardCst(pctx.mesh)
        if cst.profile != "tp_fsdp":
            raise NotImplementedError(
                f"the {cst.profile!r} profile's compute (sequence split "
                "over 'model') is not ported: ROADMAP A item 2")
        self.cst = cst
        self.mesh = pctx.mesh
        self.comm = cst.comm
        self.dp_axes = tuple(a for a in pctx.dp_axes if a in self.comm.sizes)
        self.ep_axes = ((pctx.ep_axis,) if isinstance(pctx.ep_axis, str)
                        else tuple(pctx.ep_axis)) \
            if pctx.moe_impl == "ep" else ()
        rules = cst.param_rules
        self.shardings = tree_map(lambda s: shd.NamedSharding(
            self.mesh, shd.spec_for(s.shape, s.axes, self.mesh, rules)),
            specs)
        self.axes = tree_map(lambda s: s.axes, specs)

    # --- parameters ---------------------------------------------------
    def _keep(self, name) -> Tuple[str, ...]:
        if name in TP_AXES:
            return ("model",)
        if name == "experts":
            return self.ep_axes
        return ()

    def _use_leaf(self, t: torch.Tensor, sh: shd.NamedSharding, axes,
                  lead: int) -> torch.Tensor:
        dims = sh.dim_axes(len(axes))[lead:]
        kept = []
        for d, (ax, name) in enumerate(zip(dims, axes[lead:])):
            keep = self._keep(name)
            n = 0
            while n < min(len(ax), len(keep)) and ax[n] == keep[n]:
                n += 1
            if name == "experts" and keep and ax[:n] != keep:
                raise ValueError(f"experts sharded over {ax}: the EP axes "
                                 f"{keep} need a finer split")
            if ax[n:]:
                t = coll.gather_fsdp(t, self.comm, ax[n:], d)
            kept.append(ax[:n])
        t = t.view_as(t)
        t._kept = tuple(kept)
        return t

    def use(self, local, key: str):
        """One layer of the stacked subtree ``key`` (this rank's shards)
        gathered for use and tagged."""
        return tree_map(lambda t, s, a: self._use_leaf(t, s, a, 1),
                        local, self.shardings[key], self.axes[key])

    def use_top(self, params) -> Dict[str, Any]:
        """Every top-level parameter gathered and tagged but the stacked
        ``layers``, whose layers gather in the layer's body."""
        return {k: (v if k == "layers" else
                    tree_map(lambda t, s, a: self._use_leaf(t, s, a, 0),
                             v, self.shardings[k], self.axes[k]))
                for k, v in params.items()}

    # --- batch and gradients --------------------------------------------
    def local_batch(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of the global ``batch`` (split over
        ``dp_axes``)."""
        if not self.dp_axes:
            return batch
        n, i = self.comm.size(self.dp_axes), self.comm.index(self.dp_axes)
        out = {}
        for k, v in batch.items():
            if not torch.is_tensor(v) or v.dim() == 0:
                out[k] = v
                continue
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                                 f"split over {self.dp_axes} ({n} ranks)")
            m = v.shape[0] // n
            out[k] = v[i * m:(i + 1) * m]
        return out

    def reduce_grads(self, grads):
        """Each leaf's gradient summed over the data-parallel axes its
        parameter is replicated over (the FSDP axes were reduce-scattered
        in the backward)."""
        def one(g, sh):
            axes = tuple(a for a in self.dp_axes if a not in sh.used_axes())
            return coll.all_reduce(g, self.comm, axes) if axes else g

        return tree_map(one, grads, self.shardings)
