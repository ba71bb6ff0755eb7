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

The batch is split over ``dp_axes`` (:meth:`Layout.local_batch`, which
returns the layout bound to that batch beside the rank's block): every
rank passes the global batch and computes on its rows.  Gradients come
back in the parameters' layout: the FSDP dims reduce-scattered, and the
data-parallel axes a leaf is replicated over summed by
:meth:`Layout.reduce_grads`.

Under the ``fsdp`` profile (``parallel.sharding.FSDP_PARAM_RULES``)
every parameter is sharded on ``embed`` over all the mesh's axes and
gathered whole at use: no dim is kept split but ``experts`` under EP,
so the layers compute with no tensor parallelism.  The activations
split the batch over ``dp_axes`` and the sequence over ``model``
(:attr:`Layout.seq_axes`; a sequence that does not divide, a decode
step's one token, stays whole, and then no gradient may be taken):
positions start at this rank's sequence block (:meth:`seq_offset`),
attention gathers K and V over ``model`` and the recurrent mixers and
whisper's cross-attention their input (each gradient reduce-scattered
back), and the loss and the gradients sum over every axis the tokens
are split over (:attr:`token_axes`).  Every family runs under both
profiles.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import torch

from ..parallel import collectives as coll
from ..parallel import sharding as shd
from .spec import tree_leaves, tree_map

#: logical axes the tensor-parallel layers compute on locally (over 'model')
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "heads_x")


class Layout:
    """The layout of the parameters of a model of ``cfg`` on
    ``pctx.mesh``, and the axes its tokens split over.  The decoder-only
    LM computes tensor parallel (``tp``) under tp_fsdp; the families
    whose layers have no tensor-parallel form (zamba2, xlstm, whisper),
    and every family under fsdp, gather every parameter whole at use and
    compute on their batch rows (and, under fsdp, sequence block),
    replicated over ``model`` under tp_fsdp.  The token axes are those
    of a batch that splits, the only batch a gradient may be taken of
    (:meth:`local_batch`), so every layout of one ``(cfg, pctx)``
    reduces gradients alike."""

    def __init__(self, cfg, pctx):
        from .transformer import _SPECS, _family
        fam = _family(cfg)
        specs = _SPECS[fam](cfg)
        cst = pctx.cst
        if not isinstance(cst, shd.ShardCst):
            cst = shd.ShardCst(pctx.mesh)
        self.cst = cst
        self.fsdp = cst.profile == "fsdp"
        self.tp = fam == "lm" and not self.fsdp
        self.seq_axes: Tuple[str, ...] = ("model",) if self.fsdp and \
            cst.comm.sizes.get("model", 1) > 1 else ()
        self.mesh = pctx.mesh
        self.comm = cst.comm
        self.dp_axes = tuple(a for a in pctx.dp_axes if a in self.comm.sizes)
        self.row_axes = self.dp_axes
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
        if name in TP_AXES and self.tp:
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
                t = self._gather(t, ax[n:], d)
            kept.append(ax[:n])
        t = t.view_as(t)
        t._kept = tuple(kept)
        return t

    def _gather(self, t, ax, d):
        """``t``'s blocks over the mesh axes ``ax`` joined along dim
        ``d``.  Over axes the tokens are split over each rank's gradient
        is a part, and the backward sums them (``gather_fsdp``); over the
        others every rank computes the same, and each keeps its own
        block of the gradient (``gather_along``), the fastest axis
        first."""
        tok = self.token_axes
        if all(a in tok for a in ax):
            return coll.gather_fsdp(t, self.comm, ax, d)
        for a in reversed(ax):
            t = (coll.gather_fsdp if a in tok else coll.gather_along)(
                t, self.comm, a, d)
        return t

    def use(self, local, key: str):
        """One layer of the stacked subtree ``key`` (this rank's shards)
        gathered for use and tagged."""
        return tree_map(lambda t, s, a: self._use_leaf(t, s, a, 1),
                        local, self.shardings[key], self.axes[key])

    def stacked(self, key: str) -> bool:
        """Whether the top-level subtree ``key`` stacks layers (its
        leaves' first axis ``layers``), which gather in a layer's body."""
        return tree_leaves(self.axes[key])[0][:1] == ("layers",)

    def use_top(self, params) -> Dict[str, Any]:
        """Every top-level parameter gathered and tagged but the stacked
        subtrees, whose layers gather in the layer's body."""
        return {k: (v if self.stacked(k) else
                    tree_map(lambda t, s, a: self._use_leaf(t, s, a, 0),
                             v, self.shardings[k], self.axes[k]))
                for k, v in params.items()}

    # --- batch and gradients --------------------------------------------
    @property
    def token_axes(self) -> Tuple[str, ...]:
        """The mesh axes the tokens are split over: the batch's
        (``row_axes``), and the sequence's under ``fsdp``."""
        return self.row_axes + self.seq_axes

    def seq_offset(self, s_local: int) -> int:
        """The global position of this rank's first token."""
        return self.comm.index(self.seq_axes) * s_local \
            if self.seq_axes else 0

    def seq_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole sequence ``t`` (dim 1)."""
        return self._split(t, self.seq_axes, 1, "the sequence")

    def _split(self, v, axes, dim, what):
        n, i = self.comm.size(axes), self.comm.index(axes)
        if v.shape[dim] % n:
            raise ValueError(f"{what} of {v.shape[dim]} does not split over "
                             f"{axes} ({n} ranks)")
        m = v.shape[dim] // n
        return v.narrow(dim, i * m, m)

    def local_batch(self, batch: Dict[str, torch.Tensor]):
        """(this layout bound to ``batch``, this rank's block of the
        global ``batch``): its rows (split over ``dp_axes``) and, under
        ``fsdp``, its sequence block over ``model`` (with
        ``targets_next``, the targets shifted by one on the whole
        sequence, for the multi-token head).  A vision prefix
        (``vis_embeds``) and its text are one sequence, which the model
        splits once joined: both stay whole here.  A batch or a sequence
        that does not split stays whole on every rank (a batch the data
        axes split only in part, over the first of them), as the
        reference's ``spec_for`` lays it out and ``Model.init_cache``
        lays out a cache's rows, and the bound layout's token axes leave
        the rest out; then no gradient may be taken (it would be counted
        once a replica).  ``self`` is not changed."""
        bound = copy.copy(self)
        if self.dp_axes:
            B, n = batch["tokens"].shape[0], self.comm.size(self.dp_axes)
            if B % n and torch.is_grad_enabled():
                raise ValueError(f"a batch of {B} rows does not split over "
                                 f"{self.dp_axes} ({n} ranks)")
            spec = shd.spec_for((B,), ("batch",), self.mesh,
                                {"batch": self.dp_axes})
            bound.row_axes = shd.spec_axes(spec[0]) if spec else ()
        seq = bool(self.seq_axes)
        joined = "vis_embeds" in batch
        if seq:
            S, m = batch["tokens"].shape[1], self.comm.size(self.seq_axes)
            if joined:
                S += batch["vis_embeds"].shape[1]
            seq = S % m == 0
            if not seq and torch.is_grad_enabled():
                raise ValueError(f"fsdp: a sequence of {S} does not split "
                                 f"over {self.seq_axes} ({m} ranks)")
            if seq and "targets" in batch:
                t = batch["targets"]
                batch = dict(batch, targets_next=torch.cat(
                    [t[:, 1:], -torch.ones_like(t[:, :1])], dim=1))
            if not seq:
                bound.seq_axes = ()
            bound.cst = self.cst.with_seq_axes(bound.seq_axes)
        out = {}
        for k, v in batch.items():
            if not torch.is_tensor(v) or v.dim() == 0:
                out[k] = v
                continue
            if bound.row_axes:
                v = bound._split(v, bound.row_axes, 0, f"batch {k!r}")
            if seq and v.dim() > 1 and not joined:
                v = bound._split(v, bound.seq_axes, 1, f"sequence {k!r}")
            out[k] = v
        return bound, out

    def reduce_grads(self, grads):
        """Each leaf's gradient summed over the axes the tokens are split
        over that its parameter is replicated over (the FSDP axes were
        reduce-scattered in the backward)."""
        def one(g, sh):
            axes = tuple(a for a in self.token_axes
                         if a not in sh.used_axes())
            return coll.all_reduce(g, self.comm, axes) if axes else g

        return tree_map(one, grads, self.shardings)
