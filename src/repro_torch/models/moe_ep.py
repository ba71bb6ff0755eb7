"""Expert-parallel MoE over the mesh: local routing, two all_to_alls.

The port of ``repro.models.moe_ep``.  Expert FFNs are the "submodel"
pattern: many independent small systems batched for device saturation,
each expert's weights one block.  The dispatch and combine are local
routing decisions plus exactly two collectives (all_to_all out and
back) over the expert-parallel (EP) axes, issued through
``parallel.collectives`` on this rank's local blocks (the reference's
``shard_map`` body, run by every rank).

Two token layouts:

* ``split``      — tokens are partitioned over the EP axis too: this
  rank's sequence block over ``model`` enters, the block of every
  ``model`` rank leaves (all-gathered).  Dispatch = all_to_all.  Train
  and prefill shapes.
* ``replicated`` — tokens replicated over the EP axis (decode: too few
  tokens to split).  Each rank computes only the items routed to ITS
  experts; the combine is one all_reduce.  A multi-axis EP runs the
  all_to_all path with each ``model`` replica dispatching its copy.
  This layout serves decode and is forward-only under a multi-axis EP
  (each replica's copy reaches the experts, so their gradients would
  count it once a replica).

Both use capacity buffers with drop (GShard/Switch semantics,
``cfg.moe_cap_factor``): an item's rank within its bucket is the count
of earlier items bound there, in the reference's item order, so the
same items drop.  ``REPRO_MOE_FP8=1`` quantises the out leg to
``float8_e4m3fn``, sent as its ``uint8`` bytes (gloo has no fp8); its
gradient passes straight through in the input's dtype.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import collectives as coll
from . import layers
from .config import ArchConfig

f32 = torch.float32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _scatter_to_buffer(values, dest, pos, nbuckets: int, cap: int):
    """Scatter values (N, ...) into (nbuckets, cap, ...) at [dest, pos],
    dropping items with pos >= cap.  Collision-free by construction
    (pos is a rank within its bucket)."""
    valid = pos < cap
    d = torch.where(valid, dest, 0)
    s = torch.where(valid, pos, 0)
    buf = values.new_zeros((nbuckets, cap) + tuple(values.shape[1:]))
    vmask = valid.reshape((-1,) + (1,) * (values.ndim - 1))
    return buf.index_put((d, s), values * vmask, accumulate=True)


def _rank_in_bucket(dest: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """pos[i] = number of j<i with dest[j]==dest[i]  (cumsum of one-hot)."""
    onehot = F.one_hot(dest, nbuckets)
    ranks = torch.cumsum(onehot, dim=0) - 1
    return torch.gather(ranks, 1, dest[:, None])[:, 0]


def _expert_ffn(xe, w1, w3, w2):
    """xe: (E_loc, C, d); w*: (E_loc, d, f)/(E_loc, f, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w1)) * \
        torch.einsum("ecd,edf->ecf", xe, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


class _AllToAllFP8(torch.autograd.Function):
    """The out leg in float8_e4m3fn bytes; the gradient straight back in
    the input's dtype."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        q = x.to(torch.float8_e4m3fn).view(torch.uint8)
        r = coll.all_to_all_raw(q, comm, axes)
        return r.view(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return coll.all_to_all_raw(g, ctx.comm, ctx.axes), None, None


def _combine(T, d, item_tok, got, item_w):
    out = torch.zeros((T, d), dtype=f32, device=got.device)
    return out.index_add(0, item_tok, got.to(f32) * item_w[:, None])


def _moe_local(cfg: ArchConfig, ep: int, cap: int, cap_e: int, x_loc,
               router, w1, w3, w2, *, comm, axes: Tuple[str, ...],
               my_shard: int, replicated_tokens: bool,
               stats: Optional[Dict] = None):
    """Per-rank MoE body.  x_loc: (T_loc, d) local tokens; w*: (E_loc,
    ...) local experts."""
    T, d = x_loc.shape
    E_loc = w1.shape[0]
    k = cfg.experts_per_tok

    logits = torch.einsum("td,de->te", x_loc.to(f32), router)
    wgt, ids = layers.router_topk(logits, k, cfg.router_impl)  # (T,k)

    # flatten routed items
    item_tok = torch.arange(T, device=x_loc.device).repeat_interleave(k)
    item_eid = ids.reshape(-1)                           # global expert id
    item_w = wgt.reshape(-1)

    if replicated_tokens:
        # keep only items owned by my shard; combine with a sum at the end
        mine = (item_eid // E_loc) == my_shard
        eloc = torch.where(mine, item_eid % E_loc, 0)
        pos = _rank_in_bucket(torch.where(mine, eloc, E_loc), E_loc + 1)
        pos = torch.where(mine, pos, cap_e)             # drop foreign items
        xe = _scatter_to_buffer(x_loc[item_tok], eloc, pos, E_loc, cap_e)
        ye = _expert_ffn(xe, w1, w3, w2)                # (E_loc, cap_e, d)
        ok = pos < cap_e
        got = ye[torch.where(ok, eloc, 0), torch.where(ok, pos, 0)]
        got = got * (ok & mine)[:, None]
        if stats is not None:
            _tally(stats, T * k, (mine & ~ok).sum())
        out = coll.reduce_from(_combine(T, d, item_tok, got, item_w), comm,
                               axes)
        return out.to(x_loc.dtype)

    # ---- split tokens: all_to_all dispatch ----
    dest = item_eid // E_loc                             # destination shard
    pos = _rank_in_bucket(dest, ep)                      # rank within dest
    x_send = _scatter_to_buffer(x_loc[item_tok], dest, pos, ep, cap)
    eid_send = _scatter_to_buffer(item_eid[:, None] + 1, dest, pos, ep,
                                  cap)[..., 0]           # 0 = invalid
    # fp8 dispatch: the OUT leg in e4m3 halves the dispatch bytes; the
    # combine leg (expert outputs) stays in the activations' dtype
    if os.environ.get("REPRO_MOE_FP8", "0") == "1":
        x_recv = _AllToAllFP8.apply(x_send, comm, axes)
    else:
        x_recv = coll.all_to_all(x_send, comm, axes)
    eid_recv = coll.all_to_all_raw(eid_send, comm, axes)
    R = ep * cap
    xr = x_recv.reshape(R, d)
    er = eid_recv.reshape(R)
    rvalid = er > 0
    eloc = torch.where(rvalid, (er - 1) % E_loc, 0)
    pos2 = _rank_in_bucket(torch.where(rvalid, eloc, E_loc), E_loc + 1)
    pos2 = torch.where(rvalid, pos2, cap_e)
    xe = _scatter_to_buffer(xr, eloc, pos2, E_loc, cap_e)
    ye = _expert_ffn(xe, w1, w3, w2)                     # (E_loc, cap_e, d)
    ok2 = pos2 < cap_e
    yr = ye[torch.where(ok2, eloc, 0), torch.where(ok2, pos2, 0)]
    yr = yr * (ok2 & rvalid)[:, None]
    y_back = coll.all_to_all(yr.reshape(ep, cap, d), comm, axes)
    # item i finds its result at y_back[dest_i, pos_i] (if not dropped)
    ok = pos < cap
    got = y_back[torch.where(ok, dest, 0), torch.where(ok, pos, 0)]
    got = got * ok[:, None]
    if stats is not None:
        _tally(stats, T * k, (~ok).sum() + (rvalid & ~ok2).sum())
    return _combine(T, d, item_tok, got, item_w).to(x_loc.dtype)


def _tally(stats: Dict, items: int, dropped) -> None:
    stats["items"] = stats.get("items", 0) + items
    stats["dropped"] = stats.get("dropped", 0) + dropped


def _local_experts(w, E: int, E_loc: int, comm, ep_axes):
    """This rank's E_loc experts of ``w``: its block of a full (E, ...)
    tensor, or ``w`` itself when it holds E_loc."""
    if w.shape[0] == E_loc:
        return w
    if w.shape[0] != E:
        raise ValueError(f"expert weights of {w.shape[0]} experts: neither "
                         f"all {E} nor this rank's {E_loc}")
    i = comm.index(ep_axes)
    return w[i * E_loc:(i + 1) * E_loc]


def moe_ep_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, mesh, *,
                 dp_axes: Tuple[str, ...] = ("data",),
                 ep_axis="model",
                 cst: Callable = layers._id_cst,
                 token_layout: str = "split",
                 stats: Optional[Dict] = None) -> torch.Tensor:
    """Expert-parallel MoE layer, run by every rank of ``mesh``.

    ``x``: this rank's (B_loc, S, d) block, its batch rows over
    ``dp_axes`` and replicated over ``model`` (the activations' layout;
    under the fsdp profile, ``cst.seq_axes``, its sequence block over
    ``model``, which the ``split`` layout dispatches as it is);
    -> the same block of the output.  ``p``: the router (replicated),
    the experts' ``w1``/``w3``/``w2`` (all E experts or this rank's
    E_loc, its block over the EP axes) and an optional ``shared``
    expert.  ``ep_axis`` is one mesh axis or a TUPLE, e.g.
    ``('model','data')``: every rank owns E/(model*data) experts
    outright and only tokens move.  ``stats`` (a dict), when given,
    accumulates ``items`` (routed items) and ``dropped`` (a 0-d tensor,
    this rank's drops).
    """
    B, S, d = x.shape
    comm = coll.comm_of(mesh)
    ep_axes = (ep_axis,) if isinstance(ep_axis, str) else tuple(ep_axis)
    ep = comm.size(ep_axes)
    E = cfg.n_experts
    if E % ep != 0:
        raise ValueError(f"{E} experts over an EP group of {ep}")
    E_loc = E // ep
    k = cfg.experts_per_tok
    m = comm.sizes.get("model", 1)
    multi_axis = len(ep_axes) > 1
    # the fsdp profile's activations: the sequence already split
    pre_split = "model" in getattr(cst, "seq_axes", ())
    if token_layout == "split" and pre_split:
        T_loc = B * S
        use_a2a, dup = True, 1
    elif token_layout == "split":
        if S % m != 0:
            raise ValueError(f"sequence {S} does not split over model={m}")
        T_loc = B * (S // m)
        use_a2a, dup = True, 1
    elif token_layout == "replicated":
        T_loc = B * S
        use_a2a = multi_axis          # single-axis: the all_reduce path
        dup = m if multi_axis else 1
    else:
        raise ValueError(f"unknown token_layout {token_layout!r}")

    n_items = T_loc * k
    cap = _round_up(max(int(n_items / ep * cfg.moe_cap_factor * dup), 8), 8)
    cap_e = _round_up(max(int(n_items / max(E_loc, 1) *
                              cfg.moe_cap_factor), 8), 8) \
        if not use_a2a else \
        _round_up(max(int(ep * cap / max(E_loc, 1) * 1.25), 8), 8)
    coll_axes = ep_axes if use_a2a else ep_axes[:1]
    w1, w3, w2 = (_local_experts(p[n], E, E_loc, comm, ep_axes)
                  for n in ("w1", "w3", "w2"))
    router, x_in = p["router"], x
    if token_layout == "split" and pre_split:
        pass                          # each rank's tokens are its own
    elif token_layout == "split":
        # tokens split over model: the router's gradient sums over it
        if "model" in comm.sizes:
            router = coll.copy_to(router, comm, "model")
            x_in = coll.split_along(x, comm, "model", 1)
    elif not multi_axis:
        # each rank's items are its experts': partial gradients
        router = coll.copy_to(router, comm, coll_axes)
        x_in = coll.copy_to(x, comm, coll_axes)
    Bl, Sl, _ = x_in.shape
    out = _moe_local(cfg, ep, cap, cap_e, x_in.reshape(Bl * Sl, d), router,
                     w1, w3, w2, comm=comm, axes=coll_axes,
                     my_shard=comm.index(coll_axes),
                     replicated_tokens=not use_a2a, stats=stats)
    out = out.reshape(Bl, Sl, d)
    if token_layout == "split" and "model" in comm.sizes and not pre_split:
        out = coll.gather_along(out, comm, "model", 1)
    if "shared" in p:
        out = out + layers.swiglu_apply(p["shared"], x, cst=cst)
    return cst(out, ("batch", "seq", "embed"))
