"""Model assembly for every architecture of the port.

The port's ``repro.models.transformer``.  One generic decoder-only LM
(GQA/MLA attention, dense/MoE FFN) covers 7 of the 10 archs; zamba2
(hybrid Mamba2 + shared attention), xlstm (mLSTM/sLSTM) and whisper
(enc-dec) get their own assemblies.  Parameters keep the reference's
keys and stacked per-layer shapes (a leading ``layers`` axis), so the
reference's weights copy over one to one; where the reference scans
over that axis, the port loops over it, taking the layers' views with
one ``unbind`` a pass (whose backward is one ``stack``, where indexing
each layer would write a zero tensor of the whole stacked leaf per
layer).  ``cfg.remat`` wraps each layer body in
``torch.utils.checkpoint`` where the reference wraps its scan body in
``jax.checkpoint``, when autograd records and no cache is carried (a
decode step never recomputes).

:class:`Model` is a thin namespace:

* ``specs()`` -> ParamSpec tree (stacked layers); ``init(generator)``
  -> params;
* ``forward(params, batch)`` -> logits (B, S, V), the full forward pass
  (the reference has no such entry: its tests assemble it from the
  layer functions);
* ``loss(params, batch)`` -> scalar loss;
* ``decode_step(params, batch, caches)`` -> (logits, caches): the caches
  are updated in place and returned;
* ``cache_specs(batch, max_len)`` / ``input_specs(shape)`` -> ``meta``
  tensors; ``init_cache(batch, max_len)`` -> zeros.

Entry points that make tensors (``init``, ``init_cache``) run on the
card unless given ``device="cpu"``.

Under a mesh (``ParallelCtx(mesh=...)``; ``models/sharded.py``) each
rank passes its local parameter shards and the global batch; the
decoder-only LM (the dense GQA, MoE-over-GQA and MoE-with-MLA families)
computes on its batch rows with tensor, FSDP and expert parallelism:
the layers gather their parameters at use inside the layer body, the
embedding and ``_lm_head`` are split over ``vocab`` and ``_xent`` takes
its logsumexp and the target's logit across ``model`` ranks; the loss
is the global batch's mean.  zamba2, xlstm and whisper gather every
parameter whole and compute on their batch rows.  Under the ``fsdp``
profile every family also splits its sequence over ``model``: attention
gathers K and V, the recurrent mixers (``ssm``) and whisper's
cross-attention gather their input's blocks, positions (rope, M-RoPE,
whisper's tables) start at this rank's block, and qwen2-vl's vision
prefix and text are split as one sequence.  No family falls through to
unsharded compute.  A decode step under a mesh runs on this rank's
batch rows with the MoE's replicated token layout (a step whose tokens
split over ``model`` under fsdp: the split layout); its caches
(``init_cache(..., pctx=)``) lie as the reference's cache rules place
them (``parallel.sharding.cache_rules_from``), and the layers attend
over them, or gather a recurrent state at use, in that layout.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.utils.checkpoint

from ..core.policies import resolve_device
from ..parallel import collectives as coll
from ..parallel import sharding as shd
from . import layers, moe_ep, ssm
from .config import ArchConfig, ShapeConfig
from .spec import (ParamSpec, abstract_params, axes_tree, init_params,
                   tree_map)

Params = Dict[str, Any]
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Distribution context threaded through the apply functions: a
    ``DeviceMesh`` (None: one device), the activation constraint
    (``parallel.sharding.make_cst(mesh)``), the MoE path (``"ep"``
    over a mesh is ``moe_ep.moe_ep_apply``; without one, and
    ``"dense"``, the dense MoE), the data-parallel and EP axes.
    ``layout`` is the port's own: the model fills it in from the mesh
    (``models/sharded.py``) for the layers below it."""
    mesh: Any = None
    cst: Callable = layers._id_cst        # activation sharding constraint
    moe_impl: str = "dense"               # 'dense' | 'ep'
    dp_axes: Tuple[str, ...] = ("data",)
    ep_axis: Any = "model"                # one axis or a tuple
    moe_token_layout: str = "split"       # 'split' | 'replicated'
    layout: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.moe_impl not in ("dense", "ep"):
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}")


def _stack_specs(tree, n: int):
    """Add a stacked leading 'layers' dim to every spec in the tree."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.dtype, s.init, s.scale), tree)


def _cache_block(shape, axes, mesh, rules):
    """(this rank's block shape, the mesh axes of each dim beyond the
    batch rows) of a cache leaf of global ``shape`` and logical ``axes``
    under the cache ``rules``: its layout, ``layers.cache_split``."""
    sh = shd.NamedSharding(mesh, shd.spec_for(shape, axes, mesh, rules))
    return sh.local_shape(shape), tuple(
        () if a == "batch" else ax
        for a, ax in zip(axes, sh.dim_axes(len(axes))))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, no copy (a cache leaf's
    layout, ``layers.cache_split``, carried over)."""
    def one(a):
        v = a[i]
        split = getattr(a, "_split", None)
        if split is not None:
            v._split = split[1:]
        return v

    return tree_map(one, tree)


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree: views, one ``unbind`` a leaf."""
    per_leaf = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], per_leaf) for i in range(n)]


def _remat(cfg, fn: Callable, caches=None) -> Callable:
    """``fn`` recomputed in the backward pass (``torch.utils.checkpoint``)
    when ``cfg.remat`` is set, autograd records and no cache is carried;
    else ``fn``."""
    if cfg.remat and caches is None and torch.is_grad_enabled():
        return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    return fn


def _run_stack(cfg, body: Callable, lps, x, caches=None):
    """``x`` through ``body(x, lp, lcache) -> (x, ncache)`` for each layer
    of ``lps`` in order (under :func:`_remat`); ``caches`` (stacked,
    optional) are updated in place."""
    step = _remat(cfg, body, caches)
    for i, lp in enumerate(lps):
        lcache = None if caches is None else _layer(caches, i)
        x, ncache = step(x, lp, lcache)
        if caches is not None:
            _store(caches, i, lcache, ncache)
    return x


def _store(stacked, i: int, before, after) -> None:
    """Write layer ``i``'s updated cache into the stacked cache in place:
    leaves updated in place (``after is before``) are already there."""
    if isinstance(stacked, dict):
        for k in stacked:
            _store(stacked[k], i, before[k], after[k])
    elif after is not before:
        stacked[i].copy_(after)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _stack_meta(tree, n: int):
    return tree_map(lambda s: _meta((n,) + tuple(s.shape), s.dtype), tree)


def _kv_cache_spec(cfg, batch, max_len):
    return {"k": _meta((batch, max_len, cfg.n_kv_heads, cfg.hd), cfg.dtype),
            "v": _meta((batch, max_len, cfg.n_kv_heads, cfg.hd), cfg.dtype),
            "pos": _meta((), torch.int32)}


# ----------------------------------------------------------------------------
# Generic decoder layer (attention/MLA + dense-MLP/MoE)
# ----------------------------------------------------------------------------


def _decoder_layer_spec(cfg: ArchConfig) -> Params:
    p = {"ln1": layers.rmsnorm_spec(cfg.d_model),
         "ln2": layers.rmsnorm_spec(cfg.d_model)}
    if cfg.use_mla:
        p["attn"] = layers.mla_spec(cfg)
    else:
        p["attn"] = layers.attention_spec(cfg)
    if cfg.is_moe:
        p["ffn"] = layers.moe_spec(cfg)
    else:
        p["ffn"] = layers.swiglu_spec(cfg)
    return p


def _decoder_layer_apply(p: Params, cfg: ArchConfig, x, rope_cs, positions,
                         pctx: ParallelCtx, cache=None):
    cst = pctx.cst
    h = layers.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, new_cache = layers.mla_apply(p["attn"], cfg, h, positions,
                                        cst=cst, cache=cache)
    else:
        cos, sin = rope_cs
        a, new_cache = layers.attention_apply(p["attn"], cfg, h, cos, sin,
                                              cst=cst, causal=cfg.causal,
                                              cache=cache)
    x = x + a
    h = layers.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        if pctx.moe_impl == "ep" and pctx.mesh is not None:
            f = moe_ep.moe_ep_apply(p["ffn"], cfg, h, pctx.mesh,
                                    dp_axes=pctx.dp_axes,
                                    ep_axis=pctx.ep_axis, cst=cst,
                                    token_layout=pctx.moe_token_layout)
        else:
            f = layers.moe_dense_apply(p["ffn"], cfg, h, cst=cst)
    else:
        f = layers.swiglu_apply(p["ffn"], h, cst=cst)
    return x + f, new_cache


# ----------------------------------------------------------------------------
# Generic decoder-only LM (dense / MoE / VLM)
# ----------------------------------------------------------------------------


def lm_specs(cfg: ArchConfig) -> Params:
    p = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), cfg.dtype, "normal"),
        "layers": _stack_specs(_decoder_layer_spec(cfg), cfg.n_layers),
        "ln_f": layers.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), cfg.dtype, "scaled")
    if cfg.mtp:
        p["mtp_proj"] = ParamSpec((2 * cfg.d_model, cfg.d_model),
                                  ("mlp", "embed"), cfg.dtype, "scaled")
        p["mtp_layer"] = _decoder_layer_spec(_mtp_cfg(cfg))
        p["mtp_norm"] = layers.rmsnorm_spec(cfg.d_model)
    return p


def _mtp_cfg(cfg: ArchConfig) -> ArchConfig:
    return cfg.replace(n_experts=0, d_ff=cfg.moe_d_ff or cfg.d_ff)


def _positions_for(cfg: ArchConfig, B: int, S: int, vis_len: int, device,
                   offset=0):
    """Position ids of the ``S`` tokens from global position ``offset``
    on; for mrope (B,S,3), its grid read at the global index, else
    (S,)."""
    i = torch.arange(S, device=device) + offset
    if not cfg.mrope:
        return i
    # M-RoPE: vision prefix on a (t=0, h, w) grid, text sequential
    grid_w = max(int(math.sqrt(max(vis_len, 1))), 1)
    is_vis = i < vis_len
    t = torch.where(is_vis, 0, i - vis_len + (vis_len + grid_w - 1) // grid_w)
    hpos = torch.where(is_vis, i // grid_w, t)
    wpos = torch.where(is_vis, i % grid_w, t)
    pos3 = torch.stack([t, hpos, wpos], dim=-1)            # (S, 3)
    return pos3[None].expand(B, S, 3)


def _rope_for(cfg: ArchConfig, positions):
    if cfg.use_mla:
        return None
    if cfg.mrope:
        return layers.mrope_cos_sin(cfg.hd, cfg.rope_theta, positions)
    return layers.rope_freqs(cfg.hd, cfg.rope_theta, positions)


def _use_layer(pctx, lp, key):
    """Layer ``lp`` of the stacked subtree ``key`` gathered for use under
    a mesh (in the layer's body: again under remat); else as given."""
    return lp if pctx.layout is None else pctx.layout.use(lp, key)


def _scan_layers(cfg, stacked, x, rope_cs, positions, pctx, caches=None):
    """Run the decoder layers in order over the stacked axis; ``caches``
    (stacked, optional) are updated in place and returned."""
    def body(xc, lp, lcache):
        lp = _use_layer(pctx, lp, "layers")
        return _decoder_layer_apply(lp, cfg, xc, rope_cs, positions, pctx,
                                    cache=lcache)

    x = _run_stack(cfg, body, _layers(stacked, cfg.n_layers), x, caches)
    return x, caches


def _embed(w, tokens, pctx):
    """Rows ``tokens`` of the embedding ``w``; split over ``vocab``, each
    rank looks up its rows and the sum over ``model`` completes them."""
    ax = layers.kept(w, 0)
    if not ax:
        return w[tokens]
    V = w.shape[0]
    ids = tokens.to(torch.long) - pctx.cst.comm.index(ax) * V
    inside = (ids >= 0) & (ids < V)
    x = w[ids.clamp(0, V - 1)] * inside[..., None].to(w.dtype)
    return coll.reduce_from(x, pctx.cst.comm, ax)


def _embed_inputs(cfg: ArchConfig, params, batch, pctx):
    """Token (+ vision stub) embedding -> (B, S, d), vis_len.  Under a
    split sequence the vision prefix and the text (each whole:
    ``Layout.local_batch``) are one sequence, of which this rank keeps
    its block."""
    x = _embed(params["embed"], batch["tokens"], pctx)
    vis_len = 0
    if cfg.mrope and "vis_embeds" in batch:
        ve = batch["vis_embeds"].to(x.dtype)            # (B, Sv, d)
        vis_len = ve.shape[1]
        x = torch.cat([ve, x], dim=1)
        if _split_seq(pctx):
            x = pctx.layout.seq_block(x)
    return pctx.cst(x, ("batch", "seq", "embed")), vis_len


def _split_seq(pctx) -> bool:
    """Whether this step's sequence is split over ranks (fsdp)."""
    return pctx.layout is not None and bool(pctx.layout.seq_axes)


def _vocab_axes(cfg, params):
    """The mesh axes the head's vocabulary stays split over."""
    if cfg.tie_embeddings:
        return layers.kept(params["embed"], 0)
    return layers.kept(params["lm_head"], 1)


def _lm_head(cfg, params, x, pctx):
    """Logits; split over ``vocab``, this rank's vocabulary block."""
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    ax = _vocab_axes(cfg, params)
    if ax:
        x = coll.copy_to(x, pctx.cst.comm, ax)
    logits = torch.einsum("bsd,dv->bsv", x, w)
    return pctx.cst(logits, ("batch", "seq", "vocab"))


def _whole_vocab(cfg, params, logits, pctx):
    """Logits over the whole vocabulary (its blocks gathered)."""
    vax = _vocab_axes(cfg, params)
    return coll.gather_along(logits, pctx.cst.comm, vax, 2) if vax \
        else logits


def _xent(logits, targets, mask=None):
    """Mean cross-entropy in f32; targets < 0 are ignored."""
    lf = logits.to(f32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.clamp(targets, min=0).to(torch.long)
    picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    valid = (targets >= 0).to(f32)
    if mask is not None:
        valid = valid * mask
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _xent_mesh(logits, targets, vax, lay):
    """:func:`_xent` on this rank's rows and vocabulary block (``vax``
    the axes the vocabulary is split over): the logsumexp and the
    target's logit summed across them, the numerator and the count
    across the axes the tokens are split over; the global batch's
    mean."""
    comm = lay.comm
    lf = logits.to(f32)
    tgt = torch.clamp(targets, min=0).to(torch.long)
    if vax:
        V = lf.shape[-1]
        m = coll.all_reduce(lf.detach().amax(dim=-1), comm, vax, op="max")
        se = coll.reduce_from(torch.exp(lf - m[..., None]).sum(dim=-1),
                              comm, vax)
        lse = torch.log(se) + m
        ids = tgt - comm.index(vax) * V
        inside = (ids >= 0) & (ids < V)
        picked = torch.gather(lf, -1, ids.clamp(0, V - 1)[..., None])[..., 0]
        picked = coll.reduce_from(picked * inside, comm, vax)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    valid = (targets >= 0).to(f32)
    tot = torch.stack([torch.sum((lse - picked) * valid), torch.sum(valid)])
    if lay.token_axes:
        tot = coll.reduce_from(tot, comm, lay.token_axes)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def _loss_xent(cfg, params, logits, targets, pctx):
    if pctx.layout is None:
        return _xent(logits, targets)
    return _xent_mesh(logits, targets, _vocab_axes(cfg, params), pctx.layout)


def _on_mesh(cfg, params, batch, pctx):
    """Under a mesh: (the top-level parameters gathered, this rank's
    batch rows, the context with its layout); else, or when the layout
    is already made, as given (``sharded.Layout``: the decoder-only LM
    computes tensor parallel; the other families gather every parameter
    whole)."""
    if pctx.mesh is None or pctx.layout is not None:
        return params, batch, pctx
    from .sharded import Layout
    lay, batch = Layout(cfg, pctx).local_batch(batch)
    pctx = dataclasses.replace(pctx, cst=lay.cst, layout=lay)
    return lay.use_top(params), batch, pctx


def _seq_offset(pctx, s_local: int) -> int:
    """The global position of this rank's first token (0 but under the
    fsdp profile's sequence split)."""
    return 0 if pctx.layout is None else pctx.layout.seq_offset(s_local)


def _mtp_proj(hcat, w, pctx):
    """``hcat @ w``; ``w``'s rows split over ``model``: this rank's
    features of ``hcat``, the partial products summed."""
    ax = layers.kept(w, 0)
    if not ax:
        return torch.einsum("bse,ed->bsd", hcat, w)
    comm = pctx.cst.comm
    n = w.shape[0]
    hc = coll.copy_to(hcat, comm, ax).narrow(-1, comm.index(ax) * n, n)
    return coll.reduce_from(torch.einsum("bse,ed->bsd", hc, w), comm, ax)


def _lm_trunk(cfg, params, batch, pctx):
    """-> (logits over the whole sequence, final hidden, vis_len)."""
    x, vis_len = _embed_inputs(cfg, params, batch, pctx)
    B, S, _ = x.shape
    positions = _positions_for(cfg, B, S, vis_len, x.device,
                               offset=_seq_offset(pctx, S))
    x, _ = _scan_layers(cfg, params["layers"], x, _rope_for(cfg, positions),
                        positions, pctx)
    x = layers.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return _lm_head(cfg, params, x, pctx), x, vis_len


def lm_forward(cfg: ArchConfig, params: Params, batch: Dict,
               pctx: ParallelCtx):
    """Logits (B, S, V) over the whole sequence, vision prefix included
    (under a mesh: this rank's rows, the whole vocabulary)."""
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    return _whole_vocab(cfg, params, _lm_trunk(cfg, params, batch, pctx)[0],
                        pctx)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict, pctx: ParallelCtx):
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    logits, x, vis_len = _lm_trunk(cfg, params, batch, pctx)
    B = x.shape[0]
    targets = batch["targets"]
    if vis_len and _split_seq(pctx):
        # loss only over the text region: this rank's block of the
        # joined sequence, whose vision positions have no target
        targets = pctx.layout.seq_block(torch.cat(
            [torch.full((B, vis_len), -1, dtype=targets.dtype,
                        device=targets.device), targets], dim=1))
    elif vis_len:
        # loss only over the text region
        logits = logits[:, vis_len:]
    loss = _loss_xent(cfg, params, logits, targets, pctx)
    if cfg.mtp:
        # multi-token prediction: h with the next token's embedding, one
        # extra layer, predict t+2 (DeepSeek-V3 MTP, D=1)
        emb_next = _embed(params["embed"],
                          torch.clamp(batch["targets"], min=0), pctx)
        h = x[:, vis_len:] if vis_len else x
        hcat = torch.cat([h, emb_next.to(h.dtype)], dim=-1)
        hm = _mtp_proj(hcat, params["mtp_proj"], pctx)
        pos2 = _positions_for(cfg, B, hm.shape[1], 0, hm.device,
                              offset=_seq_offset(pctx, hm.shape[1]))
        hm, _ = _decoder_layer_apply(params["mtp_layer"], _mtp_cfg(cfg), hm,
                                     _rope_for(cfg, pos2), pos2, pctx)
        hm = layers.rmsnorm_apply(params["mtp_norm"], hm, cfg.norm_eps)
        logits2 = _lm_head(cfg, params, hm, pctx)
        tgt2 = batch.get("targets_next")     # a split sequence's
        if tgt2 is None:
            tgt2 = torch.cat([batch["targets"][:, 1:],
                              -torch.ones_like(batch["targets"][:, :1])],
                             dim=1)
        loss = loss + 0.3 * _loss_xent(cfg, params, logits2, tgt2, pctx)
    return loss


def lm_decode_step(cfg: ArchConfig, params: Params, batch: Dict, caches,
                   pctx: ParallelCtx):
    """One-token decode: batch = {'tokens': (B,1), 'pos': int or ()};
    under a mesh this rank's rows of the logits (the whole vocabulary)
    and its caches (``Model.init_cache(..., pctx=)``)."""
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    tokens, pos = batch["tokens"], batch["pos"]
    B, S = tokens.shape
    x = _embed(params["embed"], tokens, pctx)
    positions = _positions_for(cfg, B, S, 0, x.device,
                               offset=pos + _seq_offset(pctx, S))
    # one token cannot split over 'model': the MoE's replicated layout
    # (a step whose tokens split over it, under fsdp, dispatches them as
    # they lie)
    layout = "split" if _split_seq(pctx) else "replicated"
    x, caches = _scan_layers(cfg, params["layers"], x,
                             _rope_for(cfg, positions), positions,
                             dataclasses.replace(
                                 pctx, moe_token_layout=layout),
                             caches=caches)
    x = layers.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return _whole_vocab(cfg, params, _lm_head(cfg, params, x, pctx),
                        pctx), caches


def lm_cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    if cfg.use_mla:
        per = {"c_kv": _meta((batch, max_len, cfg.kv_lora_rank), cfg.dtype),
               "k_rope": _meta((batch, max_len, cfg.qk_rope_dim), cfg.dtype),
               "pos": _meta((), torch.int32)}
    else:
        per = _kv_cache_spec(cfg, batch, max_len)
    return _stack_meta(per, cfg.n_layers)


# ----------------------------------------------------------------------------
# xLSTM assembly (alternating mLSTM / sLSTM blocks)
# ----------------------------------------------------------------------------


def xlstm_specs(cfg: ArchConfig) -> Params:
    pair = {
        "m_ln": layers.rmsnorm_spec(cfg.d_model),
        "m": ssm.mlstm_spec(cfg),
        "s_ln": layers.rmsnorm_spec(cfg.d_model),
        "s": ssm.slstm_spec(cfg),
    }
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), cfg.dtype, "normal"),
        "pairs": _stack_specs(pair, cfg.n_layers // 2),
        "ln_f": layers.rmsnorm_spec(cfg.d_model),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), cfg.dtype, "scaled"),
    }


def _xlstm_pair_apply(lp, cfg, x, pctx, cache=None):
    cm = cache["m"] if cache is not None else None
    cs_ = cache["s"] if cache is not None else None
    h = layers.rmsnorm_apply(lp["m_ln"], x, cfg.norm_eps)
    a, ncm = ssm.mlstm_apply(lp["m"], cfg, h, cst=pctx.cst, cache=cm)
    x = x + a
    h = layers.rmsnorm_apply(lp["s_ln"], x, cfg.norm_eps)
    a, ncs = ssm.slstm_apply(lp["s"], cfg, h, cst=pctx.cst, cache=cs_)
    x = x + a
    ncache = {"m": ncm, "s": ncs} if cache is not None else None
    return x, ncache


def _xlstm_run(cfg, params, x, pctx, caches=None):
    def body(xc, lp, lcache):
        lp = _use_layer(pctx, lp, "pairs")
        return _xlstm_pair_apply(lp, cfg, xc, pctx, cache=lcache)

    x = _run_stack(cfg, body, _layers(params["pairs"], cfg.n_layers // 2),
                   x, caches)
    x = layers.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return pctx.cst(logits, ("batch", "seq", "vocab"))


def xlstm_forward(cfg, params, batch, pctx):
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    x = pctx.cst(params["embed"][batch["tokens"]], ("batch", "seq", "embed"))
    return _xlstm_run(cfg, params, x, pctx)


def xlstm_decode_step(cfg, params, batch, caches, pctx):
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    x = params["embed"][batch["tokens"]]
    return _xlstm_run(cfg, params, x, pctx, caches), caches


def xlstm_cache_specs(cfg, batch, max_len):
    per = {"m": ssm.mlstm_cache_spec(cfg, batch),
           "s": ssm.slstm_cache_spec(cfg, batch)}
    return _stack_meta(per, cfg.n_layers // 2)


# ----------------------------------------------------------------------------
# Zamba2 assembly (Mamba2 stack + ONE shared attention block every k layers)
# ----------------------------------------------------------------------------


def zamba_n_sites(cfg: ArchConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def zamba_specs(cfg: ArchConfig) -> Params:
    mamba_layer = {"ln": layers.rmsnorm_spec(cfg.d_model),
                   "mamba": ssm.mamba2_spec(cfg)}
    # the shared attention block reads concat(hidden, embedding): the
    # zamba "shared block with concatenated input" design
    shared = {
        "ln": layers.rmsnorm_spec(2 * cfg.d_model),
        "attn": layers.attention_spec(cfg, d_in=2 * cfg.d_model,
                                      d_out=cfg.d_model),
        "out": ParamSpec((cfg.d_model, cfg.d_model),
                         ("embed", "embed_out"), cfg.dtype, "scaled"),
    }
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), cfg.dtype, "normal"),
        "mamba_layers": _stack_specs(mamba_layer, cfg.n_layers),
        "shared_attn": shared,
        "ln_f": layers.rmsnorm_spec(cfg.d_model),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), cfg.dtype, "scaled"),
    }


def _zamba_shared_attn(sp, cfg, x, x0, rope_cs, pctx, cache=None):
    """Shared block: attn over concat(x, x0), projected back to d."""
    h = torch.cat([x, x0], dim=-1)
    h = layers.rmsnorm_apply(sp["ln"], h, cfg.norm_eps)
    cos, sin = rope_cs
    a, ncache = layers.attention_apply(sp["attn"], cfg, h, cos, sin,
                                       cst=pctx.cst, causal=True,
                                       cache=cache)
    return x + torch.einsum("bsd,de->bse", a, sp["out"]), ncache


def _zamba_run(cfg, params, x, rope_cs, pctx, caches=None):
    x0 = x
    sp = params["shared_attn"]
    def body(xc, lp, i, acache, mcache):
        lp = _use_layer(pctx, lp, "mamba_layers")
        nac = None
        if i % cfg.attn_every == 0:
            xc, nac = _zamba_shared_attn(sp, cfg, xc, x0, rope_cs, pctx,
                                         cache=acache)
        h = layers.rmsnorm_apply(lp["ln"], xc, cfg.norm_eps)
        a, nmc = ssm.mamba2_apply(lp["mamba"], cfg, h, cst=pctx.cst,
                                  cache=mcache)
        return xc + a, nac, nmc

    step = _remat(cfg, body, caches)
    for i, lp in enumerate(_layers(params["mamba_layers"], cfg.n_layers)):
        site = i // cfg.attn_every
        attn = caches is not None and i % cfg.attn_every == 0
        acache = _layer(caches["attn"], site) if attn else None
        mcache = None if caches is None else _layer(caches["mamba"], i)
        x, nac, nmc = step(x, lp, i, acache, mcache)
        if attn:
            _store(caches["attn"], site, acache, nac)
        if caches is not None:
            _store(caches["mamba"], i, mcache, nmc)
    x = layers.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return pctx.cst(logits, ("batch", "seq", "vocab"))


def zamba_forward(cfg, params, batch, pctx):
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    x = pctx.cst(params["embed"][batch["tokens"]], ("batch", "seq", "embed"))
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + _seq_offset(pctx, S)
    rope_cs = layers.rope_freqs(cfg.hd, cfg.rope_theta, positions)
    return _zamba_run(cfg, params, x, rope_cs, pctx)


def zamba_decode_step(cfg, params, batch, caches, pctx):
    """caches = {'mamba': stacked(L), 'attn': stacked(n_sites)}."""
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    x = params["embed"][batch["tokens"]]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + batch["pos"] + \
        _seq_offset(pctx, S)
    rope_cs = layers.rope_freqs(cfg.hd, cfg.rope_theta, positions)
    return _zamba_run(cfg, params, x, rope_cs, pctx, caches), caches


def zamba_cache_specs(cfg, batch, max_len):
    return {"mamba": _stack_meta(ssm.mamba2_cache_spec(cfg, batch),
                                 cfg.n_layers),
            "attn": _stack_meta(_kv_cache_spec(cfg, batch, max_len),
                                zamba_n_sites(cfg))}


# ----------------------------------------------------------------------------
# Whisper (enc-dec) assembly: the conv frontend is a stub, the batch
# provides precomputed frame embeddings (B, enc_len, d).
# ----------------------------------------------------------------------------


def whisper_specs(cfg: ArchConfig, max_len: int = 65536) -> Params:
    enc_layer = {
        "ln1": layers.layernorm_spec(cfg.d_model),
        "attn": layers.attention_spec(cfg),
        "ln2": layers.layernorm_spec(cfg.d_model),
        "mlp": layers.gelu_mlp_spec(cfg),
    }
    dec_layer = {
        "ln1": layers.layernorm_spec(cfg.d_model),
        "attn": layers.attention_spec(cfg),
        "ln_x": layers.layernorm_spec(cfg.d_model),
        "xattn": layers.attention_spec(cfg),
        "ln2": layers.layernorm_spec(cfg.d_model),
        "mlp": layers.gelu_mlp_spec(cfg),
    }
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "embed"), cfg.dtype, "normal"),
        "enc_pos": ParamSpec((max_len, cfg.d_model), (None, "embed"),
                             cfg.dtype, "normal"),
        "dec_pos": ParamSpec((max_len, cfg.d_model), (None, "embed"),
                             cfg.dtype, "normal"),
        "enc_layers": _stack_specs(enc_layer, cfg.enc_layers),
        "dec_layers": _stack_specs(dec_layer, cfg.n_layers),
        "ln_enc": layers.layernorm_spec(cfg.d_model),
        "ln_f": layers.layernorm_spec(cfg.d_model),
        # whisper ties the output head to the token embedding
    }


def whisper_encode(cfg, params, frames, pctx):
    """The encoder's output for ``frames`` (this rank's block of them
    under a split sequence)."""
    S = frames.shape[1]
    pe = params["enc_pos"].narrow(0, _seq_offset(pctx, S), S)
    x = pctx.cst(frames + pe[None], ("batch", "seq", "embed"))
    def body(xc, lp):
        lp = _use_layer(pctx, lp, "enc_layers")
        h = layers.layernorm_apply(lp["ln1"], xc, cfg.norm_eps)
        a, _ = layers.attention_apply(lp["attn"], cfg, h, None, None,
                                      cst=pctx.cst, causal=False,
                                      use_rope=False)
        xc = xc + a
        h = layers.layernorm_apply(lp["ln2"], xc, cfg.norm_eps)
        return xc + layers.gelu_mlp_apply(lp["mlp"], h, cst=pctx.cst)

    body = _remat(cfg, body)
    for lp in _layers(params["enc_layers"], cfg.enc_layers):
        x = body(x, lp)
    return layers.layernorm_apply(params["ln_enc"], x, cfg.norm_eps)


def _whisper_dec_layer(lp, cfg, x, enc_out, pctx, cache=None):
    h = layers.layernorm_apply(lp["ln1"], x, cfg.norm_eps)
    a, ncache = layers.attention_apply(lp["attn"], cfg, h, None, None,
                                       cst=pctx.cst, causal=True,
                                       cache=cache, use_rope=False)
    x = x + a
    h = layers.layernorm_apply(lp["ln_x"], x, cfg.norm_eps)
    x = x + layers.cross_attention_apply(lp["xattn"], cfg, h, enc_out,
                                         cst=pctx.cst)
    h = layers.layernorm_apply(lp["ln2"], x, cfg.norm_eps)
    return x + layers.gelu_mlp_apply(lp["mlp"], h, cst=pctx.cst), ncache


def _whisper_decode(cfg, params, x, enc_out, pctx, caches=None):
    def body(xc, lp, lcache):
        lp = _use_layer(pctx, lp, "dec_layers")
        return _whisper_dec_layer(lp, cfg, xc, enc_out, pctx, cache=lcache)

    x = _run_stack(cfg, body, _layers(params["dec_layers"], cfg.n_layers),
                   x, caches)
    x = layers.layernorm_apply(params["ln_f"], x, cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    return pctx.cst(logits, ("batch", "seq", "vocab"))


def whisper_forward(cfg, params, batch, pctx):
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    enc_out = whisper_encode(cfg, params, batch["frames"], pctx)
    # every query reads the whole encoder output: under a split sequence
    # its blocks, gathered once for every layer (gradient reduce-scattered)
    enc_out, _ = layers.seq_gather(enc_out, pctx.cst)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    pe = params["dec_pos"].narrow(0, _seq_offset(pctx, S), S)
    x = pctx.cst(params["embed"][tokens] + pe[None],
                 ("batch", "seq", "embed"))
    return _whisper_decode(cfg, params, x, enc_out, pctx)


def whisper_decode_step(cfg, params, batch, caches, pctx):
    """caches: the stacked decoder self-attention caches; the encoder
    output ``batch['enc_out']`` is computed once and carried outside."""
    params, batch, pctx = _on_mesh(cfg, params, batch, pctx)
    tokens, pos = batch["tokens"], batch["pos"]
    pe = params["dec_pos"]
    S = tokens.shape[1]
    # the rows from pos on, read on the device (no host read of pos)
    rows = torch.as_tensor(pos, device=pe.device).long() + \
        torch.arange(S, device=pe.device) + _seq_offset(pctx, S)
    x = params["embed"][tokens] + pe.index_select(0, rows)[None]
    # a step whose tokens split over ranks splits enc_out with them
    enc_out, _ = layers.seq_gather(batch["enc_out"], pctx.cst)
    return _whisper_decode(cfg, params, x, enc_out, pctx, caches), caches


def whisper_cache_specs(cfg, batch, max_len):
    return _stack_meta(_kv_cache_spec(cfg, batch, max_len), cfg.n_layers)


# ----------------------------------------------------------------------------
# Model facade
# ----------------------------------------------------------------------------


def _family(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "xlstm"
    if cfg.family == "hybrid":
        return "zamba"
    if cfg.enc_dec:
        return "whisper"
    return "lm"


_SPECS = {"lm": lm_specs, "xlstm": xlstm_specs, "zamba": zamba_specs,
          "whisper": whisper_specs}
_FORWARD = {"lm": lm_forward, "xlstm": xlstm_forward, "zamba": zamba_forward,
            "whisper": whisper_forward}
_DECODE = {"lm": lm_decode_step, "xlstm": xlstm_decode_step,
           "zamba": zamba_decode_step, "whisper": whisper_decode_step}
_CACHE_SPECS = {"lm": lm_cache_specs, "xlstm": xlstm_cache_specs,
                "zamba": zamba_cache_specs, "whisper": whisper_cache_specs}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # --- specs/init ---
    def specs(self):
        return _SPECS[_family(self.cfg)](self.cfg)

    def init(self, generator, device=None, shardings=None):
        """Parameters drawn from ``generator`` (a ``torch.Generator``,
        or an int seeding one on ``device``, default the card); with
        ``shardings`` (``param_shardings`` on a mesh) this rank's
        blocks of the same values."""
        if isinstance(generator, int):
            dev = resolve_device(device)
            generator = torch.Generator(device=dev).manual_seed(generator)
        return init_params(self.specs(), generator, device, shardings)

    def param_shardings(self, pctx: "ParallelCtx"):
        """Each parameter's layout on ``pctx.mesh`` (its profile's
        parameter rules)."""
        return self.layout(pctx).shardings

    def layout(self, pctx: "ParallelCtx"):
        """The ``sharded.Layout`` of this model on ``pctx.mesh``: its
        parameters' shardings and the axes a gradient sums over
        (``reduce_grads``), as the loss lays them out."""
        from .sharded import Layout
        return Layout(self.cfg, pctx)

    def abstract_params(self):
        return abstract_params(self.specs())

    def param_axes(self):
        return axes_tree(self.specs())

    # --- forward paths ---
    def forward(self, params, batch, pctx: ParallelCtx = ParallelCtx()):
        """Logits (B, S, V) of the full forward pass."""
        return _FORWARD[_family(self.cfg)](self.cfg, params, batch, pctx)

    def loss(self, params, batch, pctx: ParallelCtx = ParallelCtx()):
        fam = _family(self.cfg)
        if fam == "lm":
            return lm_loss(self.cfg, params, batch, pctx)
        params, batch, pctx = _on_mesh(self.cfg, params, batch, pctx)
        logits = _FORWARD[fam](self.cfg, params, batch, pctx)
        if pctx.layout is None:
            return _xent(logits, batch["targets"])
        return _xent_mesh(logits, batch["targets"], (), pctx.layout)

    def decode_step(self, params, batch, caches,
                    pctx: ParallelCtx = ParallelCtx()):
        """The S tokens ``batch["tokens"]`` (B, S) at positions ``pos``,
        ``pos + 1``, ... ``pos + S - 1`` against ``caches``, which are
        updated in place: -> (logits (B, S, V), or this rank's sequence
        block of them under fsdp, caches).  Under a mesh the caches are
        those of ``init_cache(..., pctx=)``, checked leaf by leaf."""
        if pctx.mesh is not None:
            self._check_cache(caches, pctx)
        return _DECODE[_family(self.cfg)](self.cfg, params, batch, caches,
                                          pctx)

    def cache_specs(self, batch: int, max_len: int):
        return _CACHE_SPECS[_family(self.cfg)](self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, device=None,
                   pctx: ParallelCtx = ParallelCtx()):
        """Zero caches; under a mesh (``pctx``) this rank's block of each
        leaf as the reference lays it out: ``spec_for`` under the cache
        rules of the profile's activation rules
        (``parallel.sharding.cache_rules_from``): the batch over the data
        axes; K/V's kv heads over ``model`` where they divide it, else
        its ``head_dim`` (under fsdp its positions first); a recurrent
        state's ``heads``/``mlp``/``head_dim`` likewise.  Each leaf is
        tagged with the mesh axes its dims beyond the batch rows are
        split over (``layers.cache_split``), which the decode step
        checks against the rules and reads."""
        dev = resolve_device(device)
        specs = self.cache_specs(batch, max_len)
        if pctx.mesh is None:
            return tree_map(lambda s: torch.zeros(
                s.shape, dtype=s.dtype, device=dev), specs)
        rules = self._cache_rules(pctx)

        def one(s, axes):
            local, split = _cache_block(s.shape, axes, pctx.mesh, rules)
            t = torch.zeros(local, dtype=s.dtype, device=dev)
            t._split = split
            return t

        return tree_map(one, specs, shd.cache_axes_like(specs, self.cfg))

    def _cache_rules(self, pctx):
        """The cache rules of ``pctx``'s profile."""
        return shd.cache_rules_from(self.layout(pctx).cst.rules)

    def _check_cache(self, caches, pctx) -> None:
        """Raise unless every leaf of ``caches`` carries the layout
        :meth:`init_cache` gave it under ``pctx`` (a copy of a cache, by
        ``clone``, ``.to`` or ``torch.save``, drops it) and that layout
        is the cache rules' for the global shape it implies."""
        sizes = shd.mesh_axis_sizes(pctx.mesh)
        rules = self._cache_rules(pctx)

        def one(t, axes):
            split = getattr(t, "_split", None)
            if split is None or len(split) != t.dim():
                raise ValueError(
                    f"a cache leaf of shape {tuple(t.shape)} has no mesh "
                    f"layout: under a mesh decode_step takes the caches of "
                    f"init_cache(..., pctx=), updated in place")
            glob = tuple(n * math.prod(sizes[a] for a in ax)
                         for n, ax in zip(t.shape, split))
            _, want = _cache_block(glob, axes, pctx.mesh, rules)
            if want != split:
                raise ValueError(
                    f"a cache leaf of shape {tuple(t.shape)} split over "
                    f"{split} is not the cache rules' block ({want}) of "
                    f"{glob}")

        tree_map(one, caches, shd.cache_axes_like(caches, self.cfg))

    # --- abstract inputs ---
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": _meta((B, S), i32),
                     "targets": _meta((B, S), i32)}
            if cfg.mrope:
                vis = int(S * cfg.vis_prefix_frac)
                batch["tokens"] = _meta((B, S - vis), i32)
                batch["targets"] = _meta((B, S - vis), i32)
                batch["vis_embeds"] = _meta((B, vis, cfg.d_model), cfg.dtype)
            if cfg.enc_dec:
                enc_len = int(S * cfg.enc_len_frac)
                batch["frames"] = _meta((B, enc_len, cfg.d_model), cfg.dtype)
            return batch
        # decode: one token with a KV cache of S
        batch = {"tokens": _meta((B, 1), i32), "pos": _meta((), i32)}
        if cfg.enc_dec:
            enc_len = int(S * cfg.enc_len_frac)
            batch["enc_out"] = _meta((B, enc_len, cfg.d_model), cfg.dtype)
        return batch
