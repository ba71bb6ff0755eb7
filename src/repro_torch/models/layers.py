"""Transformer building blocks shared by every architecture of the port.

The port's ``repro.models.layers``, function for function:

* params are nested dicts of tensors, their specs built by the
  ``*_spec`` functions (one source of truth, see :mod:`.spec`);
* every ``*_apply`` takes a ``cst(x, axes)`` callback, the reference's
  logical sharding constraint: the identity on one device; under a mesh
  a ``parallel.sharding.ShardCst``, also the identity on the local
  blocks, whose ``comm`` the tensor-parallel layers issue their
  collectives through;
* activations are in ``cfg.dtype``; norms and softmax accumulate in
  float32.

Under a mesh a layer computes what the reference's ``cst`` sites ask
GSPMD for, on its parameters' local blocks (``models/sharded.py``);
under the fsdp profile attention gathers K and V (MLA: the latent and
the rope key) over the axes the sequence is split over
(:func:`seq_gather`).  Under tp_fsdp:
where a weight's heads (or ``mlp``) dim is kept split over ``model``
(:func:`kept`), the input enters through ``collectives.copy_to`` (its
gradient all-reduced), each rank computes its heads, and the
row-parallel output product is followed by one all_reduce
(``collectives.reduce_from``).  A dim left replicated computes
replicated, with no collective.

A KV cache is written in place (:func:`dus_seq`): a decode step writes
its new keys and values into the cache it is given and returns that
same storage, so no step copies or pads the cache.  Attention
(:func:`_sdpa`) is the reference's chunked online softmax in plain
PyTorch; no kernel and no library attention lies on this path.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import collectives as coll
from .config import ArchConfig
from .spec import ParamSpec

Params = Dict[str, Any]
f32 = torch.float32


def _id_cst(x, axes):
    return x


def kept(w: torch.Tensor, dim: int):
    """The mesh axes dim ``dim`` of a parameter stays split over (``()``
    on one device, or where the dim is gathered or replicated)."""
    k = getattr(w, "_kept", None)
    return k[dim] if k else ()


def seq_gather(t: torch.Tensor, cst, dim: int = 1):
    """(``t``'s blocks over the axes the sequence is split over,
    concatenated along ``dim``; the global position of this rank's first
    token): ``(t, 0)`` unless ``cst`` splits the sequence (the fsdp
    profile).  The gradient of the gathered tensor is reduce-scattered
    back, since each rank's queries read every block."""
    ax = getattr(cst, "seq_axes", ())
    if not ax:
        return t, 0
    return coll.gather_fsdp(t, cst.comm, ax, dim), \
        cst.comm.index(ax) * t.shape[dim]


def cache_split(t: torch.Tensor, dim: int):
    """The mesh axes dim ``dim`` of one layer's cache leaf is split over
    beyond this rank's batch rows (``()``: whole).  ``Model.init_cache
    (..., pctx=)`` tags each leaf with the cache rules' layout
    (``parallel.sharding.cache_rules_from``) and ``Model.decode_step``
    refuses an untagged leaf under a mesh: untagged is one device's
    whole cache."""
    s = getattr(t, "_split", None)
    return s[dim] if s else ()


def state_whole(t: torch.Tensor, cst):
    """A recurrent state leaf whole (its split dims gathered), for a
    family that computes it replicated over the axes it is split over."""
    for d, ax in enumerate(getattr(t, "_split", ()) or ()):
        if ax:
            t = coll.all_gather(t, cst.comm, ax, d)
    return t


def state_own(new: torch.Tensor, like: torch.Tensor, cst):
    """This rank's block of the whole state ``new`` in the layout of the
    cache leaf ``like`` (written back in place of it)."""
    for d, ax in enumerate(getattr(like, "_split", ()) or ()):
        if ax:
            m = like.shape[d]
            new = new.narrow(d, cst.comm.index(ax) * m, m)
    return new


def dus_seq(buf: torch.Tensor, upd: torch.Tensor, pos, axis: int = 1):
    """Write ``upd`` into ``buf`` at position ``pos`` (an integer tensor
    on ``buf``'s device, as a cache's ``pos`` is: no host read) along
    ``axis``, in place, and return ``buf``."""
    idx = torch.as_tensor(pos, device=buf.device).to(torch.long) + \
        torch.arange(upd.shape[axis], device=buf.device)
    return buf.index_copy_(axis, idx, upd.to(buf.dtype))


def write_seq(buf: torch.Tensor, upd: torch.Tensor, pos, cst):
    """:func:`dus_seq` into a cache whose positions (dim 1) are split
    over ``cache_split(buf, 1)``: this rank holds positions ``[i * Sl,
    (i + 1) * Sl)`` and writes those of ``upd`` (positions ``pos ...``)
    that fall in it, in place, with no host read of ``pos``."""
    ax = cache_split(buf, 1)
    if not ax:
        return dus_seq(buf, upd, pos)
    Sl, S = buf.shape[1], upd.shape[1]
    dev = buf.device
    lo = torch.as_tensor(pos, device=dev).to(torch.long) - \
        cst.comm.index(ax) * Sl
    if S == 1:
        j = lo.clamp(0, Sl - 1).reshape(1)
        own = (lo >= 0) & (lo < Sl)
        return buf.index_copy_(1, j, torch.where(
            own, upd.to(buf.dtype), buf.index_select(1, j)))
    src = torch.arange(Sl, device=dev) - lo
    inside = ((src >= 0) & (src < S)).reshape((1, Sl) + (1,) * (buf.dim() - 2))
    new = upd.to(buf.dtype).index_select(1, src.clamp(0, S - 1))
    return buf.copy_(torch.where(inside, new, buf))


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Params:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(f32)).to(x.dtype)


def layernorm_spec(d: int) -> Params:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(f32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].to(f32) + p["bias"].to(f32)).to(x.dtype)


# ----------------------------------------------------------------------------
# Rotary embeddings (standard + 3-component M-RoPE for qwen2-vl)
# ----------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, positions: torch.Tensor) -> Tuple:
    """positions: (..., S) int -> cos/sin of shape (..., S, dim//2)."""
    ar = torch.arange(0, dim, 2, dtype=f32, device=positions.device)
    inv = 1.0 / (theta ** (ar / dim))
    ang = positions.to(f32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_cos_sin(dim: int, theta: float, pos3: torch.Tensor):
    """Simplified M-RoPE: pos3 (B, S, 3) = (t, h, w) position components.

    The rotary dim is split 2:1:1 between temporal/height/width
    components (qwen2-vl's mrope_section), then the per-section cos/sin
    are concatenated: disjoint channel groups rotated by different
    position ids.
    """
    half = dim // 2
    sec = (half // 2, half // 4, half - half // 2 - half // 4)
    parts_c, parts_s = [], []
    start = 0
    for comp in range(3):
        ar = torch.arange(start, start + sec[comp], dtype=f32,
                          device=pos3.device)
        inv = 1.0 / (theta ** (ar * 2 / dim))
        ang = pos3[..., comp].to(f32)[..., None] * inv
        parts_c.append(torch.cos(ang))
        parts_s.append(torch.sin(ang))
        start += sec[comp]
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)


# ----------------------------------------------------------------------------
# GQA attention (with optional bias, sliding window, KV cache)
# ----------------------------------------------------------------------------


def attention_spec(cfg: ArchConfig, d_in: Optional[int] = None,
                   d_out: Optional[int] = None) -> Params:
    d = d_in or cfg.d_model
    do = d_out or cfg.d_model
    hd = cfg.hd
    p = {
        "wq": ParamSpec((d, cfg.n_heads, hd), ("embed", "heads", "head_dim"),
                        cfg.dtype, init="scaled"),
        "wk": ParamSpec((d, cfg.n_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim"), cfg.dtype,
                        init="scaled"),
        "wv": ParamSpec((d, cfg.n_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim"), cfg.dtype,
                        init="scaled"),
        "wo": ParamSpec((cfg.n_heads, hd, do), ("heads", "head_dim", "embed"),
                        cfg.dtype, init="scaled"),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((cfg.n_heads, hd), ("heads", "head_dim"),
                            cfg.dtype, init="zeros")
        p["bk"] = ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                            cfg.dtype, init="zeros")
        p["bv"] = ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                            cfg.dtype, init="zeros")
    return p


ATTN_KV_CHUNK = 1024  # blockwise-softmax KV chunk (memory/perf knob)


def _sdpa(q, k, v, *, causal: bool, window: int = 0, q_offset=None,
          kv_len=None, kv_chunk: int = 0, k_offset=0, head_dim=None,
          scores_over=None, keys_over=None):
    """Blockwise (flash-style) attention: q (B,Sq,H,Dq), k (B,Sk,KVH,Dq),
    v (B,Sk,KVH,Dv) -> (B,Sq,H,Dv), with a float32 running max and sum
    over KV chunks of ``kv_chunk`` (default :data:`ATTN_KV_CHUNK`): the
    (Sq, Sk) score matrix is never formed.

    q_offset: absolute position of q[0] (decode); kv_len: number of valid
    cache entries (the rest are masked with -1e30).  Both may be ints or
    integer tensors.  A last chunk shorter than the others is read as it
    is: the reference pads K and V to whole chunks, whose padded columns
    it masks, so the two agree without a copy of the cache.

    A cache split over ranks (``(comm, axes)``): ``scores_over`` sums
    each chunk's scores over them (q and k hold one block of the
    ``head_dim`` features, whose root scales the scores), ``keys_over``
    joins each rank's running max, sum and output over them (k and v
    hold the positions from ``k_offset`` on).
    """
    B, Sq, H, Dq = q.shape
    KVH = k.shape[2]
    Dv = v.shape[-1]
    rep = H // KVH
    Sk = k.shape[1]
    C = kv_chunk or min(ATTN_KV_CHUNK, Sk)
    dev = q.device
    valid_len = kv_len if kv_len is not None else Sk

    qf = (q.to(f32) / math.sqrt(head_dim or Dq)).reshape(B, Sq, KVH, rep,
                                                         Dq)
    qpos = torch.arange(Sq, device=dev)[:, None] + \
        (q_offset if q_offset is not None else 0)

    m = torch.full((B, KVH, rep, Sq), -math.inf, dtype=f32, device=dev)
    l = torch.zeros((B, KVH, rep, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, KVH, rep, Sq, Dv), dtype=f32, device=dev)
    for start in range(0, Sk, C):
        kb = k[:, start:start + C]                # (B,C,KVH,Dq)
        vb = v[:, start:start + C]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, kb.to(f32))
        if scores_over is not None:
            logits = coll.all_reduce(logits, *scores_over)
        kpos = k_offset + start + torch.arange(kb.shape[1],
                                               device=dev)[None, :]
        mask = kpos < valid_len
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale_old = torch.exp(m - m_new)
        l = l * scale_old + p.sum(dim=-1)
        acc = acc * scale_old[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, vb.to(f32))
        m = m_new
    if keys_over is not None:
        top = coll.all_reduce(m, *keys_over, op="max")
        w = torch.exp(m - top)[..., None]
        both = coll.all_reduce(torch.cat([acc * w, l[..., None] * w], -1),
                               *keys_over)
        acc, l = both[..., :Dv], both[..., Dv]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


def attention_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, cos, sin,
                    *, cst: Callable = _id_cst, causal: bool = True,
                    cache: Optional[Dict] = None, use_rope: bool = True):
    """Returns (out, new_cache).  cache = {'k','v','pos'} for decode: its
    'k' and 'v' are written in place and returned, 'pos' advanced."""
    ax, kv_ax = kept(p["wq"], 1), kept(p["wk"], 1)
    xq = coll.copy_to(x, cst.comm, ax) if ax else x
    xk = xq if kv_ax else x
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xk, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xk, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, None]
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    q = cst(q, ("batch", "seq", "heads", "head_dim"))
    k = cst(k, ("batch", "seq", "kv_heads", "head_dim"))
    if use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    new_cache = None
    if cache is not None:
        out, new_cache = _cache_attention(cfg, q, k, v, cache, cst, ax,
                                          causal)
    else:
        kw = {}
        if getattr(cst, "seq_axes", ()):
            # this rank's queries against the whole sequence's keys
            k, off = seq_gather(k, cst)
            v, _ = seq_gather(v, cst)
            kw = {"q_offset": off}
        k, v = _heads_kv(cfg, q, k, v, cst, ax)
        out = _sdpa(q, k, v, causal=causal, window=cfg.sliding_window, **kw)
    out = cst(out, ("batch", "seq", "heads", "head_dim"))
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if ax:
        y = coll.reduce_from(y, cst.comm, ax)
    return cst(y, ("batch", "seq", "embed")), new_cache


def _heads_kv(cfg, q, k, v, cst, ax):
    """K and V for this rank's query heads: where the heads are split
    over ``ax`` and K/V hold every kv head, each local query head's kv
    head (the GQA grouping of the global heads); else as given."""
    H_loc = q.shape[2]
    if not ax or k.shape[2] * (cfg.n_heads // cfg.n_kv_heads) == H_loc:
        return k, v
    h0 = cst.comm.index(ax) * H_loc
    rep = cfg.n_heads // cfg.n_kv_heads
    idx = (h0 + torch.arange(H_loc, device=q.device)) // rep
    return (coll.copy_to(k, cst.comm, ax).index_select(2, idx),
            coll.copy_to(v, cst.comm, ax).index_select(2, idx))


def _cache_attention(cfg, q, k, v, cache, cst, ax, causal):
    """Attention of the step's queries against a cache, whose ``k`` and
    ``v`` are written in place, in the cache rules' layout
    (:func:`cache_split`): whole, or split over a mesh axis along
    positions (this rank's block, the softmax joined over the axis),
    ``kv_heads`` (this rank's kv heads and their query heads, the output
    gathered) or ``head_dim`` (this rank's features of every head, the
    scores summed over the axis; the output handed back to the ranks
    its heads lie on).  Queries split over the sequence (a prompt under
    the fsdp profile) are gathered first and this rank's kept after."""
    kc, vc, pos = cache["k"], cache["v"], cache["pos"]
    comm = getattr(cst, "comm", None)
    S = q.shape[1]
    qax = getattr(cst, "seq_axes", ())
    if qax:
        q, off = seq_gather(q, cst)
        k, _ = seq_gather(k, cst)
        v, _ = seq_gather(v, cst)
    sax, kax, dax = (cache_split(kc, d) for d in (1, 2, 3))
    D = k.shape[3]
    kw = {"q_offset": pos, "kv_len": pos + q.shape[1]}
    own_heads = bool(kax) and k.shape[2] != kc.shape[2]
    if own_heads:
        # every kv head computed, this rank's kept: its query heads
        n = kc.shape[2]
        rep = cfg.n_heads // cfg.n_kv_heads
        i0 = comm.index(kax) * n
        k, v = k.narrow(2, i0, n), v.narrow(2, i0, n)
        q = q.narrow(2, i0 * rep, n * rep)
    if dax:
        n = kc.shape[3]
        d0 = comm.index(dax) * n
        k, v = k.narrow(3, d0, n), v.narrow(3, d0, n)
        if ax:
            q = coll.gather_along(q, comm, ax, 2)
        q = q.narrow(3, d0, n)
        kw.update(scores_over=(comm, dax), head_dim=D)
    if sax:
        kw.update(keys_over=(comm, sax), k_offset=comm.index(sax) *
                  kc.shape[1])
    kc = write_seq(kc, k, pos, cst)
    vc = write_seq(vc, v, pos, cst)
    new_cache = {"k": kc, "v": vc, "pos": pos + q.shape[1]}
    k, v = _heads_kv(cfg, q, kc, vc, cst, () if dax else ax)
    out = _sdpa(q, k, v, causal=causal, window=cfg.sliding_window, **kw)
    if own_heads:
        out = coll.gather_along(out, comm, kax, 2)
    if dax:
        if ax:
            # (B,S,H,n) -> each rank its heads' every feature block
            B, Sq, H, _ = out.shape
            m = comm.size(ax)
            blocks = out.reshape(B, Sq, m, H // m, n).permute(2, 0, 1, 3, 4)
            out = coll.all_to_all(blocks.contiguous(), comm, ax)
            out = out.permute(1, 2, 3, 0, 4).reshape(B, Sq, H // m, m * n)
        else:
            out = coll.gather_along(out, comm, dax, 3)
    if qax:
        out = out.narrow(1, off, S)
    return out, new_cache


def cross_attention_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                          kv_src: torch.Tensor, *, cst: Callable = _id_cst):
    """Encoder-decoder cross attention (whisper); no rope, no cache mask.
    ``kv_src`` is the whole encoder output (under the fsdp profile the
    decoder gathers its blocks once for every layer)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"])
    out = _sdpa(q, k, v, causal=False)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return cst(y, ("batch", "seq", "embed"))


# ----------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v3), with latent KV cache
# ----------------------------------------------------------------------------


def mla_spec(cfg: ArchConfig) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, qr), ("embed", "q_lora"), cfg.dtype, "scaled"),
        "q_norm": rmsnorm_spec(qr),
        "wq_b": ParamSpec((qr, H, dn + dr), ("q_lora", "heads", "head_dim"),
                          cfg.dtype, "scaled"),
        "wkv_a": ParamSpec((d, kvr + dr), ("embed", "kv_lora"), cfg.dtype,
                           "scaled"),
        "kv_norm": rmsnorm_spec(kvr),
        "wkv_b": ParamSpec((kvr, H, dn + dv), ("kv_lora", "heads", "head_dim"),
                           cfg.dtype, "scaled"),
        "wo": ParamSpec((H, dv, d), ("heads", "head_dim", "embed"),
                        cfg.dtype, "scaled"),
    }


def mla_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, positions, *,
              cst: Callable = _id_cst, cache: Optional[Dict] = None):
    """MLA with decoupled RoPE.  The cache stores the *latent* c_kv (+ the
    rope key), (kvr + dr) per token instead of 2*H*hd, written in
    place."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    S = x.shape[1]
    ax = kept(p["wq_b"], 1)           # this rank's heads (tensor parallel)

    def heads_in(t):
        return coll.copy_to(t, cst.comm, ax) if ax else t

    # --- queries ---
    q_lat = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
    q_lat = rmsnorm_apply(p["q_norm"], q_lat, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", heads_in(q_lat), p["wq_b"])
    H = q.shape[2]                    # (B,S,H,dn+dr), H local
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    # --- compressed kv + decoupled rope key ---
    ckv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])          # (B,S,kvr+dr)
    c_kv, k_rope = ckv[..., :kvr], ckv[..., kvr:]
    cos, sin = rope_freqs(dr, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)    # (B,S,1,dr)
    new_cache = None
    kw = {}
    qax = getattr(cst, "seq_axes", ()) if cache is not None else ()
    if cache is not None:
        # a cache split over positions (the fsdp profile): this rank's
        # block, the softmax joined over its axes (see _cache_attention)
        pos = cache["pos"]
        if qax:
            c_kv, off = seq_gather(c_kv, cst)
            k_rope, _ = seq_gather(k_rope, cst)
        Sn = c_kv.shape[1]
        c_all = write_seq(cache["c_kv"], c_kv, pos, cst)
        kr_all = write_seq(cache["k_rope"], k_rope[:, :, 0, :], pos, cst)
        new_cache = {"c_kv": c_all, "k_rope": kr_all, "pos": pos + Sn}
        c_use, kr_use, kv_len, q_off = c_all, kr_all, pos + Sn, pos
        sax = cache_split(c_all, 1)
        if sax:
            kw = {"keys_over": (cst.comm, sax),
                  "k_offset": cst.comm.index(sax) * c_all.shape[1]}
    else:
        c_use, q_off = seq_gather(c_kv, cst)
        kr_use, _ = seq_gather(k_rope[:, :, 0, :], cst)
        kv_len, q_off = None, (q_off or None)
    c_use = heads_in(rmsnorm_apply(p["kv_norm"], c_use, cfg.norm_eps))
    kr_use = heads_in(kr_use)
    k_nope = torch.einsum("btr,rhk->bthk", c_use, p["wkv_b"][..., :dn])
    vv = torch.einsum("btr,rhk->bthk", c_use, p["wkv_b"][..., dn:])
    k_full = torch.cat(
        [k_nope, kr_use[:, :, None, :].expand(*kr_use.shape[:2], H, dr)],
        dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    q_full = cst(q_full, ("batch", "seq", "heads", "head_dim"))
    if qax:
        q_full, _ = seq_gather(q_full, cst)
    out = _sdpa(q_full, k_full, vv, causal=True, q_offset=q_off,
                kv_len=kv_len, **kw)
    if qax:
        out = out.narrow(1, off, S)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if ax:
        y = coll.reduce_from(y, cst.comm, ax)
    return cst(y, ("batch", "seq", "embed")), new_cache


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------


def swiglu_spec(cfg: ArchConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype, "scaled"),
        "w3": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype, "scaled"),
        "w2": ParamSpec((f, d), ("mlp", "embed"), cfg.dtype, "scaled"),
    }


def swiglu_apply(p: Params, x: torch.Tensor, *, cst: Callable = _id_cst):
    ax = kept(p["w1"], 1)             # this rank's mlp block
    if ax:
        x = coll.copy_to(x, cst.comm, ax)
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w1"])) * \
        torch.einsum("bsd,df->bsf", x, p["w3"])
    h = cst(h, ("batch", "seq", "mlp"))
    y = torch.einsum("bsf,fd->bsd", h, p["w2"])
    if ax:
        y = coll.reduce_from(y, cst.comm, ax)
    return cst(y, ("batch", "seq", "embed"))


def gelu_mlp_spec(cfg: ArchConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype, "scaled"),
        "b1": ParamSpec((f,), ("mlp",), cfg.dtype, "zeros"),
        "w2": ParamSpec((f, d), ("mlp", "embed"), cfg.dtype, "scaled"),
        "b2": ParamSpec((d,), ("embed",), cfg.dtype, "zeros"),
    }


def gelu_mlp_apply(p: Params, x: torch.Tensor, *, cst: Callable = _id_cst):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(torch.einsum("bsd,df->bsf", x, p["w1"]) + p["b1"],
               approximate="tanh")
    h = cst(h, ("batch", "seq", "mlp"))
    return cst(torch.einsum("bsf,fd->bsd", h, p["w2"]) + p["b2"],
               ("batch", "seq", "embed"))


# ----------------------------------------------------------------------------
# MoE: specs + the reference dense path (the expert-parallel path is
# ``moe_ep``)
# ----------------------------------------------------------------------------


def moe_spec(cfg: ArchConfig) -> Params:
    d, f = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    p = {
        "router": ParamSpec((d, E), ("embed", None), f32, "scaled"),
        "w1": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"),
                        cfg.dtype, "scaled"),
        "w3": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"),
                        cfg.dtype, "scaled"),
        "w2": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed"),
                        cfg.dtype, "scaled"),
    }
    if cfg.n_shared_experts > 0:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w1": ParamSpec((d, fs), ("embed", "mlp"), cfg.dtype, "scaled"),
            "w3": ParamSpec((d, fs), ("embed", "mlp"), cfg.dtype, "scaled"),
            "w2": ParamSpec((fs, d), ("mlp", "embed"), cfg.dtype, "scaled"),
        }
    return p


def router_topk(logits: torch.Tensor, k: int, impl: str):
    """logits (T, E) -> (weights (T,k), ids (T,k)); weights sum to 1."""
    if impl == "sigmoid":                    # deepseek-v3 style scoring
        scores = torch.sigmoid(logits.to(f32))
    else:
        scores = torch.softmax(logits.to(f32), dim=-1)
    w, ids = torch.topk(scores, k, dim=-1)
    w = w / (torch.sum(w, -1, keepdim=True) + 1e-20)
    return w, ids


def moe_dense_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                    cst: Callable = _id_cst):
    """Reference dense MoE: every expert computed on every token, combined
    with the routing weights.  Exact (no capacity drops)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = torch.einsum("td,de->te", xt.to(f32), p["router"])
    w, ids = router_topk(logits, cfg.experts_per_tok, cfg.router_impl)
    comb = torch.zeros((T, cfg.n_experts), dtype=f32, device=x.device)
    comb.scatter_add_(1, ids, w)
    h = F.silu(torch.einsum("td,edf->tef", xt, p["w1"])) * \
        torch.einsum("td,edf->tef", xt, p["w3"])
    y = torch.einsum("tef,efd->ted", h, p["w2"])
    out = torch.einsum("ted,te->td", y.to(f32), comb)
    out = out.to(x.dtype).reshape(B, S, d)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x, cst=cst)
    return cst(out, ("batch", "seq", "embed"))
