"""Recurrent sequence-mixing blocks: Mamba2 (zamba2) and xLSTM
(sLSTM / mLSTM).

The port's ``repro.models.ssm``.  Each block has a sequence form (a
Python loop over time, the reference's ``lax.scan``; Mamba2 also the
chunked SSD) and a one-step form for decode that shares its cell.  The
cache specs are ``meta`` tensors.  The chunk length is the ``chunk=``
argument, default :data:`MAMBA2_CHUNK`; the reference's
``REPRO_SSM_CHUNK`` environment override (an A/B knob) is not kept.

Under a mesh each block computes on its batch rows.  Under the fsdp
profile, whose sequence is split over ``model``, a block gathers its
input's sequence blocks (``layers.seq_gather``: the gradient
reduce-scattered back), runs the unchanged recurrence over the whole
sequence and keeps this rank's block: the op order of one device, and
what GSPMD makes of the reference's ``lax.scan`` over a split axis.  A
decode cache split over ``model`` (the cache rules' ``heads``, ``mlp``
or ``head_dim``) is gathered at use and this rank's block written back
(``layers.state_whole`` / ``state_own``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import layers
from .config import ArchConfig
from .spec import ParamSpec

Params = Dict[str, Any]
f32 = torch.float32


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------------------------------------------------------------
# Mamba2
# ----------------------------------------------------------------------------


def mamba2_dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_state, cfg.ssm_head_dim


def mamba2_spec(cfg: ArchConfig) -> Params:
    d = cfg.d_model
    d_in, nh, ds, hd = mamba2_dims(cfg)
    conv_dim = d_in + 2 * ds
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * ds + nh),
                             ("embed", "mlp"), cfg.dtype, "scaled"),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "mlp"),
                            cfg.dtype, "scaled"),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), cfg.dtype, "zeros"),
        "A_log": ParamSpec((nh,), ("heads",), f32, "zeros"),
        "D": ParamSpec((nh,), ("heads",), f32, "ones"),
        "dt_bias": ParamSpec((nh,), ("heads",), f32, "zeros"),
        "norm": layers.rmsnorm_spec(d_in),
        "out_proj": ParamSpec((d_in, d), ("mlp", "embed"), cfg.dtype,
                              "scaled"),
    }


def _mamba2_inner(p, cfg, xz, conv_state):
    """Split in_proj's output and run the causal conv.

    xz: (B, S, 2*d_in + 2*ds + nh).  conv_state: (B, K-1, conv_dim) or
    None.  Returns (z, xBC_conved, dt, new_conv_state).
    """
    d_in, nh, ds, hd = mamba2_dims(cfg)
    z = xz[..., :d_in]
    xBC = xz[..., d_in:d_in + d_in + 2 * ds]
    dt = xz[..., -nh:]
    K = cfg.ssm_conv
    if conv_state is None:
        pad = torch.zeros_like(xBC[:, : K - 1])
        seq = torch.cat([pad, xBC], dim=1)
    else:
        seq = torch.cat([conv_state, xBC], dim=1)
    new_state = seq[:, -(K - 1):]
    # causal depthwise conv, kernel K
    out = torch.zeros_like(xBC)
    S = xBC.shape[1]
    for k in range(K):
        out = out + seq[:, k:k + S] * p["conv_w"][k][None, None]
    xBC = F.silu(out + p["conv_b"][None, None])
    return z, xBC, dt, new_state


MAMBA2_CHUNK = 128  # SSD chunk length


def _ssm_scan_stepwise(xs, Bmat, Cmat, decay, dt, h0):
    """Per-timestep recurrence.  xs:(B,S,nh,hd) f32, Bmat/Cmat:(B,S,ds),
    decay/dt:(B,S,nh), h0:(B,nh,hd,ds)."""
    h = h0
    ys = []
    for t in range(xs.shape[1]):
        upd = torch.einsum("bnh,bs->bnhs", xs[:, t] * dt[:, t, :, None],
                           Bmat[:, t].to(f32))
        h = h * decay[:, t, :, None, None] + upd
        ys.append(torch.einsum("bnhs,bs->bnh", h, Cmat[:, t].to(f32)))
    return torch.stack(ys, dim=1), h


def _ssm_scan_chunked(xs, Bmat, Cmat, logdecay, dt, h0, chunk: int):
    """Chunked SSD (Mamba-2's blocked algorithm): equal in exact
    arithmetic to the per-step recurrence, with S/chunk state updates
    and (C x C) products within a chunk.

    xs: (B,S,nh,hd) f32; Bmat/Cmat: (B,S,ds); logdecay/dt: (B,S,nh);
    h0: (B,nh,hd,ds).  Requires S % chunk == 0.
    """
    B, S, nh, hd = xs.shape
    ds = Bmat.shape[-1]
    nc = S // chunk
    u = xs * dt[..., None]                       # effective input
    uc = u.reshape(B, nc, chunk, nh, hd)
    Bc = Bmat.reshape(B, nc, chunk, ds).to(f32)
    Cc = Cmat.reshape(B, nc, chunk, ds).to(f32)
    ld = logdecay.reshape(B, nc, chunk, nh)
    s = torch.cumsum(ld, dim=2)                  # inclusive log-decay
    # intra-chunk: M[i,j] = (C_i . B_j) * exp(s_i - s_j) for j <= i
    G = torch.einsum("bncs,bnks->bnck", Cc, Bc)  # (B,nc,C,C)
    delta = s[:, :, :, None, :] - s[:, :, None, :, :]   # (B,nc,C,C,nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xs.device))
    Dm = torch.where(causal[None, None, :, :, None], torch.exp(delta), 0.0)
    M = G[..., None] * Dm                        # (B,nc,C,C,nh)
    y_intra = torch.einsum("bnckh,bnkhd->bnchd", M, uc)
    # inter-chunk: a loop over chunks carrying h (B,nh,hd,ds)
    w_in = torch.exp(s)                          # state->output decay
    w_out = torch.exp(s[:, :, -1:, :] - s)       # input->chunk-end decay
    a_chunk = torch.exp(s[:, :, -1, :])          # total chunk decay
    hupd = torch.einsum("bnchd,bnch,bncs->bnhds", uc, w_out, Bc)
    h = h0
    ys = []
    for c in range(nc):
        y_inter = torch.einsum("bcs,bhds,bch->bchd", Cc[:, c], h, w_in[:, c])
        ys.append(y_intra[:, c] + y_inter)
        h = h * a_chunk[:, c, :, None, None] + hupd[:, c]
    y = torch.stack(ys, dim=1).reshape(B, S, nh, hd)
    return y, h


def mamba2_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                 cst: Callable = layers._id_cst,
                 cache: Optional[Dict] = None, chunk: Optional[int] = None):
    """x: (B, S, d).  cache = {'conv': (B,K-1,conv_dim),
    'ssm': (B,nh,hd,ds)} for decode; None for a forward pass (zero
    state).  A forward pass takes the chunked SSD when S % chunk == 0
    and S > chunk, else the stepwise recurrence; decode is one step."""
    if chunk is None:
        chunk = MAMBA2_CHUNK
    S_own = x.shape[1]
    x, off = layers.seq_gather(x, cst)
    B, S, d = x.shape
    d_in, nh, ds, hd = mamba2_dims(cfg)
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    conv_state = layers.state_whole(cache["conv"], cst) \
        if cache is not None else None
    z, xBC, dt, new_conv = _mamba2_inner(p, cfg, xz, conv_state)
    xs = xBC[..., :d_in].reshape(B, S, nh, hd)
    Bmat = xBC[..., d_in:d_in + ds]                      # (B,S,ds)
    Cmat = xBC[..., d_in + ds:]
    dt = F.softplus(dt.to(f32) + p["dt_bias"][None, None])   # (B,S,nh)
    A = -torch.exp(p["A_log"].to(f32))                   # (nh,)
    logdecay = dt * A[None, None]                        # (B,S,nh), <= 0
    xs = cst(xs, ("batch", "seq", "heads", "head_dim"))
    xs32 = xs.to(f32)

    h0 = (layers.state_whole(cache["ssm"], cst) if cache is not None else
          torch.zeros((B, nh, hd, ds), dtype=f32, device=x.device))

    if cache is None and chunk > 0 and S % chunk == 0 and S > chunk:
        y, hT = _ssm_scan_chunked(xs32, Bmat, Cmat, logdecay, dt, h0, chunk)
    else:
        y, hT = _ssm_scan_stepwise(xs32, Bmat, Cmat, torch.exp(logdecay),
                                   dt, h0)
    y = y + xs32 * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = layers.rmsnorm_apply(p["norm"], (y * F.silu(z.to(f32))).to(x.dtype),
                             cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"]).narrow(1, off, S_own)
    new_cache = None
    if cache is not None:
        new_cache = _own(cache, {"conv": new_conv, "ssm": hT}, cst)
    return cst(out, ("batch", "seq", "embed")), new_cache


def _whole(cache, cst):
    """Every leaf of one layer's recurrent state whole (gathered)."""
    return {k: layers.state_whole(t, cst) for k, t in cache.items()}


def _own(cache, new, cst):
    """This rank's block of each whole new state leaf, in ``cache``'s
    layout."""
    return {k: layers.state_own(t, cache[k], cst) for k, t in new.items()}


def mamba2_cache_spec(cfg: ArchConfig, batch: int):
    d_in, nh, ds, hd = mamba2_dims(cfg)
    conv_dim = d_in + 2 * ds
    return {"conv": _meta((batch, cfg.ssm_conv - 1, conv_dim), cfg.dtype),
            "ssm": _meta((batch, nh, hd, ds), f32)}


# ----------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory w/ recurrence)
# ----------------------------------------------------------------------------


def mlstm_spec(cfg: ArchConfig) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    d_up = 2 * d      # pf=2 up-projection (xLSTM paper)
    return {
        "up": ParamSpec((d, 2 * d_up), ("embed", "mlp"), cfg.dtype, "scaled"),
        "wq": ParamSpec((d_up, d_up), ("mlp", "heads_x"), cfg.dtype, "scaled"),
        "wk": ParamSpec((d_up, d_up), ("mlp", "heads_x"), cfg.dtype, "scaled"),
        "wv": ParamSpec((d_up, d_up), ("mlp", "heads_x"), cfg.dtype, "scaled"),
        "wi": ParamSpec((d_up, H), ("mlp", "heads"), f32, "scaled"),
        "wf": ParamSpec((d_up, H), ("mlp", "heads"), f32, "scaled"),
        "bi": ParamSpec((H,), ("heads",), f32, "zeros"),
        "bf": ParamSpec((H,), ("heads",), f32, "ones"),
        "norm": layers.rmsnorm_spec(d_up),
        "down": ParamSpec((d_up, d), ("mlp", "embed"), cfg.dtype, "scaled"),
    }


def mlstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                cst: Callable = layers._id_cst,
                cache: Optional[Dict] = None):
    """Matrix-memory LSTM with exponential gating + stabilizer state."""
    S_own = x.shape[1]
    x, off = layers.seq_gather(x, cst)
    B, S, d = x.shape
    H = cfg.n_heads
    up = torch.einsum("bsd,de->bse", x, p["up"])
    d_up = up.shape[-1] // 2
    u, gate_skip = up[..., :d_up], up[..., d_up:]
    dh = d_up // H
    q = torch.einsum("bse,ef->bsf", u, p["wq"]).reshape(B, S, H, dh)
    k = torch.einsum("bse,ef->bsf", u, p["wk"]).reshape(B, S, H, dh) / \
        math.sqrt(dh)
    v = torch.einsum("bse,ef->bsf", u, p["wv"]).reshape(B, S, H, dh)
    ig = (torch.einsum("bse,eh->bsh", u.to(f32), p["wi"])
          + p["bi"])                                     # log input gate
    fg = (torch.einsum("bse,eh->bsh", u.to(f32), p["wf"])
          + p["bf"])
    logf = -F.softplus(-fg)                              # log sigmoid(f)

    if cache is not None:
        whole = _whole(cache, cst)
        C, n, m = whole["C"], whole["n"], whole["m"]
    else:
        C = torch.zeros((B, H, dh, dh), dtype=f32, device=x.device)
        n = torch.zeros((B, H, dh), dtype=f32, device=x.device)
        # large-negative finite (not -inf): e^-30 makes the first forget
        # term 0
        m = torch.full((B, H), -30.0, dtype=f32, device=x.device)

    hs = []
    for t in range(S):
        qt, kt, vt = q[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
        it, lft = ig[:, t], logf[:, t]                   # (B,H)
        m_new = torch.maximum(lft + m, it)
        fscale = torch.exp(lft + m - m_new)
        iscale = torch.exp(it - m_new)
        C = C * fscale[..., None, None] + iscale[..., None, None] * \
            torch.einsum("bhv,bhk->bhvk", vt, kt)
        n = n * fscale[..., None] + iscale[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, d_up).to(x.dtype)
    h = layers.rmsnorm_apply(p["norm"], h, cfg.norm_eps)
    h = h * F.silu(gate_skip)
    out = torch.einsum("bse,ed->bsd", h, p["down"]).narrow(1, off, S_own)
    new_cache = _own(cache, {"C": C, "n": n, "m": m}, cst) \
        if cache is not None else None
    return cst(out, ("batch", "seq", "embed")), new_cache


def mlstm_cache_spec(cfg: ArchConfig, batch: int):
    H = cfg.n_heads
    dh = (2 * cfg.d_model) // H
    return {"C": _meta((batch, H, dh, dh), f32),
            "n": _meta((batch, H, dh), f32),
            "m": _meta((batch, H), f32)}


def slstm_spec(cfg: ArchConfig) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "W": ParamSpec((d, 4 * d), ("embed", "mlp"), cfg.dtype, "scaled"),
        "R": ParamSpec((H, dh, 4 * dh), ("heads", "head_dim", None),
                       cfg.dtype, "scaled"),
        "b": ParamSpec((4 * d,), ("mlp",), f32, "zeros"),
        "norm": layers.rmsnorm_spec(d),
        "out": ParamSpec((d, d), ("embed", "embed_out"), cfg.dtype, "scaled"),
    }


def slstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                cst: Callable = layers._id_cst,
                cache: Optional[Dict] = None):
    """Scalar-memory LSTM with exponential gating, normalizer state and
    block-diagonal (per-head) recurrence: the truly sequential xLSTM
    cell."""
    S_own = x.shape[1]
    x, off = layers.seq_gather(x, cst)
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    wx = torch.einsum("bsd,de->bse", x, p["W"]).to(f32) + p["b"]

    if cache is not None:
        whole = _whole(cache, cst)
        c, n, h, m = whole["c"], whole["n"], whole["h"], whole["m"]
    else:
        c = torch.zeros((B, d), dtype=f32, device=x.device)
        n = torch.ones((B, d), dtype=f32, device=x.device)
        h = torch.zeros((B, d), dtype=f32, device=x.device)
        m = torch.zeros((B, d), dtype=f32, device=x.device)

    R = p["R"].to(f32)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,hke->bhe", h.reshape(B, H, dh),
                           R).reshape(B, 4 * d)
        # gate layout: [i, f, z, o] each (d,)
        gi, gf, gz, go = torch.split(wx[:, t] + rec, d, dim=-1)
        m_new = torch.maximum(gf + m, gi)                 # stabilizer
        i = torch.exp(gi - m_new)
        f = torch.exp(gf + m - m_new)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(x.dtype)             # (B,S,d)
    hseq = layers.rmsnorm_apply(p["norm"], hseq, cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", hseq, p["out"]).narrow(1, off, S_own)
    new_cache = (_own(cache, {"c": c, "n": n, "h": h, "m": m}, cst)
                 if cache is not None else None)
    return cst(out, ("batch", "seq", "embed")), new_cache


def slstm_cache_spec(cfg: ArchConfig, batch: int):
    d = cfg.d_model
    return {k: _meta((batch, d), f32) for k in ("c", "n", "h", "m")}
