"""The port's model layers (``repro_torch.models.layers``, ``.ssm``)
against the JAX package, function by function.

The same float32 inputs and weights (numpy, seeded) go through the
reference's function and the port's; outputs are held within ``TOL`` of
their scale: max |port - reference| <= TOL * max(1, max |reference|).
Attention is the reference's chunked online softmax, checked over
several chunks with a ragged last chunk (the reference pads it, the port
reads it short), ragged ``kv_len``, a sliding window, GQA and MLA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs
from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import spec
from repro_torch.models import ssm as S

#: float32 layers of a few products each (measured: at most ~1e-6)
TOL = 1e-5


def _close(got, want, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max diff {err:.3g}, scale {scale:.3g}"


def _weights(specs, seed, scale=0.3):
    """Random float32 numpy weights of a port spec tree (norm scales
    around 1, so they differ from their init)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        w = scale * rng.standard_normal(s.shape)
        return (1.0 + w if s.init == "ones" else w).astype(np.float32)

    return spec.tree_map(draw, specs)


def _t(tree):
    return spec.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return spec.tree_map(jnp.asarray, tree)


def _cfg(arch, **kw):
    name = f"{arch}-smoke"
    return (configs.get(name).replace(dtype=torch.float32, **kw),
            rconfigs.get(name).replace(dtype=jnp.float32, **kw))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


SDPA_CASES = {
    # name: (Sq, Sk, H, KVH, causal, window, q_offset, kv_len, chunk)
    "causal_chunks_ragged": (13, 13, 4, 4, True, 0, None, None, 4),
    "gqa_chunks": (16, 16, 4, 2, True, 0, None, None, 8),
    "noncausal_ragged": (5, 11, 4, 1, False, 0, None, None, 3),
    "decode_ragged_kv_len": (1, 20, 4, 2, True, 0, 9, 10, 4),
    "decode_prefix_kv_len": (3, 20, 4, 2, True, 0, 6, 9, 8),
    "sliding_window": (16, 16, 4, 2, True, 5, None, None, 4),
    "window_decode": (1, 24, 4, 4, True, 6, 17, 18, 5),
    "one_chunk_default": (7, 7, 2, 2, True, 0, None, None, 0),
}


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_matches_reference(case):
    Sq, Sk, H, KVH, causal, window, q_off, kv_len, chunk = SDPA_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, 2, Sq, H, 8), _randn(rng, 2, Sk, KVH, 8),
               _randn(rng, 2, Sk, KVH, 6))
    kw = dict(causal=causal, window=window, kv_chunk=chunk)
    got = L._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), **kw,
                  q_offset=None if q_off is None else torch.tensor(q_off),
                  kv_len=None if kv_len is None else torch.tensor(kv_len))
    want = RL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
                    q_offset=None if q_off is None else jnp.asarray(q_off),
                    kv_len=None if kv_len is None else jnp.asarray(kv_len))
    assert got.shape == (2, Sq, H, 6)
    _close(got, want, case)
    # an int offset and length give the same values as tensors
    if q_off is not None:
        again = L._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw, q_offset=q_off,
                        kv_len=kv_len)
        assert torch.equal(again, got)


def test_rope_and_mrope_match_reference():
    rng = np.random.default_rng(1)
    pos = np.arange(7)
    for got, want in zip(L.rope_freqs(16, 1e4, torch.from_numpy(pos)),
                         RL.rope_freqs(16, 1e4, jnp.asarray(pos))):
        _close(got, want, "rope_freqs")
    x = _randn(rng, 2, 7, 3, 16)
    cos, sin = L.rope_freqs(16, 1e6, torch.from_numpy(pos))
    rcos, rsin = RL.rope_freqs(16, 1e6, jnp.asarray(pos))
    _close(L.apply_rope(torch.from_numpy(x), cos, sin),
           RL.apply_rope(jnp.asarray(x), rcos, rsin), "apply_rope (S, D/2)")
    pos3 = rng.integers(0, 40, (2, 7, 3))
    mc, ms = L.mrope_cos_sin(16, 1e6, torch.from_numpy(pos3))
    rmc, rms = RL.mrope_cos_sin(16, 1e6, jnp.asarray(pos3))
    _close(mc, rmc, "mrope cos")
    _close(ms, rms, "mrope sin")
    _close(L.apply_rope(torch.from_numpy(x), mc, ms),
           RL.apply_rope(jnp.asarray(x), rmc, rms), "apply_rope (B, S, D/2)")


def test_norms_and_mlps_match_reference():
    cfg, rcfg = _cfg("whisper-tiny")
    rng = np.random.default_rng(2)
    x = 3.0 * _randn(rng, 2, 5, cfg.d_model)
    for sp, tf, rf in ((L.rmsnorm_spec, L.rmsnorm_apply, RL.rmsnorm_apply),
                       (L.layernorm_spec, L.layernorm_apply,
                        RL.layernorm_apply)):
        w = _weights(sp(cfg.d_model), 3)
        _close(tf(_t(w), torch.from_numpy(x), 1e-5),
               rf(_j(w), jnp.asarray(x), 1e-5), tf.__name__)
    for sp, tf, rf in ((L.gelu_mlp_spec, L.gelu_mlp_apply,
                        RL.gelu_mlp_apply),
                       (L.swiglu_spec, L.swiglu_apply, RL.swiglu_apply)):
        w = _weights(sp(cfg), 4)
        _close(tf(_t(w), torch.from_numpy(x)), rf(_j(w), jnp.asarray(x)),
               tf.__name__)


def test_dus_seq_writes_in_place():
    rng = np.random.default_rng(5)
    buf, upd = _randn(rng, 2, 9, 3), _randn(rng, 2, 2, 3)
    want = RL.dus_seq(jnp.asarray(buf), jnp.asarray(upd), jnp.asarray(4))
    for pos in (torch.tensor(4, dtype=torch.int32), 4):
        tb = torch.from_numpy(buf.copy())
        out = L.dus_seq(tb, torch.from_numpy(upd), pos)
        assert out is tb
        assert np.array_equal(tb.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen2-72b", "starcoder2-7b",
                                  "internlm2-1.8b"])
def test_attention_prefill_and_decode_match_reference(arch):
    """GQA attention (bias, sliding window) over a prompt, then decode
    steps into a cache written in place."""
    cfg, rcfg = _cfg(arch, sliding_window=3) if arch == "starcoder2-7b" \
        else _cfg(arch)
    rng = np.random.default_rng(6)
    w = _weights(L.attention_spec(cfg), 7)
    x = _randn(rng, 2, 6, cfg.d_model)
    pos = np.arange(6)
    cos, sin = L.rope_freqs(cfg.hd, cfg.rope_theta, torch.from_numpy(pos))
    rcos, rsin = RL.rope_freqs(rcfg.hd, rcfg.rope_theta, jnp.asarray(pos))
    y, _ = L.attention_apply(_t(w), cfg, torch.from_numpy(x), cos, sin)
    ry, _ = RL.attention_apply(_j(w), rcfg, jnp.asarray(x), rcos, rsin)
    _close(y, ry, f"{arch} prefill")
    cache = {"k": torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd),
             "v": torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd),
             "pos": torch.tensor(0, dtype=torch.int32)}
    rcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    for i in range(6):
        xs = x[:, i:i + 1]
        c, s = cos[i:i + 1], sin[i:i + 1]
        y, cache = L.attention_apply(_t(w), cfg, torch.from_numpy(xs), c, s,
                                     cache=cache)
        ry, rcache = RL.attention_apply(_j(w), rcfg, jnp.asarray(xs),
                                        rcos[i:i + 1], rsin[i:i + 1],
                                        cache=rcache)
        _close(y, ry, f"{arch} decode {i}")
        for key in ("k", "v", "pos"):
            _close(cache[key], rcache[key], f"{arch} cache {key} {i}")


def test_mla_with_latent_cache_matches_reference():
    cfg, rcfg = _cfg("deepseek-v3-671b")
    rng = np.random.default_rng(8)
    w = _weights(L.mla_spec(cfg), 9)
    x = _randn(rng, 2, 5, cfg.d_model)
    y, _ = L.mla_apply(_t(w), cfg, torch.from_numpy(x), torch.arange(5))
    ry, _ = RL.mla_apply(_j(w), rcfg, jnp.asarray(x), jnp.arange(5))
    _close(y, ry, "mla forward")
    cache = {"c_kv": torch.zeros(2, 7, cfg.kv_lora_rank),
             "k_rope": torch.zeros(2, 7, cfg.qk_rope_dim),
             "pos": torch.tensor(0, dtype=torch.int32)}
    rcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    for i in range(5):
        xs = x[:, i:i + 1]
        y, cache = L.mla_apply(_t(w), cfg, torch.from_numpy(xs),
                               torch.arange(1) + i, cache=cache)
        ry, rcache = RL.mla_apply(_j(w), rcfg, jnp.asarray(xs),
                                  jnp.arange(1) + i, cache=rcache)
        _close(y, ry, f"mla decode {i}")
        for key in ("c_kv", "k_rope", "pos"):
            _close(cache[key], rcache[key], f"mla cache {key} {i}")
    # the decode steps give the forward pass's outputs (2e-3, the
    # reference's decode-against-forward tolerance)
    np.testing.assert_allclose(y.detach().numpy()[:, 0],
                               np.asarray(RL.mla_apply(
                                   _j(w), rcfg, jnp.asarray(x),
                                   jnp.arange(5))[0])[:, -1],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_router_and_moe_dense_match_reference(arch):
    """Softmax routing (dbrx) and sigmoid routing with a shared expert
    (deepseek-v3)."""
    cfg, rcfg = _cfg(arch)
    rng = np.random.default_rng(10)
    logits = _randn(rng, 12, cfg.n_experts)
    w, ids = L.router_topk(torch.from_numpy(logits), cfg.experts_per_tok,
                           cfg.router_impl)
    rw, rids = RL.router_topk(jnp.asarray(logits), cfg.experts_per_tok,
                              rcfg.router_impl)
    assert np.array_equal(ids.numpy(), np.asarray(rids))
    _close(w, rw, "router weights")
    p = _weights(L.moe_spec(cfg), 11)
    x = _randn(rng, 2, 6, cfg.d_model)
    _close(L.moe_dense_apply(_t(p), cfg, torch.from_numpy(x)),
           RL.moe_dense_apply(_j(p), rcfg, jnp.asarray(x)), f"{arch} moe")


def test_mamba2_chunked_equals_stepwise_and_reference():
    cfg, rcfg = _cfg("zamba2-7b")
    rng = np.random.default_rng(12)
    p = _weights(S.mamba2_spec(cfg), 13)
    p["A_log"] = (0.5 * rng.standard_normal(p["A_log"].shape)).astype(
        np.float32)
    x = _randn(rng, 2, 16, cfg.d_model)
    chunked, _ = S.mamba2_apply(_t(p), cfg, torch.from_numpy(x), chunk=4)
    stepwise, _ = S.mamba2_apply(_t(p), cfg, torch.from_numpy(x), chunk=0)
    _close(chunked, stepwise, "chunked SSD against the stepwise scan")
    for chunk in (4, 0):
        ry, _ = RS.mamba2_apply(_j(p), rcfg, jnp.asarray(x), chunk=chunk)
        _close(chunked if chunk else stepwise, ry, f"mamba2 chunk={chunk}")
    # the default chunk (MAMBA2_CHUNK = 128) leaves S = 16 stepwise
    assert torch.equal(S.mamba2_apply(_t(p), cfg, torch.from_numpy(x))[0],
                       stepwise)
    # the scans alone, with a nonzero initial state
    B_, Sq, nh, hd, ds = 2, 12, 3, 4, 5
    xs, Bm, Cm = (_randn(rng, B_, Sq, nh, hd), _randn(rng, B_, Sq, ds),
                  _randn(rng, B_, Sq, ds))
    dt = np.abs(_randn(rng, B_, Sq, nh))
    ld = -dt * np.abs(_randn(rng, nh))
    h0 = _randn(rng, B_, nh, hd, ds)
    args = [torch.from_numpy(a) for a in (xs, Bm, Cm, ld, dt, h0)]
    y_c, h_c = S._ssm_scan_chunked(*args, chunk=3)
    y_s, h_s = S._ssm_scan_stepwise(args[0], args[1], args[2],
                                    torch.exp(args[3]), args[4], args[5])
    ry, rh = RS._ssm_scan_chunked(*(jnp.asarray(a) for a in
                                    (xs, Bm, Cm, ld, dt, h0)), chunk=3)
    for got in (y_c, y_s):
        _close(got, ry, "ssd y")
    for got in (h_c, h_s):
        _close(got, rh, "ssd state")


def test_mamba2_decode_steps_match_reference():
    cfg, rcfg = _cfg("zamba2-7b")
    rng = np.random.default_rng(14)
    p = _weights(S.mamba2_spec(cfg), 15)
    x = _randn(rng, 2, 4, cfg.d_model)
    cache = spec.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                          S.mamba2_cache_spec(cfg, 2))
    rcache = RS.mamba2_cache_spec(rcfg, 2)
    rcache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    rcache)
    for i in range(4):
        y, cache = S.mamba2_apply(_t(p), cfg, torch.from_numpy(x[:, i:i + 1]),
                                  cache=cache)
        ry, rcache = RS.mamba2_apply(_j(p), rcfg, jnp.asarray(x[:, i:i + 1]),
                                     cache=rcache)
        _close(y, ry, f"mamba2 decode {i}")
        for key in ("conv", "ssm"):
            _close(cache[key], rcache[key], f"mamba2 cache {key} {i}")


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_cells_match_reference(cell):
    cfg, rcfg = _cfg("xlstm-125m")
    spec_fn, apply, rapply, cache_spec, rcache_spec = {
        "mlstm": (S.mlstm_spec, S.mlstm_apply, RS.mlstm_apply,
                  S.mlstm_cache_spec, RS.mlstm_cache_spec),
        "slstm": (S.slstm_spec, S.slstm_apply, RS.slstm_apply,
                  S.slstm_cache_spec, RS.slstm_cache_spec)}[cell]
    rng = np.random.default_rng(16)
    p = _weights(spec_fn(cfg), 17)
    x = _randn(rng, 2, 9, cfg.d_model)
    y, _ = apply(_t(p), cfg, torch.from_numpy(x))
    ry, _ = rapply(_j(p), rcfg, jnp.asarray(x))
    _close(y, ry, f"{cell} sequence")
    # from a nonzero state, step by step
    cache = spec.tree_map(lambda t: torch.from_numpy(
        np.abs(_randn(rng, *t.shape)) + 0.5), cache_spec(cfg, 2))
    rcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    assert {k: v.shape for k, v in rcache.items()} == \
        {k: s.shape for k, s in rcache_spec(rcfg, 2).items()}
    for i in range(3):
        y, cache = apply(_t(p), cfg, torch.from_numpy(x[:, i:i + 1]),
                         cache=cache)
        ry, rcache = rapply(_j(p), rcfg, jnp.asarray(x[:, i:i + 1]),
                            cache=rcache)
        _close(y, ry, f"{cell} step {i}")
        for key in cache:
            _close(cache[key], rcache[key], f"{cell} cache {key} {i}")
