"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package, arch by arch.

Every architecture's ``-smoke`` config in float32: the reference's
weights (``Model(cfg).init(PRNGKey(0))``) cross into the port as numpy
leaves (``interop.model_params_from_reference``), the same tokens (numpy
seed) go through both, and the forward logits, the loss, and four decode
steps' logits and caches are held to the reference within ``TOL``
of each tensor's scale: max |port - reference| <= TOL * max(1,
max |reference|) (float32 rounding through two layers of random weights
whose fan-in-scaled init grows the residual stream and the recurrent
states to hundreds; the reference runs under the suite's x64 flag, its
models in float32 as configured).  The reference has no forward entry returning logits, so
its logits are assembled from its own layer functions, as its
``tests/test_archs.py`` assembles them.  The full configs' dimensions and
parameter counts, the MLA cache's storage and the long-context skip rule
are held to the reference exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs
from repro.models import Model as RefModel
from repro.models import ParallelCtx as RefPctx
from repro.models import layers as RL
from repro.models import spec as rspec
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.models.config import SHAPES as RSHAPES
from repro_torch import configs, interop
from repro_torch.models import SHAPES, Model, spec

#: forward logits, loss, decode logits and caches, relative to each
#: tensor's largest magnitude: float32 models of two layers (measured:
#: at most 3.1e-5)
TOL = 1e-4
B, S = 2, 16
MAX_LEN = 24
DECODE_STEPS = 4


def _cfgs(arch):
    name = f"{arch}-smoke"
    return (configs.get(name).replace(dtype=torch.float32),
            rconfigs.get(name).replace(dtype=jnp.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max diff {err:.3g}, scale {scale:.3g}"


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = (0.02 * rng.standard_normal(
            (B, 4, cfg.d_model))).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, 8, cfg.d_model))).astype(np.float32)
    return batch


def _both(batch):
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


def _pair(arch):
    cfg, rcfg = _cfgs(arch)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = interop.model_params_from_reference(_np(rparams), model,
                                                 device="cpu")
    return cfg, rcfg, model, params, rparams


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _ref_forward(rcfg, params, batch):
    """The reference's forward logits, from its own layer functions."""
    pctx = RefPctx()
    tokens = batch["tokens"]
    if rcfg.family == "ssm":
        x = params["embed"][tokens]
        for i in range(rcfg.n_layers // 2):
            x, _ = RT._xlstm_pair_apply(_layer(params["pairs"], i), rcfg, x,
                                        pctx)
        x = RL.rmsnorm_apply(params["ln_f"], x, rcfg.norm_eps)
        return jnp.einsum("bsd,dv->bsv", x, params["lm_head"])
    if rcfg.family == "hybrid":
        x = x0 = params["embed"][tokens]
        rope = RL.rope_freqs(rcfg.hd, rcfg.rope_theta,
                             jnp.arange(tokens.shape[1]))
        for i in range(rcfg.n_layers):
            if i % rcfg.attn_every == 0:
                x, _ = RT._zamba_shared_attn(params["shared_attn"], rcfg, x,
                                             x0, rope, pctx)
            lp = _layer(params["mamba_layers"], i)
            a, _ = RS.mamba2_apply(lp["mamba"], rcfg,
                                   RL.rmsnorm_apply(lp["ln"], x,
                                                    rcfg.norm_eps))
            x = x + a
        x = RL.rmsnorm_apply(params["ln_f"], x, rcfg.norm_eps)
        return jnp.einsum("bsd,dv->bsv", x, params["lm_head"])
    if rcfg.enc_dec:
        enc = RT._whisper_encode(rcfg, params, batch["frames"], pctx)
        x = params["embed"][tokens] + params["dec_pos"][:tokens.shape[1]][None]
        for i in range(rcfg.n_layers):
            x, _ = RT._whisper_dec_layer(_layer(params["dec_layers"], i),
                                         rcfg, x, enc, pctx)
        x = RL.layernorm_apply(params["ln_f"], x, rcfg.norm_eps)
        return jnp.einsum("bsd,vd->bsv", x, params["embed"])
    x, vis = RT._embed_inputs(rcfg, params, batch, pctx)
    positions = RT._positions_for(rcfg, x.shape[0], x.shape[1], vis)
    x, _ = RT._scan_layers(rcfg, params["layers"], x,
                           RT._rope_for(rcfg, positions), positions, pctx)
    x = RL.rmsnorm_apply(params["ln_f"], x, rcfg.norm_eps)
    return RT._lm_head(rcfg, params, x, pctx)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_and_loss_match_reference(arch):
    cfg, rcfg, model, params, rparams = _pair(arch)
    tb, jb = _both(_batch(cfg))
    with torch.no_grad():
        logits = model.forward(params, tb)
        loss = model.loss(params, tb)
    want = _ref_forward(rcfg, rparams, jb)
    assert logits.shape == want.shape
    _close(logits, want, f"{arch} forward logits")
    _close(loss, RefModel(rcfg).loss(rparams, jb), f"{arch} loss")


def _decode_batch(cfg, tokens, pos, enc_out):
    batch = {"tokens": tokens, "pos": pos}
    if cfg.enc_dec:
        batch["enc_out"] = enc_out
    return batch


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decode_steps_match_reference(arch):
    """Four decode steps from zero caches: logits and every cache leaf
    after each step, the port's caches updated in place."""
    cfg, rcfg, model, params, rparams = _pair(arch)
    rmodel = RefModel(rcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS), np.int32)
    enc = (0.02 * rng.standard_normal((B, 8, cfg.d_model))).astype(
        np.float32)
    rcaches = rmodel.init_cache(B, MAX_LEN)
    caches = interop.cache_from_reference(_np(rcaches), device="cpu")
    assert jax.tree_util.tree_structure(
        interop.cache_to_numpy(caches)) == jax.tree_util.tree_structure(
        _np(rcaches))
    for i in range(DECODE_STEPS):
        before = spec.tree_map(torch.clone, caches)
        with torch.no_grad():
            logits, out = model.decode_step(params, _decode_batch(
                cfg, torch.from_numpy(toks[:, i:i + 1]), i,
                torch.from_numpy(enc)), caches)
        assert out is caches                # updated in place
        rlogits, rcaches = rmodel.decode_step(rparams, _decode_batch(
            cfg, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(i, jnp.int32),
            jnp.asarray(enc)), rcaches)
        assert logits.shape == (B, 1, cfg.vocab_size)
        _close(logits, rlogits, f"{arch} step {i} logits")
        got, want = interop.cache_to_numpy(caches), _np(rcaches)
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves(want)):
            assert g.dtype == w.dtype, path
            _close(g, w, f"{arch} step {i} cache {path}")
        changed = [not torch.equal(a, b) for a, b in zip(
            spec.tree_leaves(before), spec.tree_leaves(caches))]
        assert any(changed), arch


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "starcoder2-7b",
                                  "qwen2-72b"])
def test_decode_matches_full_forward(arch):
    """Decode token by token gives the forward pass's logits at each
    position (the reference's ``tests/test_archs.py`` check and its
    tolerance, 2e-3)."""
    cfg = configs.get(f"{arch}-smoke").replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 6), np.int32))
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks})
        caches = model.init_cache(1, 8, device="cpu")
        outs = [model.decode_step(params, {"tokens": toks[:, i:i + 1],
                                           "pos": i}, caches)[0][:, 0]
                for i in range(6)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def _fields(cfg, dtype_name):
    d = dataclasses.asdict(cfg)
    d["dtype"] = dtype_name
    return d


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_full_config_and_param_count_match_reference(arch):
    for name in (arch, f"{arch}-smoke"):
        cfg, rcfg = configs.get(name), rconfigs.get(name)
        assert _fields(cfg, str(cfg.dtype).split(".")[-1]) == \
            _fields(rcfg, jnp.dtype(rcfg.dtype).name)
        assert interop.arch_config_from_reference(
            _fields(rcfg, jnp.dtype(rcfg.dtype).name)) == cfg
        assert spec.param_count(Model(cfg).specs()) == \
            rspec.param_count(RefModel(rcfg).specs())
        # abstract params: the reference's shapes and dtypes, no storage
        got = Model(cfg).abstract_params()
        want = RefModel(rcfg).abstract_params()
        for g, w in zip(spec.tree_leaves(got), jax.tree_util.tree_leaves(
                want)):
            assert g.device.type == "meta" and tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_and_cache_specs_match_reference(shape):
    assert dataclasses.asdict(SHAPES[shape]) == \
        dataclasses.asdict(RSHAPES[shape])
    for arch in configs.ARCH_IDS:
        cfg, rcfg = configs.get(arch), rconfigs.get(arch)
        got = Model(cfg).input_specs(SHAPES[shape])
        want = RefModel(rcfg).input_specs(RSHAPES[shape])
        assert sorted(got) == sorted(want), arch
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, (arch, k)
        cs, rcs = Model(cfg).cache_specs(2, 64), RefModel(rcfg).cache_specs(
            2, 64)
        assert [tuple(t.shape) for t in spec.tree_leaves(cs)] == \
            [s.shape for s in jax.tree_util.tree_leaves(rcs)], arch


def test_mla_latent_cache_is_low_storage():
    cfg = configs.get("deepseek-v3-671b")
    cs = Model(cfg).cache_specs(1, 1024)
    latent_bytes = sum(t.numel() * t.element_size()
                       for t in spec.tree_leaves(cs) if t.ndim > 1)
    dense = 2 * cfg.n_layers * 1024 * cfg.n_heads * cfg.hd * 2
    assert latent_bytes < dense / 20, (latent_bytes, dense)
    # the latent cache's storage is the reference's, byte for byte
    rcs = RefModel(rconfigs.get("deepseek-v3-671b")).cache_specs(1, 1024)
    assert latent_bytes == sum(int(np.prod(s.shape)) * s.dtype.itemsize
                               for s in jax.tree_util.tree_leaves(rcs)
                               if len(s.shape) > 1)


def test_long_context_skip_rule_matches_reference():
    assert configs.names() == [n for n in rconfigs.names()
                               if n in configs.names()]
    for a in configs.ARCH_IDS:
        for s in SHAPES:
            assert configs.cell_is_runnable(a, s) == \
                rconfigs.cell_is_runnable(a, s), (a, s)
    assert configs.cell_is_runnable("zamba2-7b", "long_500k")
    assert not configs.cell_is_runnable("qwen2-72b", "long_500k")
