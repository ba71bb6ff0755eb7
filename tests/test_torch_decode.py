"""The port's serving loop (``repro_torch.serve.decode``) and its example
against the JAX package.

Greedy ``generate`` over each architecture's ``-smoke`` config in
float32, with the reference's weights carried across, must give the
reference's ``generate`` tokens exactly, token for token (the argmax of
logits that agree to float32 rounding: see ``test_torch_archs.py``).
Temperature sampling draws from a ``torch.Generator``, so it is held to
its own contract (seeded draws repeat, tokens in range), not to
``jax.random``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs
from repro.models import Model as RefModel
from repro.serve import decode as rdecode
from repro_torch import configs, interop
from repro_torch.examples import serve_demo
from repro_torch.models import Model
from repro_torch.serve import decode

B, S0, NEW = 2, 5, 7


def _setup(arch):
    name = f"{arch}-smoke"
    cfg = configs.get(name).replace(dtype=torch.float32)
    rcfg = rconfigs.get(name).replace(dtype=jnp.float32)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = interop.model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), model, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S0),
                                               np.int32)
    enc = (0.02 * np.random.default_rng(4).standard_normal(
        (B, 8, cfg.d_model))).astype(np.float32)
    return cfg, rcfg, model, params, rparams, prompt, enc


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_greedy_generate_matches_reference(arch):
    cfg, rcfg, model, params, rparams, prompt, enc = _setup(arch)
    extra = {"enc_out": torch.from_numpy(enc)} if cfg.enc_dec else None
    rextra = {"enc_out": jnp.asarray(enc)} if cfg.enc_dec else None
    got = decode.generate(model, params, torch.from_numpy(prompt), NEW,
                          extra_batch=extra, device="cpu")
    want = rdecode.generate(RefModel(rcfg), rparams, jnp.asarray(prompt),
                            NEW, extra_batch=rextra)
    assert got.dtype == torch.int32 and got.shape == (B, S0 + NEW)
    assert np.array_equal(got.numpy(), np.asarray(want)), arch


def test_sampling_repeats_with_its_generator():
    cfg = configs.get("internlm2-1.8b-smoke")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.zeros((3, 4), dtype=torch.int32)

    def run(seed):
        return decode.generate(model, params, prompt, 6, temperature=0.8,
                               generator=torch.Generator().manual_seed(seed),
                               device="cpu")

    a, b = run(5), run(5)
    assert torch.equal(a, b) and torch.equal(a[:, :4], prompt)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    logits = torch.randn(3, 1, cfg.vocab_size)
    assert torch.equal(decode.sample_token(logits),
                       logits[:, -1].argmax(-1, keepdim=True).int())


def test_serve_step_updates_the_cache_in_place():
    cfg = configs.get("qwen2-72b-smoke")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 8, device="cpu")
    k_ptr = caches["k"].data_ptr()
    step = decode.make_serve_step(model)
    for pos in range(3):
        logits, out = step(params, {"tokens": torch.full((2, 1), 7), "pos":
                                    pos}, caches)
        assert out is caches and caches["k"].data_ptr() == k_ptr
    assert caches["pos"].tolist() == [3] * cfg.n_layers
    assert bool(caches["k"][:, :, :3].abs().sum(-1).gt(0).all())
    assert not bool(caches["k"][:, :, 3:].any())


def test_serve_demo_runs_on_the_cpu(capsys):
    rows = serve_demo.main(["--device", "cpu", "--batch", "2",
                            "--max-new", "4"])
    assert rows.shape == (2, 12)
    out = capsys.readouterr().out
    assert "arch=internlm2-1.8b-smoke" in out and "tok/s on cpu" in out
