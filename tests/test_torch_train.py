"""The port's training half (``repro_torch.{data,optim,train}``,
``launch.train``, ``examples.quickstart``) against the JAX package.

The models run their ``-smoke`` configs in float32 with the reference's
weights carried across (``interop``).  Tolerances:

* ``schedule`` and ``update`` on random numpy trees: within ``UPD_RTOL``
  of the reference's, relative to each leaf's scale (bf16 and float32
  params, float32 and bf16 moments);
* a train step (``STEP_TOL``): the loss within 1e-5 relative, the global
  gradient norm within 1e-4 relative, each moment within 1e-4 of its
  leaf's scale, the params within 2*lr + 1e-6 (Adam's first steps move a
  parameter by about +-lr wherever |g| >> eps, so a gradient near 0
  whose float32 rounding differs may flip its sign).  Each of the three
  steps starts from the reference's state before it, carried in by
  ``interop``: the two packages' float32 gradients differ by ~3e-5 of
  scale on this model, and a flipped sign in one step would move the
  next step's inputs apart by 2*lr;
* ``remat`` on against off, resume against an uninterrupted run, and the
  launcher's resume: bit for bit;
* bf16 only as the reference's own test holds it (the loss falls).
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs
from repro.data import pipeline as rpipeline
from repro.models import Model as RefModel
from repro.optim import adamw as radamw
from repro.optim import gradflow as rgradflow
from repro.train import checkpoint as rckpt
from repro.train import fault as rfault
from repro.train import step as rstep
from repro_torch import interop
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.examples import quickstart
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, spec
from repro_torch.optim import adamw, gradflow
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import step as tstep

ARCH = "internlm2-1.8b-smoke"
UPD_RTOL = 1e-6
LOSS_RTOL, NORM_RTOL, MOMENT_TOL = 1e-5, 1e-4, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(dtype=torch.float32, **kw):
    cfg = configs.get(ARCH).replace(dtype=dtype, **kw)
    rcfg = rconfigs.get(ARCH).replace(
        dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    return Model(cfg), RefModel(rcfg)


def _ref_state_np(rs):
    return {"params": _np(rs.params),
            "opt": {"step": np.asarray(rs.opt.step), "m": _np(rs.opt.m),
                    "v": _np(rs.opt.v)}}


def _port_state(rs, model):
    return interop.train_state_from_reference(_ref_state_np(rs), model,
                                              device="cpu")


def _batch(d, step):
    b = rpipeline.synthetic_batch(d, step)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _scaled_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max(initial=0.0))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max diff {err:.3g}, scale {scale:.3g}"


def _hold_step(st, met, rs, rmet, lr, what):
    """A port step against the reference's at the step tolerances."""
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= \
        LOSS_RTOL * abs(float(rmet["loss"])), what
    assert abs(float(met["grad_norm"]) - float(rmet["grad_norm"])) <= \
        NORM_RTOL * float(rmet["grad_norm"]), what
    assert abs(float(met["lr"]) - float(rmet["lr"])) <= \
        UPD_RTOL * float(rmet["lr"]), what
    out = interop.train_state_to_numpy(st)
    assert int(out["opt"]["step"]) == int(rs.opt.step)
    for name in ("m", "v"):
        for g, w in zip(spec.tree_leaves(out["opt"][name]),
                        jax.tree_util.tree_leaves(getattr(rs.opt, name))):
            _scaled_close(g, w, MOMENT_TOL, f"{what} {name}")
    for g, w in zip(spec.tree_leaves(out["params"]),
                    jax.tree_util.tree_leaves(rs.params)):
        err = float(np.abs(g - np.asarray(w, np.float32)).max())
        assert err <= 2 * lr + 1e-6, f"{what} params: {err:.3g}"


# ---------------------------------------------------------------------------
# optimizer


def test_schedule_matches_reference():
    for c in (dict(lr=1.0, warmup_steps=10, total_steps=110,
                   min_lr_frac=0.1),
              dict(lr=3e-4, warmup_steps=1, total_steps=6),
              dict(lr=1e-3, warmup_steps=0, total_steps=20)):
        cfg, rcfg = adamw.AdamWConfig(**c), radamw.AdamWConfig(**c)
        for s in (0, 1, 2, 5, 10, 11, 57, 110, 200):
            got = adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))
            want = float(radamw.schedule(rcfg, jnp.asarray(s, jnp.int32)))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= UPD_RTOL * abs(want), (c, s)
    # the reference's own cases
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            min_lr_frac=0.1)
    assert float(adamw.schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(adamw.schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(adamw.schedule(cfg, torch.tensor(110))) - 0.1) < 1e-6


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_update_matches_reference(pdtype, mdtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 4, 2)}}

    def tree(f):
        return spec.tree_map(f, shapes)

    p = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    g = tree(lambda s: 0.3 * rng.standard_normal(s).astype(np.float32))
    m = tree(lambda s: 0.05 * rng.standard_normal(s).astype(np.float32))
    v = tree(lambda s: 0.01 * rng.random(s).astype(np.float32))
    c = dict(lr=1e-2, clip_norm=0.5, warmup_steps=1, total_steps=10)
    tdt, jdt = getattr(torch, pdtype), getattr(jnp, pdtype)
    tmd, jmd = getattr(torch, mdtype), getattr(jnp, mdtype)
    cfg = adamw.AdamWConfig(moment_dtype=tmd, **c)
    rcfg = radamw.AdamWConfig(moment_dtype=jmd, **c)

    def port(t, dt):
        return spec.tree_map(lambda a: torch.tensor(a).to(dt), t)

    def ref(t, dt):
        return spec.tree_map(lambda a: jnp.asarray(a, dt), t)

    params = port(p, tdt)
    state = adamw.AdamWState(step=torch.tensor(2, dtype=torch.int32),
                             m=port(m, tmd), v=port(v, tmd))
    newp, newst, stats = adamw.update(port(g, tdt), state, params, cfg)
    rp, rst, rstats = radamw.update(
        ref(g, jdt), radamw.AdamWState(jnp.asarray(2, jnp.int32),
                                       ref(m, jmd), ref(v, jmd)),
        ref(p, jdt), rcfg)
    assert newp is params and newst.m is state.m     # in place
    assert int(newst.step) == 3 and newst.step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert abs(float(stats[k]) - float(rstats[k])) <= \
            UPD_RTOL * float(rstats[k]), k
    assert float(stats["grad_norm"]) > 0.5           # the clip engages
    for got, want, dt in ((newp, rp, tdt), (newst.m, rst.m, tmd),
                          (newst.v, rst.v, tmd)):
        for a, b in zip(spec.tree_leaves(got), jax.tree_util.tree_leaves(
                want)):
            assert a.dtype == dt
            _scaled_close(a.float().numpy(), np.asarray(b, np.float32),
                          UPD_RTOL, f"{pdtype}/{mdtype}")


# ---------------------------------------------------------------------------
# the train step


def test_three_train_steps_match_reference():
    model, rmodel = _models()
    lr = 1e-3
    c = dict(lr=lr, warmup_steps=1, total_steps=10)
    ocfg, rocfg = adamw.AdamWConfig(**c), radamw.AdamWConfig(**c)
    d = rpipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                             global_batch=8)
    rtrain = jax.jit(rstep.make_train_step(rmodel, ocfg=rocfg))
    train = tstep.make_train_step(model, ocfg=ocfg)
    rs = rstep.init_state(rmodel, jax.random.PRNGKey(0), rocfg)
    for i in range(3):
        st = _port_state(rs, model)
        tb, jb = _batch(d, i)
        new, met = train(st, tb)
        # the state is updated in place and returned
        assert new.params is st.params and all(
            a is b for a, b in zip(spec.tree_leaves(new.opt.m),
                                   spec.tree_leaves(st.opt.m)))
        assert all(v.dtype == torch.float32 and v.dim() == 0
                   for v in met.values())
        rs, rmet = rtrain(rs, jb)
        _hold_step(new, met, rs, rmet, lr, f"step {i}")
    # gradient layouts belong to a mesh (the sharded step:
    # tests/test_torch_sharded_train.py)
    with pytest.raises(ValueError, match="without a mesh"):
        tstep.make_train_step(model, grad_shardings=object())


def test_microbatches_match_reference():
    model, rmodel = _models()
    lr = 1e-3
    c = dict(lr=lr, warmup_steps=0, total_steps=10)
    ocfg, rocfg = adamw.AdamWConfig(**c), radamw.AdamWConfig(**c)
    d = rpipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                             global_batch=8)
    rs0 = rstep.init_state(rmodel, jax.random.PRNGKey(0), rocfg)
    tb, jb = _batch(d, 0)
    rs, rmet = jax.jit(rstep.make_train_step(rmodel, ocfg=rocfg,
                                             microbatches=4))(rs0, jb)
    st, met = tstep.make_train_step(model, ocfg=ocfg, microbatches=4)(
        _port_state(rs0, model), tb)
    _hold_step(st, met, rs, rmet, lr, "microbatches=4")
    _, met1 = tstep.make_train_step(model, ocfg=ocfg)(
        _port_state(rs0, model), tb)
    assert abs(float(met1["loss"]) - float(met["loss"])) <= \
        LOSS_RTOL * float(met1["loss"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "xlstm-125m", "zamba2-7b",
                                  "whisper-tiny"])
def test_remat_is_bitwise_and_leaves_decode_alone(arch, monkeypatch):
    """``remat`` on against off: the loss and every gradient bit for bit,
    ``torch.utils.checkpoint`` called once a layer (a pair for xlstm,
    encoder and decoder layers for whisper) with grad on, never in a
    decode step."""
    import torch.utils.checkpoint as tuc
    calls = []
    real = tuc.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tuc, "checkpoint", counting)
    cfg = configs.get(f"{arch}-smoke").replace(dtype=torch.float32)
    on, off = Model(cfg.replace(remat=True)), Model(cfg.replace(remat=False))
    params = on.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                              np.int32))
             for k in ("tokens", "targets")}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(
            0.02 * rng.standard_normal((2, 8, cfg.d_model))).float()
    l_on, g_on = tstep.value_and_grad(on.loss, params, batch)
    n_layers = {"xlstm-125m": cfg.n_layers // 2,
                "whisper-tiny": cfg.n_layers + cfg.enc_layers}.get(
                    arch, cfg.n_layers)
    assert len(calls) == n_layers
    l_off, g_off = tstep.value_and_grad(off.loss, params, batch)
    assert len(calls) == n_layers
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(spec.tree_leaves(g_on),
                                                 spec.tree_leaves(g_off)))
    db = {"tokens": batch["tokens"][:, :1], "pos": 0}
    if cfg.enc_dec:
        db["enc_out"] = 0.02 * torch.ones((2, 8, cfg.d_model))
    outs = []
    for m in (on, off):
        with torch.enable_grad():
            outs.append(m.decode_step(params, db, m.init_cache(
                2, 8, device="cpu"))[0])
    assert len(calls) == n_layers and torch.equal(*outs)


def test_bf16_adamw_decreases_loss_and_clips():
    """The reference's test (tests/test_train_infra.py:24) on the port."""
    model = Model(configs.get(ARCH))
    ocfg = adamw.AdamWConfig(lr=1e-2, clip_norm=0.5, warmup_steps=0,
                             total_steps=100)
    state = tstep.init_state(model, 0, ocfg, device="cpu")
    assert spec.tree_leaves(state.params)[0].dtype == torch.bfloat16
    d = pipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32,
                            global_batch=4)
    train = tstep.make_train_step(model, ocfg=ocfg)
    losses = []
    for i, b in zip(range(10), pipeline.batches(d)):
        state, met = train(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        losses.append(float(met["loss"]))
        assert float(met["grad_norm"]) > 0
    assert losses[-1] < losses[0]


def test_gradflow_matches_reference():
    model, rmodel = _models()
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = interop.model_params_from_reference(_np(rparams), model,
                                                 device="cpu")
    d = rpipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                             global_batch=4)
    tb, jb = _batch(d, 0)
    cfg = gradflow.GradFlowConfig(tau=0.1, max_steps=6)
    rp2, rst = rgradflow.step(lambda p: rmodel.loss(p, jb), rparams,
                              rgradflow.GradFlowConfig(tau=0.1, max_steps=6))
    p2, st = gradflow.step(lambda p: model.loss(p, tb), params, cfg)
    assert int(st.steps) == int(rst.steps) >= 1
    assert int(st.attempts) == int(rst.attempts)
    for a, b in zip(spec.tree_leaves(p2), jax.tree_util.tree_leaves(rp2)):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        bound = 10 * (cfg.rtol * np.abs(b) + cfg.atol)
        assert (np.abs(a.numpy() - b) <= bound).all()
    with torch.no_grad():
        assert float(model.loss(p2, tb)) < float(model.loss(params, tb))


# ---------------------------------------------------------------------------
# data and fault bookkeeping


def test_pipeline_matches_reference(tmp_path):
    for seed, step, host, count in ((0, 0, 0, 1), (0, 5, 1, 2), (7, 3, 3, 4),
                                    (123, 1000, 0, 2)):
        c = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=seed)
        got = pipeline.synthetic_batch(pipeline.DataConfig(**c), step, host,
                                       count)
        want = rpipeline.synthetic_batch(rpipeline.DataConfig(**c), step,
                                         host, count)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])
    corpus = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 500, 4096, np.int32).tofile(corpus)
    c = dict(vocab_size=500, seq_len=16, global_batch=4, seed=0,
             corpus_path=str(corpus))
    for step, host, count in ((0, 0, 1), (3, 1, 2), (17, 0, 2)):
        got = pipeline.memmap_batch(pipeline.DataConfig(**c), step, host,
                                    count)
        want = rpipeline.memmap_batch(rpipeline.DataConfig(**c), step, host,
                                      count)
        for k in got:
            assert np.array_equal(got[k], want[k])
    it = pipeline.batches(pipeline.DataConfig(**c), 2)
    rit = rpipeline.batches(rpipeline.DataConfig(**c), 2)
    for _ in range(3):
        a, b = next(it), next(rit)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert pipeline.host_slice(8, 1, 4) == rpipeline.host_slice(8, 1, 4)


def test_fault_logic_matches_reference():
    """The reference test's cases (tests/test_train_infra.py:100) through
    both packages."""
    answers = []
    for mod in (fault, rfault):
        mon = mod.HeartbeatMonitor(n_workers=8, timeout_s=10.0)
        for w in range(8):
            mon.heartbeat(w, now=100.0)
        for w in range(8):
            if w != 3:
                mon.heartbeat(w, now=120.0)
        dead = mon.dead(now=125.0)
        for w in range(8):
            for _ in range(10):
                mon.record_step(w, 1.0 if w != 5 else 3.0)
        answers.append((
            dead, mon.stragglers(),
            mod.plan_elastic_mesh(30, chips_per_host=8, model_parallel=16,
                                  prefer_pods=2),
            mod.plan_elastic_mesh(1, 8, 16),
            mod.reshard_batch_plan(256, old_data=16, new_data=12),
            mod.reshard_batch_plan(256, old_data=16, new_data=8),
            mod.should_checkpoint(100, 50, 2.0, 30.0),
            mod.should_checkpoint(100, 5, 2.0, 30.0)))
    assert answers[0] == answers[1]
    assert answers[0][0] == {3} and answers[0][1] == {5}


# ---------------------------------------------------------------------------
# checkpoints


def _files(path):
    return {f: (np.load(os.path.join(path, f)) if f.endswith(".npy")
                else json.load(open(os.path.join(path, f))))
            for f in os.listdir(path)}


def test_checkpoints_cross_both_packages(tmp_path):
    """The reference saves and the port restores, the port saves and the
    reference restores: bit for bit, bf16 included, one fingerprint."""
    model, rmodel = _models(torch.bfloat16)
    rocfg = radamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    d = rpipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=8,
                             global_batch=2)
    rs = rstep.init_state(rmodel, jax.random.PRNGKey(0), rocfg)
    rs, _ = jax.jit(rstep.make_train_step(rmodel, ocfg=rocfg))(
        rs, _batch(d, 0)[1])
    rckpt.save(rs, str(tmp_path / "ref"), 1)
    st = ckpt.restore(tstep.abstract_state(model), str(tmp_path / "ref"), 1,
                      device="cpu")
    want = _ref_state_np(rs)
    got = interop.train_state_to_numpy(st)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(g, np.asarray(w, g.dtype))
    assert spec.tree_leaves(st.params)[0].dtype == torch.bfloat16
    assert st.opt.step.dtype == torch.int32 and int(st.opt.step) == 1
    ckpt.save(st, str(tmp_path / "port"), 1)
    a, b = (_files(str(tmp_path / w / "step_00000001")) for w in
            ("ref", "port"))
    assert sorted(a) == sorted(b)
    assert a["meta.json"] == b["meta.json"]        # fingerprint, dtypes
    for k in a:
        if k.endswith(".npy"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert ".params__layers__attn__wq.npy" in a and ".opt__.step.npy" in a
    ab = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(
        x.shape, x.dtype), rs)
    back = rckpt.restore(ab, str(tmp_path / "port"), 1)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(rs)):
        assert g.dtype == w.dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert ckpt._tree_fingerprint(tstep.abstract_state(model)) == \
        rckpt._tree_fingerprint(rstep.abstract_state(rmodel))
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.restore(tstep.abstract_state(Model(model.cfg.replace(
            n_layers=1))), str(tmp_path / "ref"), 1, device="cpu")


def test_checkpoint_prune_and_atomicity(tmp_path):
    tree = {"w": torch.arange(4.0)}
    for s in (1, 2, 3, 4):
        ckpt.save(tree, str(tmp_path), s)
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    # a stale .tmp dir must not be seen as a checkpoint
    os.makedirs(tmp_path / "step_00000009.tmp0")
    assert ckpt.latest_step(str(tmp_path)) == 4
    back = ckpt.restore({"w": torch.empty(4, device="meta")}, str(tmp_path),
                        4, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_restart_resumes_identically(tmp_path):
    """Crash-restart: training continued from a checkpoint reproduces the
    uninterrupted run bit for bit (the reference's test on the port)."""
    model = Model(configs.get(ARCH))
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=20)
    d = pipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                            global_batch=4)
    train = tstep.make_train_step(model, ocfg=ocfg)

    def run(state, s0, s1):
        for i in range(s0, s1):
            b = {k: torch.from_numpy(v) for k, v in
                 pipeline.synthetic_batch(d, i).items()}
            state, _ = train(state, b)
        return state

    full = run(tstep.init_state(model, 0, ocfg, device="cpu"), 0, 6)
    st2 = run(tstep.init_state(model, 0, ocfg, device="cpu"), 0, 3)
    ckpt.save(st2, str(tmp_path), 3)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = ckpt.restore(tstep.abstract_state(model, ocfg), str(tmp_path),
                            3, device="cpu")
    resumed = run(restored, 3, 6)
    for a, b in zip(ckpt._leaves_with_path(full),
                    ckpt._leaves_with_path(resumed)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the launcher and the quickstart


class _Crash(Exception):
    pass


@contextlib.contextmanager
def _crash_after(n):
    """The launcher's data stream dies after ``n`` batches, as a crashed
    process would."""
    real = pipeline.batches

    def dying(*a, **kw):
        for i, b in enumerate(real(*a, **kw)):
            if i == n:
                raise _Crash
            yield b

    pipeline.batches = dying
    try:
        yield
    finally:
        pipeline.batches = real


def test_launcher_resumes_after_a_crash(tmp_path, capsys):
    args = ["--device", "cpu", "--arch", ARCH, "--steps", "6", "--batch", "4",
            "--seq", "16", "--ckpt-every", "3", "--lr", "1e-3"]
    full = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    with _crash_after(3), pytest.raises(_Crash):
        launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert ckpt.latest_step(str(tmp_path / "b")) == 3
    capsys.readouterr()
    resumed = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 3" in out
    assert "step     3 loss=" in out and "done. first loss=" in out
    assert len(full) == 6 and resumed == full[3:]
    a, b = (_files(str(tmp_path / w / "step_00000006")) for w in "ab")
    assert a["meta.json"] == b["meta.json"]
    assert all(np.array_equal(a[k], b[k]) for k in a if k.endswith(".npy"))
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000003",
                                                  "step_00000006"]
    # the production mesh needs its world (256 ranks under torchrun): a
    # single process raises, naming the size
    with pytest.raises(ValueError, match="a world of 256 ranks, not 1"):
        launch_train.main(["--device", "cpu", "--mesh", "production"])


def test_launcher_gradflow_and_quickstart(capsys):
    hist = launch_train.main(["--device", "cpu", "--steps", "2", "--batch",
                              "2", "--seq", "8", "--optimizer", "gradflow"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert "ode_steps=" in capsys.readouterr().out
    sol, (losses, before, after) = quickstart.main(["--device", "cpu"])
    assert bool(sol.stats.success) and abs(float(sol.y.sum()) - 1) < 1e-6
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert after < before
