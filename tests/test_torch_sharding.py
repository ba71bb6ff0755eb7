"""The port's layouts against the JAX package's, and the mesh builders.

``spec_for`` / ``param_shardings`` / ``cache_axes_like`` of
``repro_torch.parallel.sharding`` against ``repro.parallel.sharding`` on
``FakeMesh``es (pure arithmetic: no XLA device, no process group): every
leaf of every arch in ``configs`` (FULL and smoke), both profiles, the
production single- and multi-pod meshes and the debug (2, 2) and
(2, 2, 2) meshes; specs equal and each leaf's local shard shape equal.
The production and debug ``DeviceMesh`` builders, the launcher's
``ParallelCtx``, every family under both profiles and the decode caches'
layout against the reference's cache rules run under PyTorch's fake
process group (``backend="fake"``), which builds a mesh of any size in
one process and moves no data.
"""
import math

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models.spec import is_spec as ref_is_spec
from repro.parallel import sharding as ref_shd
from repro_torch import configs
from repro_torch.models import SHAPES, Model, ParallelCtx
from repro_torch.models.spec import tree_map
from repro_torch.parallel import sharding as shd


class FakeMesh:
    """Just enough for spec_for without touching devices (the
    reference's own test double, ``tests/test_distribution.py:30``)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        import numpy as _np
        self.devices = _np.zeros(tuple(sizes.values()))


MESHES = {
    "production": {"data": 16, "model": 16},
    "production-multi": {"pod": 2, "data": 16, "model": 16},
    "debug": {"data": 2, "model": 2},
    "debug-pod": {"pod": 2, "data": 2, "model": 2},
}


def _local(shape, spec, sizes):
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // math.prod(sizes[a] for a in shd.spec_axes(e))
                 for n, e in zip(shape, spec))


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=ref_is_spec)


@pytest.mark.parametrize("arch", configs.names())
def test_param_specs_and_shard_shapes_match_reference(arch):
    model, rmodel = Model(configs.get(arch)), RefModel(ref_configs.get(arch))
    rspecs = _ref_leaves(rmodel.specs())
    abstract = model.abstract_params()
    from repro_torch.models.spec import tree_leaves
    assert [tuple(t.shape) for t in tree_leaves(abstract)] == \
        [tuple(s.shape) for s in rspecs]
    n = 0
    for mname, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        for profile in ("tp_fsdp", "fsdp"):
            rules, rrules = shd.PROFILES[profile][0], \
                ref_shd.PROFILES[profile][0]
            got = tree_leaves(shd.param_shardings(
                abstract, model.param_axes(), mesh, rules))
            for sh, rs, t in zip(got, rspecs, tree_leaves(abstract)):
                want = tuple(ref_shd.spec_for(rs.shape, rs.axes, mesh,
                                              rrules))
                assert sh.spec == want, (mname, profile, rs.axes)
                assert sh.local_shape(t.shape) == _local(rs.shape, want,
                                                         sizes)
                n += 1
    assert n == 8 * len(rspecs)


@pytest.mark.parametrize("arch", configs.names())
def test_cache_axes_and_specs_match_reference(arch):
    """cache_axes_like's tree, and the cache specs under the decode
    rules (``cache_rules_from(ACT_RULES)``) on every mesh."""
    cs = Model(configs.get(arch)).cache_specs(32, 64)
    rcs = RefModel(ref_configs.get(arch)).cache_specs(32, 64)
    ax = shd.cache_axes_like(cs, configs.get(arch))
    rax = ref_shd.cache_axes_like(rcs, ref_configs.get(arch))
    from repro_torch.models.spec import tree_leaves
    la = tree_leaves(ax)
    ra = jax.tree_util.tree_leaves(rax, is_leaf=lambda x: isinstance(
        x, tuple))
    shapes = [tuple(t.shape) for t in tree_leaves(cs)]
    assert la == [tuple(a) for a in ra]
    assert shapes == [tuple(s.shape) for s in jax.tree_util.tree_leaves(rcs)]
    for sizes in MESHES.values():
        mesh = FakeMesh(sizes)
        rules = shd.cache_rules_from(shd.ACT_RULES)
        rrules = ref_shd.cache_rules_from(ref_shd.ACT_RULES)
        for shape, a in zip(shapes, la):
            assert shd.spec_for(shape, a, mesh, rules) == tuple(
                ref_shd.spec_for(shape, a, mesh, rrules))


def test_spec_for_divisibility_fallbacks():
    """The reference's own cases (``tests/test_distribution.py:38``)."""
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    s = shd.spec_for((8192, 64, 128), ("embed", "heads", "head_dim"),
                     mesh, shd.PARAM_RULES)
    assert s == (("pod", "data"), "model")
    s = shd.spec_for((4608, 36, 128), ("embed", "heads", "head_dim"),
                     mesh, shd.PARAM_RULES)
    assert s == (("pod", "data"),)
    assert shd.spec_for((256, 7168, 2048), ("experts", "embed",
                                            "expert_mlp"), mesh,
                        shd.PARAM_RULES) == (("model", "data"), "pod")
    assert shd.spec_for((16, 6144, 10752), ("experts", "embed",
                                            "expert_mlp"), mesh,
                        shd.PARAM_RULES)[0] == "model"
    assert shd.spec_for((1, 1), ("batch", "seq"), mesh, shd.ACT_RULES) == ()
    fs = FakeMesh({"data": 16, "model": 16})
    prules, arules = shd.PROFILES["fsdp"]
    assert shd.spec_for((8192, 64, 128), ("embed", "heads", "head_dim"),
                        fs, prules) == (("data", "model"),)
    assert shd.spec_for((256, 4096, 8192), ("batch", "seq", "embed"),
                        fs, arules) == ("data", "model")


# ---------------------------------------------------------------------------
# DeviceMesh builders under a fake process group
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_world():
    """``fake_world(n)``: a fake default group of ``n`` ranks (this
    process rank 0), destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_launcher_production_meshes_and_pctx(fake_world):
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(256)
    mesh = ltrain.make_mesh("production", "cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.mesh.shape) == (16, 16)
    for arch, moe in (("dbrx-132b", "ep"), ("internlm2-1.8b", "dense")):
        p = ltrain.make_pctx(configs.get(arch), mesh)
        # the reference's (src/repro/launch/train.py:48-57)
        assert (p.mesh, p.moe_impl, p.dp_axes, p.ep_axis,
                p.moe_token_layout) == (mesh, moe, ("data",), "model",
                                        "split")
        assert isinstance(p.cst, shd.ShardCst) and p.cst.profile == "tp_fsdp"
    sh = shd.NamedSharding(mesh, shd.spec_for(
        (8192, 64, 128), ("embed", "heads", "head_dim"), mesh,
        shd.PARAM_RULES))
    assert sh.spec == ("data", "model")
    assert sh.local_shape((8192, 64, 128)) == (512, 4, 128)
    assert sh.block((8192, 64, 128)) == (slice(0, 512), slice(0, 4),
                                         slice(0, 128))
    assert [type(p).__name__ for p in sh.placements()] == ["Shard", "Shard"]
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    fake_world(512)
    multi = ltrain.make_mesh("production-multi", "cpu")
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert tuple(multi.mesh.shape) == (2, 16, 16)
    assert ltrain.make_pctx(configs.get("dbrx-132b"), multi).dp_axes == \
        ("pod", "data")


def test_launcher_wrong_world_raises(fake_world):
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import make_debug_mesh
    fake_world(4)
    with pytest.raises(ValueError, match="256"):
        ltrain.main(["--mesh", "production", "--device", "cpu",
                     "--steps", "1"])
    with pytest.raises(ValueError, match="a world of 8"):
        make_debug_mesh(2, 2, pod=2, device_type="cpu")
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    assert tuple(mesh.mesh.shape) == (2, 2)
    # gradient flow runs over a mesh (tests/test_torch_gradflow_mesh.py):
    # on the wrong world it raises as AdamW does
    with pytest.raises(ValueError, match="256"):
        ltrain.main(["--mesh", "production", "--device", "cpu",
                     "--optimizer", "gradflow"])


def _ref_cache_shapes(arch, batch, max_len, sizes, profile):
    """The reference's shard shape of each cache leaf under the cache
    rules of ``profile``'s activation rules, in tree order."""
    rcfg = ref_configs.get(arch)
    rcs = RefModel(rcfg).cache_specs(batch, max_len)
    rax = ref_shd.cache_axes_like(rcs, rcfg)
    rules = ref_shd.cache_rules_from(ref_shd.PROFILES[profile][1])
    mesh = FakeMesh(sizes)
    return [_local(s.shape, ref_shd.spec_for(s.shape, a, mesh, rules), sizes)
            for s, a in zip(jax.tree_util.tree_leaves(rcs),
                            jax.tree_util.tree_leaves(
                                rax, is_leaf=lambda x: isinstance(x, tuple)))]


@pytest.mark.parametrize("arch", ["zamba2-7b-smoke", "xlstm-125m-smoke",
                                  "whisper-tiny-smoke", "qwen2-vl-2b-smoke",
                                  "internlm2-1.8b-smoke"])
def test_every_family_runs_under_both_profiles(arch, fake_world):
    """No family is left for later: under both profiles every family's
    loss, forward pass, ``init_cache`` and decode step run on this rank's
    meta shards of a data 2 x model 2 mesh (tests/test_torch_fsdp_families.py
    holds their values), with this rank's rows (and, under fsdp, sequence
    block) of the logits, and each cache leaf in the reference's shard
    shape under its cache rules.  The decode step refuses a copy of the
    caches (which drops their layout) and a leaf whose layout is not the
    cache rules'."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.spec import tree_leaves
    fake_world(4)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    model = Model(configs.get(arch))
    cfg = model.cfg
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32),
             "targets": torch.zeros((2, 4), dtype=torch.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = torch.zeros((2, 4, cfg.d_model), dtype=cfg.dtype)
    if cfg.enc_dec:
        batch["frames"] = torch.zeros((2, 8, cfg.d_model), dtype=cfg.dtype)
    meta = {k: v.to("meta") for k, v in batch.items()}
    S = 8 if cfg.mrope else 4
    for profile in ("tp_fsdp", "fsdp"):
        pctx = ParallelCtx(mesh=mesh, cst=shd.make_cst(
            mesh, shd.PROFILES[profile][1]))
        local = tree_map(lambda t, s: torch.empty(
            s.local_shape(t.shape), dtype=t.dtype, device="meta"),
            model.abstract_params(), model.param_shardings(pctx))
        loss = model.loss(local, meta, pctx)
        assert loss.shape == () and loss.device.type == "meta"
        with torch.no_grad():
            logits = model.forward(local, meta, pctx)
        seq = S // 2 if profile == "fsdp" else S
        assert tuple(logits.shape) == (1, seq, cfg.vocab_size), profile
        cache = model.init_cache(8, 16, device="meta", pctx=pctx)
        assert [tuple(t.shape) for t in tree_leaves(cache)] == \
            _ref_cache_shapes(arch, 8, 16, {"data": 2, "model": 2}, profile)
        step = {"tokens": torch.zeros((8, 1), dtype=torch.int32,
                                      device="meta"), "pos": 0}
        if cfg.enc_dec:
            step["enc_out"] = torch.zeros((8, 8, cfg.d_model),
                                          dtype=cfg.dtype, device="meta")
        with torch.no_grad():
            y, _ = model.decode_step(local, step, cache, pctx)
        assert tuple(y.shape) == (4, 1, cfg.vocab_size), profile
        with pytest.raises(ValueError, match="no mesh layout"):
            model.decode_step(local, step, tree_map(torch.clone, cache), pctx)
        leaf = tree_leaves(cache)[0]
        leaf._split = ((),) + (("data",),) * (leaf.dim() - 1)
        with pytest.raises(ValueError, match="not the cache rules' block"):
            model.decode_step(local, step, cache, pctx)


DECODE_SHAPES = [n for n, s in SHAPES.items() if s.kind == "decode"]


@pytest.mark.parametrize("profile", ["tp_fsdp", "fsdp"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_init_cache_leaves_take_the_reference_shard_shapes(arch, profile,
                                                           fake_world):
    """Every cache leaf's local shape from ``init_cache(..., pctx=)`` on
    the production single- (256 ranks) and multi-pod (512) meshes, for
    every decode shape, equals the reference's shard shape under
    ``cache_rules_from`` of the profile's activation rules: kv heads over
    ``model`` where they divide it, else ``head_dim`` (qwen2-72b's 8 kv
    heads on 16), under fsdp the positions first."""
    from repro_torch.launch import dryrun
    from repro_torch.models.spec import tree_leaves
    model = Model(configs.get(arch))
    for name, world in (("single", 256), ("multi", 512)):
        fake_world(world)
        mesh = dryrun._mesh(name, "cpu")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        for shape in DECODE_SHAPES:
            sh = SHAPES[shape]
            pctx = dryrun.make_pctx(model.cfg, mesh, "decode", profile)
            cache = model.init_cache(sh.global_batch, sh.seq_len,
                                     device="meta", pctx=pctx)
            got = [tuple(t.shape) for t in tree_leaves(cache)]
            assert got == _ref_cache_shapes(arch, sh.global_batch,
                                            sh.seq_len, sizes, profile), \
                (name, shape)


@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke", "zamba2-7b-smoke"])
def test_decode_rows_split_in_part_as_spec_for_splits_them(arch, fake_world):
    """A decode batch of 2 on pod 2 x data 2 x model 2: ``spec_for``
    splits its rows over ``pod`` alone; the caches and the step's rows
    agree (one row a rank), under both profiles."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    fake_world(8)
    mesh = make_debug_mesh(2, 2, pod=2, device_type="cpu")
    model = Model(configs.get(arch))
    cfg = model.cfg
    for profile in ("tp_fsdp", "fsdp"):
        pctx = dryrun.make_pctx(cfg, mesh, "decode", profile)
        local = tree_map(lambda t, s: torch.empty(
            s.local_shape(t.shape), dtype=t.dtype, device="meta"),
            model.abstract_params(), model.param_shardings(pctx))
        cache = model.init_cache(2, 8, device="meta", pctx=pctx)
        step = {"tokens": torch.zeros((2, 1), dtype=torch.int32,
                                      device="meta"), "pos": 0}
        with torch.no_grad():
            y, _ = model.decode_step(local, step, cache, pctx)
        assert tuple(y.shape) == (1, 1, cfg.vocab_size), profile
