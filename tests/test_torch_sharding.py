"""The port's layouts against the JAX package's, and the mesh builders.

``spec_for`` / ``param_shardings`` / ``cache_axes_like`` of
``repro_torch.parallel.sharding`` against ``repro.parallel.sharding`` on
``FakeMesh``es (pure arithmetic: no XLA device, no process group): every
leaf of every arch in ``configs`` (FULL and smoke), both profiles, the
production single- and multi-pod meshes and the debug (2, 2) and
(2, 2, 2) meshes; specs equal and each leaf's local shard shape equal.
The production and debug ``DeviceMesh`` builders, the launcher's
``ParallelCtx`` and the families left for later run under PyTorch's fake
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
from repro_torch.models import Model, ParallelCtx
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


@pytest.mark.parametrize("arch", ["zamba2-7b-smoke", "xlstm-125m-smoke",
                                  "whisper-tiny-smoke", "qwen2-vl-2b-smoke",
                                  "internlm2-1.8b-smoke"])
def test_families_left_for_later_raise_under_a_mesh(arch, fake_world):
    """Under the tp_fsdp profile every family runs on this rank's shards
    (zamba2, xlstm and whisper gathering each parameter whole, on their
    batch rows; tests/test_torch_gradflow_mesh.py holds their values).
    Under the ``fsdp`` profile (its sequence split over ``model``) the
    decoder-only LM runs, and zamba2, xlstm, whisper and qwen2-vl's
    M-RoPE vision prefix, left for later, raise at every entry point: no
    unsharded compute."""
    from repro_torch.launch.mesh import make_debug_mesh
    fake_world(4)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    model = Model(configs.get(arch))
    cfg = model.cfg
    pctx = ParallelCtx(mesh=mesh, cst=shd.make_cst(mesh))
    fsdp = ParallelCtx(mesh=mesh, cst=shd.make_cst(mesh, shd.FSDP_ACT_RULES))
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32),
             "targets": torch.zeros((2, 4), dtype=torch.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = torch.zeros((2, 4, cfg.d_model), dtype=cfg.dtype)
    if cfg.enc_dec:
        batch["frames"] = torch.zeros((2, 8, cfg.d_model), dtype=cfg.dtype)
    meta = {k: v.to("meta") for k, v in batch.items()}

    def local(p):
        return tree_map(lambda t, s: torch.empty(
            s.local_shape(t.shape), dtype=t.dtype, device="meta"),
            model.abstract_params(), model.param_shardings(p))

    loss = model.loss(local(pctx), meta, pctx)
    assert loss.shape == () and loss.device.type == "meta"
    if arch == "internlm2-1.8b-smoke":
        loss = model.loss(local(fsdp), meta, fsdp)
        assert loss.shape == () and loss.device.type == "meta"
        # the decoder-only LM's caches: this rank's rows and kv heads
        cache = model.init_cache(8, 16, device="cpu", pctx=pctx)
        assert tuple(cache["k"].shape) == (2, 4, 16, 1, 16)
        return
    for run in (lambda: model.loss({}, batch, fsdp),
                lambda: model.forward({}, batch, fsdp),
                lambda: model.init_cache(2, 8, device="cpu", pctx=fsdp),
                lambda: model.decode_step(
                    {}, {"tokens": batch["tokens"][:, :1], "pos": 0}, {},
                    fsdp)):
        with pytest.raises(NotImplementedError, match="ROADMAP A item 2"):
            run()
