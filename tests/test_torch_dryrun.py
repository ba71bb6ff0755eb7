"""The dry run and the roofline (``launch/dryrun.py``,
``analysis/roofline.py``, ``analysis/stepcost.py``) against the JAX
package, on the CPU.

* ``model_flops_for`` and ``active_param_count`` equal the reference's
  for every arch and shape, exactly (arithmetic on the configs);
* ``Roofline.finalize`` with the reference's own check
  (``tests/test_ssm_and_analysis.py:102``) rescaled to the ``h100_sxm``
  row, and the network term of a group across nodes;
* the ring model against a hand count for each kind, and through
  ``StepCost`` on a fake group;
* the counted matmul flops of internlm2-1.8b-smoke's one-device train
  step against ``repro.analysis.hlocost.analyze`` of the reference's
  compiled step (the same batch, sequence and remat), within
  ``FLOP_RTOL``;
* ``lower_cell`` on an 8-rank fake debug mesh (pod 2 x data 2 x model 2)
  for internlm2-1.8b-smoke and deepseek-v3-671b-smoke at a tiny train
  and decode shape, the other families at a tiny train shape and a
  decode batch of one (and under the fsdp profile at the tiny train and
  decode shapes), and the CLI on a full-size cell and a cell that
  does not lower (whisper under the fsdp profile at 32 microbatches,
  whose 8 rows a microbatch do not split over 16 data ranks);
* the abstract route: meta tensors take a kernel's plain version and
  are counted under its row; a tensor typed for the card never does.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs
from repro.analysis import hlocost
from repro.analysis import roofline as ref_rf
from repro.models import SHAPES as REF_SHAPES
from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import configs, kernels
from repro_torch.analysis import roofline as rf
from repro_torch.analysis.stepcost import StepCost, is_abstract
from repro_torch.core import dispatch
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import SHAPES, Model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.train import step as tstep

#: the counted matmul flops against hlocost's, relative
FLOP_RTOL = 0.01


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    assert rf.active_param_count(cfg) == ref_rf.active_param_count(rcfg)
    assert set(SHAPES) == set(REF_SHAPES)
    for name in SHAPES:
        assert rf.model_flops_for(cfg, SHAPES[name]) == \
            ref_rf.model_flops_for(rcfg, REF_SHAPES[name])


def test_roofline_finalize_on_the_h100_row():
    dev = rf.get_device("h100_sxm")
    assert (dev.bf16_dense_flops, dev.nvlink_bw, dev.net_bw,
            dev.node_cards) == (989e12, 450e9, 50e9, 8)
    row = rf.Roofline(arch="a", shape="s", mesh="m", chips=256,
                      hlo_flops=989e12, hlo_bytes=3.35e12, coll_bytes=450e9,
                      model_flops=989e12 * 256).finalize()
    for v in (row.t_compute, row.t_memory, row.t_collective,
              row.useful_ratio, row.mfu_bound):
        assert abs(v - 1.0) < 1e-9
    # 50 GB of it over a group across nodes: one second more
    net = rf.Roofline(arch="a", shape="s", mesh="m", chips=256,
                      hlo_flops=989e12, hlo_bytes=3.35e12,
                      coll_bytes=500e9, coll_net_bytes=50e9,
                      model_flops=989e12 * 256).finalize("h100_sxm")
    assert abs(net.t_collective - 2.0) < 1e-9
    assert net.bottleneck == "collective"
    assert abs(net.mfu_bound - 0.5) < 1e-9
    assert net.to_dict()["coll_net_bytes"] == 50e9
    text = rf.summarize([row, net])
    assert text.count("\n") == 3 and "| collective |" in text
    with pytest.raises(ValueError, match="unknown roofline device"):
        row.finalize("tpu_v5e")


@pytest.mark.parametrize("kind,want", [
    ("all_gather", 750.0), ("all-gather", 750.0),
    ("all_reduce", 1500.0), ("reduce_scatter", 3000.0),
    ("all_to_all", 750.0), ("collective-permute", 1000.0)])
def test_ring_model_against_a_hand_count(kind, want):
    # a group of 4, an output of 1000 bytes: an all-gather sends 3 of
    # its 4 blocks, an all-reduce's ring twice that, a reduce-scatter 3
    # inputs of its 1000-byte block, an all-to-all 3 of 4 blocks
    assert rf.ring_bytes(kind, 1000, 4) == want
    assert rf.ring_bytes(kind, 1000, 1) == (1000.0 if "permute" in kind
                                            else 0.0)


def test_ring_model_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown collective"):
        rf.ring_bytes("broadcast", 10, 2)


def test_close_forgets_the_groups_of_a_world_already_destroyed():
    """``collectives.close`` tears down the current world's groups and
    only drops a Comm whose default group was destroyed without it."""
    import torch.distributed as dist
    with dryrun.fake_world(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        coll.comm_of(mesh).group(("data", "model"))
        dist.destroy_process_group()            # not through close()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        fresh = coll.comm_of(make_debug_mesh(2, 2, device_type="cpu"))
        pg, _ = fresh.group(("model", "data"))
    assert not dist.is_initialized() and coll._COMMS == {}
    assert fresh.world is not None and not fresh._groups
    with pytest.raises(ValueError):
        dist.destroy_process_group(pg)          # already torn down


def test_stepcost_reads_collectives_through_the_ring_model():
    with dryrun.fake_world(8):
        mesh = make_debug_mesh(2, 2, pod=2, device_type="cpu")
        comm = coll.comm_of(mesh)
        x = torch.empty(4, 8, device="meta")               # 128 bytes
        with StepCost() as sc:
            assert coll.all_gather(x, comm, "model").shape == (8, 8)
            assert coll.reduce_scatter(x, comm, ("pod", "data")).shape == \
                (1, 8)
            coll.all_reduce(x, comm, ("pod", "data", "model"))
    rows = {r["kind"]: r for r in sc.coll_rows()}
    assert rows["all_gather"]["ring_bytes"] == 128.0       # 256 * 1/2
    assert rows["reduce_scatter"]["ring_bytes"] == 96.0    # 32 * 3
    assert rows["all_reduce"]["ring_bytes"] == 2 * 128 * 7 / 8
    # ranks 0-7 lie in one node of 8: nothing crosses
    assert sc.coll_net_bytes == 0.0
    assert sc.coll_bytes == 128 + 96 + 224
    assert coll.counts(sc.collectives)["all_gather"] == (1, 128)
    small = StepCost(node_cards=2)
    small.collectives = sc.collectives
    assert small.coll_net_bytes == 96 + 224                # groups of 4, 8


def test_counted_flops_equal_hlocost_of_the_reference():
    arch, B, S = "internlm2-1.8b-smoke", 4, 32
    rmodel = RefModel(ref_configs.get(arch))
    rocfg = ref_adamw.AdamWConfig()
    rstate = ref_step.init_state(rmodel, jax.random.PRNGKey(0), rocfg)
    rb = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "targets")}
    txt = jax.jit(ref_step.make_train_step(rmodel, ocfg=rocfg)).lower(
        rstate, rb).compile().as_text()
    ref = hlocost.analyze(txt, 1)
    assert ref["unresolved_dots"] == 0 and ref["flops"] > 0
    model = Model(configs.get(arch))
    assert model.cfg.remat == rmodel.cfg.remat
    ocfg = adamw.AdamWConfig()
    state = tstep.abstract_state(model, ocfg)
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    with StepCost(args=(state, batch)) as sc:
        tstep.make_train_step(model, ocfg=ocfg)(state, batch)
    assert abs(sc.matmul_flops - ref["flops"]) <= FLOP_RTOL * ref["flops"]
    # AdamW's global norm: row 16 once a leaf, counted under its row
    assert sc.rows["dot"][0] == len(jax.tree_util.tree_leaves(rstate.params))
    assert sc.flops > sc.matmul_flops and sc.bytes > 0
    assert sc.peak_bytes > sc.baseline > 0


TINY = {"train": ShapeConfig("tiny_train", 16, 8, "train"),
        "decode": ShapeConfig("tiny_decode", 32, 8, "decode")}


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_lower_cell_on_a_small_fake_mesh(arch, kind):
    kernels.reset_counts()
    with dryrun.fake_world(8):
        mesh = make_debug_mesh(2, 2, pod=2, device_type="cpu")
        res = dryrun.lower_cell(arch, TINY[kind], mesh, "debug")
    assert res["ok"] and res["chips"] == 8
    st, mem, row = res["stepcost"], res["memory"], res["roofline"]
    assert st["flops"] > 0 and st["bytes"] > 0 and st["coll_total"] > 0
    assert st["coll_net"] == 0.0                 # 8 ranks: one node
    assert res["collectives"]["all_gather"][0] > 0
    assert mem["fits"] and mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert row["model_flops"] == rf.model_flops_for(
        configs.get(arch), TINY[kind])
    assert all(np.isfinite(row[k]) for k in ("t_compute", "t_memory",
                                             "t_collective"))
    counts = kernels.counts()
    assert all(launched == 0 for launched, _ in counts.values())
    if kind == "train":
        # AdamW's norm on abstract shards: row 16's plain version, once a
        # leaf, counted under its row
        assert st["rows"]["dot"]["calls"] == counts["dot"][1] > 0
        assert mem["state_bytes"] < mem["argument_bytes"]


ONE = ShapeConfig("one_decode", 32, 1, "decode")


@pytest.mark.parametrize("shape", [TINY["train"], ONE],
                         ids=["train", "decode_batch_1"])
@pytest.mark.parametrize("arch", ["zamba2-7b-smoke", "xlstm-125m-smoke",
                                  "whisper-tiny-smoke", "qwen2-vl-2b-smoke"])
def test_lower_cell_of_the_other_families(arch, shape):
    """zamba2, xlstm and whisper (each parameter gathered whole at use)
    and qwen2-vl lower on the 8-rank fake mesh; a decode batch of one,
    which the data axes cannot split, stays whole on every rank (the
    reference's ``spec_for`` replicates it)."""
    with dryrun.fake_world(8):
        mesh = make_debug_mesh(2, 2, pod=2, device_type="cpu")
        res = dryrun.lower_cell(arch, shape, mesh, "debug")
    assert res["ok"] and res["stepcost"]["flops"] > 0
    assert res["memory"]["fits"]
    if shape is ONE:
        assert res["memory"]["batch_bytes"] > 0


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", ["zamba2-7b-smoke", "xlstm-125m-smoke",
                                  "whisper-tiny-smoke", "qwen2-vl-2b-smoke"])
def test_lower_cell_of_the_other_families_under_fsdp(arch, kind):
    """The fsdp profile's train step (the sequence split over ``model``,
    the recurrent mixers gathering theirs) and decode step (the caches
    split over positions) lower for every family on the 8-rank fake
    mesh, at a cut shape (xlstm's per-timestep loops make its full
    ``train_4k`` meta run tens of minutes)."""
    with dryrun.fake_world(8):
        mesh = make_debug_mesh(2, 2, pod=2, device_type="cpu")
        res = dryrun.lower_cell(arch, TINY[kind], mesh, "debug",
                                profile="fsdp")
    assert res["ok"] and res["stepcost"]["flops"] > 0
    assert res["memory"]["fits"]
    assert res["collectives"]["all_gather"][0] > 0
    if kind == "train":
        assert res["collectives"]["reduce_scatter"][0] > 0


def test_dryrun_cli_records_a_cell_and_a_family_not_lowered(tmp_path):
    summary = dryrun.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                           "--shape", "train_4k", "--out", str(tmp_path)])
    (cell,) = summary
    assert cell["ok"] and cell["chips"] == 256
    saved = json.loads((tmp_path / "internlm2-1.8b__train_4k__single.json")
                       .read_text())
    assert saved["roofline"]["hlo_flops"] == cell["stepcost"]["flops"]
    assert saved["roofline"]["coll_net_bytes"] > 0   # data groups of 16
    # 32 microbatches of 256 rows: 8 rows a microbatch, which the 16
    # data ranks cannot split, and a gradient may not be taken of a
    # batch every rank holds whole
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--device", "cpu", "--arch", "whisper-tiny",
                     "--shape", "train_4k", "--profile", "fsdp",
                     "--microbatches", "32", "--out", str(tmp_path)])
    assert exc.value.code == 1
    bad = json.loads((tmp_path / "whisper-tiny__train_4k__single.json")
                     .read_text())
    assert not bad["ok"] and "does not split" in bad["error"]
    with pytest.raises(RuntimeError, match="no process group"):
        with dryrun.fake_world(2), dryrun.fake_world(2):
            pass


class _CudaTyped(torch.Tensor):
    """A tensor that names the card as its device (no data is read)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_only_abstract_tensors_take_the_plain_route():
    real = torch.ones(4, dtype=torch.float64)
    cuda = torch.Tensor._make_subclass(_CudaTyped, real)
    meta = torch.empty(4, dtype=torch.float64, device="meta")
    assert is_abstract(meta) and not is_abstract(real)
    assert not is_abstract(cuda)
    # the kernels' route: the card's tensor launches, meta takes the plain
    assert _build.on_cpu("dot", cuda) is False
    assert _build.on_cpu("dot", meta) is True
    assert _build.on_cpu("dot", real) is True
    with pytest.raises(ValueError, match="no kernel"):
        _build.on_cpu("dot", torch.empty(1).as_subclass(_OtherDevice))
    # under a counting StepCost: a card's call reaches its kernel with no
    # row counted; a meta call runs the plain version under its row
    ran = []
    with StepCost() as sc:
        out = sc._row("dot", lambda *a: ran.append(a) or "kernel",
                      (cuda, cuda), {})
    assert out == "kernel" and len(ran) == 1 and sc.rows == {}
    kernels.reset_counts()
    with StepCost() as sc:
        d = dispatch.dot(meta, meta)
    assert d.device.type == "meta" and sc.rows["dot"][0] == 1
    assert kernels.counts()["dot"] == (0, 1)
    assert "mul" not in sc.ops          # the plain version's ops: its row
    # with no StepCost the recorder is unset and "auto" runs as before
    assert dispatch.ROW_RECORDER is None
    assert float(dispatch.dot(real, real)) == 4.0


class _OtherDevice(torch.Tensor):
    @property
    def device(self):
        return torch.device("xpu", 0)
