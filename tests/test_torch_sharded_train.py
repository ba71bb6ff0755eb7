"""The sharded train step against the port's single-device step, and
sharded checkpoints against the JAX package's.

On meshes data=2, model=2, 2x2 and 2x2x2 (``pod``), internlm2-1.8b-smoke
(dense GQA) and deepseek-v3-671b-smoke (MoE with MLA and MTP, the
expert-parallel path) each take one AdamW step in gloo ranks from the
same weights and batch as the single-device step, which every rank also
runs: the loss, the gradient norm, each gathered gradient, each gathered
updated parameter and moment within 1e-9 relative; a step of two
microbatches likewise; and the forward pass and three decode steps
(this rank's rows of the logits, its caches).  The computation is float64 throughout: the
weights are float64 and the model's float32 accumulations (norms,
softmax, the loss, AdamW's global norm: ``f32`` of ``layers``,
``transformer``, ``moe_ep`` and ``optim.adamw``) are widened to float64
in the ranks, so that what remains is the sharding's own reordering of
sums.  The MoE cap factor is raised so
that no item drops (the single-device step's dense MoE has no capacity).
The single-device step is held to the JAX package by
``tests/test_torch_train.py``.

Checkpoints, on 2 ranks: a sharded save restored by the reference's
``restore``, and the reference's save restored into the ranks' shards
with ``shardings=`` (and unsharded in one process).
"""
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distribution import _run_ranks

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.optim import adamw as radamw
from repro.train import checkpoint as rckpt
from repro.train import step as rstep

MESHES = {"data2": (2, 1, 0), "model2": (1, 2, 0), "2x2": (2, 2, 0),
          "2x2x2": (2, 2, 2)}
ARCHS = ("internlm2-1.8b-smoke", "deepseek-v3-671b-smoke")
TOL = 1e-9

STEP = """
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import make_pctx
from repro_torch.models import Model, ParallelCtx
from repro_torch.models import layers as L, moe_ep as ME, transformer as T
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.train import step as tstep
L.f32 = T.f32 = ME.f32 = adamw.f32 = torch.float64
mesh = make_debug_mesh(N_DATA, N_MODEL, pod=POD, device_type="cpu")
ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                         moment_dtype=torch.float64)
dc = pipeline.DataConfig(vocab_size=256, seq_len=16, global_batch=8)
batch = {k: torch.from_numpy(v) for k, v in
         pipeline.synthetic_batch(dc, 0).items()}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


for arch in ARCHS:
    cfg = configs.get(arch).replace(dtype=torch.float64, moe_cap_factor=8.0)
    model = Model(cfg)
    pctx = make_pctx(cfg, mesh)
    lay = model.layout(pctx)
    sh = tstep.state_shardings(model, pctx)
    comm = lay.comm

    def init(shardings=None):
        st = tstep.init_state(model, torch.Generator().manual_seed(0), ocfg,
                              device="cpu", shardings=shardings)
        return st._replace(params=tree_map(torch.Tensor.double, st.params))

    def full(t, s):
        return coll.gather_full(t, comm, s.dim_axes(t.dim()))

    errs = {}
    ref_state = init()
    l1, g1 = tstep.value_and_grad(model.loss, ref_state.params, batch)
    local = init(sh)
    l2, g2 = tstep.value_and_grad(
        lambda p, b: model.loss(p, b, pctx), local.params, batch)
    g2 = lay.reduce_grads(g2)
    errs["loss"] = abs(float(l2 - l1)) / abs(float(l1))
    errs["grad"] = max(rel(full(g, s), w) for g, s, w in zip(
        tree_leaves(g2), tree_leaves(sh.params), tree_leaves(g1)))
    for mb in (1, 2):
        single = init()
        _, m1 = tstep.make_train_step(model, ParallelCtx(), ocfg, mb)(
            single, batch)
        sharded = init(sh)
        _, m2 = tstep.make_train_step(model, pctx, ocfg, mb,
                                      grad_shardings=sh.params)(sharded,
                                                                batch)
        for k in ("loss", "grad_norm"):
            errs[f"{k}{mb}"] = abs(float(m2[k] - m1[k])) / abs(float(m1[k]))
        for name, a, b in (("params", sharded.params, single.params),
                           ("m", sharded.opt.m, single.opt.m),
                           ("v", sharded.opt.v, single.opt.v)):
            errs[f"{name}{mb}"] = max(rel(full(x, s), w) for x, s, w in zip(
                tree_leaves(a), tree_leaves(sh.params), tree_leaves(b)))
    # the forward pass and three decode steps: this rank's rows
    lay_rows = lay.local_batch(batch)[1]["tokens"].shape[0]
    r0 = lay.comm.index(lay.dp_axes) * lay_rows
    with torch.no_grad():
        full = model.forward(ref_state.params, batch)
        mine = model.forward(local.params, batch, pctx)
        errs["forward"] = rel(mine, full[r0:r0 + lay_rows])
        c1 = model.init_cache(8, 8, device="cpu")
        c2 = model.init_cache(8, 8, device="cpu", pctx=pctx)
        for i in range(3):
            b = {"tokens": batch["tokens"][:, i:i + 1],
                 "pos": torch.tensor(i, dtype=torch.int32)}
            y1, c1 = model.decode_step(ref_state.params, b, c1)
            y2, c2 = model.decode_step(local.params, b, c2, pctx)
            errs[f"decode{i}"] = rel(y2, y1[r0:r0 + lay_rows])
    OUT[arch] = errs
"""


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    cache = {}

    def get(mesh):
        if mesh not in cache:
            nd, nm, pod = MESHES[mesh]
            world = nd * nm * max(pod, 1)
            tmp = tmp_path_factory.mktemp(f"step_{mesh}")
            body = (f"N_DATA, N_MODEL, POD, ARCHS = {nd}, {nm}, {pod}, "
                    f"{ARCHS!r}\n" + textwrap.dedent(STEP))
            cache[mesh] = _run_ranks(tmp, world, body)
        return cache[mesh]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_equals_single_device(step_runs, mesh, arch):
    for r, out in enumerate(step_runs(mesh)):
        errs = out[arch]
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        assert not bad, (mesh, arch, r, errs)


# ---------------------------------------------------------------------------
# checkpoints between a sharded port and the reference
# ---------------------------------------------------------------------------

CKPT = """
import numpy as np
from repro_torch import configs, interop
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import make_pctx
from repro_torch.models import Model
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import step as tstep
cfg = configs.get(ARCH)
model = Model(cfg)
mesh = make_debug_mesh(1, 2, device_type="cpu")
pctx = make_pctx(cfg, mesh)
sh = tstep.state_shardings(model, pctx)
ocfg = adamw.AdamWConfig()
abstract = tstep.abstract_state(model, ocfg)
# the port's sharded save, for the reference to restore
state = tstep.init_state(model, torch.Generator().manual_seed(1), ocfg,
                         device="cpu", shardings=sh)
state.opt.step.fill_(3)
ckpt.save(state, TMP + "/port", 3, shardings=sh)
OUT["saved"] = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                     tree_leaves(interop.train_state_to_numpy(
                         state, sh)["params"]))
# the reference's save, restored into this rank's shards
mine = ckpt.restore(abstract, TMP + "/ref", 5, shardings=sh, device="cpu")
whole = ckpt.restore(abstract, TMP + "/ref", 5, device="cpu")
OUT["same_blocks"] = torch.tensor(all(
    torch.equal(a, s.shard(b)) for a, b, s in zip(
        tree_leaves(mine.params) + tree_leaves(mine.opt.m),
        tree_leaves(whole.params) + tree_leaves(whole.opt.m),
        tree_leaves(sh.params) * 2)))
# the numpy tree of the whole state reaches this rank as its shards
tree = interop.train_state_to_numpy(whole)
back = interop.train_state_from_reference(tree, model, device="cpu",
                                          shardings=sh)
OUT["numpy_shards"] = torch.tensor(all(
    torch.equal(a, b) for a, b in zip(
        tree_leaves(back.params) + tree_leaves(back.opt.v),
        tree_leaves(mine.params) + tree_leaves(mine.opt.v))))
OUT["restored"] = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                        tree_leaves(interop.train_state_to_numpy(
                            mine, sh)["params"]))
OUT["step"] = mine.opt.step
"""


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke",
                                  "dbrx-132b-smoke"])
def test_sharded_checkpoints_cross_packages(tmp_path, arch):
    rmodel = RefModel(ref_configs.get(arch))
    rocfg = radamw.AdamWConfig()
    rstate = rstep.init_state(rmodel, jax.random.PRNGKey(2), rocfg)
    rckpt.save(rstate, str(tmp_path / "ref"), 5)
    ranks = _run_ranks(tmp_path, 2, f"TMP = {str(tmp_path)!r}\n"
                       f"ARCH = {arch!r}\n" + textwrap.dedent(CKPT))
    rparams = [_np(a) for a in jax.tree_util.tree_leaves(rstate.params)]
    for out in ranks:
        assert bool(out["same_blocks"]) and int(out["step"]) == 0
        assert bool(out["numpy_shards"])
        for a, b in zip(out["restored"], rparams):
            assert np.array_equal(a.numpy(), b)
    # the reference restores the port's sharded save: the gathered state
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), rstate)
    back = rckpt.restore(abstract, str(tmp_path / "port"), 3)
    assert int(back.opt.step) == 3
    got = [_np(a) for a in jax.tree_util.tree_leaves(back.params)]
    for out in ranks:
        assert len(out["saved"]) == len(got)
        for a, b in zip(out["saved"], got):
            assert np.array_equal(a.numpy(), b)
