"""Gradient flow and the ``fsdp`` profile over a mesh, on 4 gloo ranks.

The ranks (``tests/test_torch_distribution.py:_run_ranks``) make a
``make_debug_mesh(2, 2)`` (data 2 x model 2) and run, from the JAX
package's weights of internlm2-1.8b-smoke in float32 (carried across with
``interop.model_params_from_reference``) and one batch:

* ``optim.gradflow.step`` on their shards (tp_fsdp, ``layout=``), and
  the unsharded step of the whole parameters on rank 0; the test holds
  the sharded step's ERK step and attempt counts equal to the unsharded
  step's and its gathered parameters within ``GF_RTOL`` of them
  (relative to each leaf's largest entry), and the unsharded step to the
  reference's ``gradflow.step`` as ``tests/test_torch_train.py`` holds
  it (equal counts, every parameter within 10*(rtol*|p|+atol));
* the ``fsdp`` profile's loss (parameters sharded on ``embed`` over
  every rank, the batch over ``data`` and the sequence over ``model``),
  float32, within ``FSDP_LOSS_RTOL`` of one process's (the reference's
  GSPMD check asks 1e-4), for the dense GQA model and for
  deepseek-v3-671b-smoke (MLA, expert-parallel MoE, the multi-token
  head); then in float64 (the modules' float32 accumulations widened, as
  ``tests/test_torch_sharded_train.py`` does) the loss and every
  gathered gradient within ``FSDP_GRAD_RTOL``;
* zamba2, xlstm and whisper (every parameter gathered whole at use, the
  layers on their batch rows) and qwen2-vl's M-RoPE path (tensor
  parallel) on the same mesh, float64: loss, gradients, the forward pass
  and three decode steps within ``FAMILY_TOL`` of one process's;
* one tp_fsdp AdamW step of the smoke config at batch 8 x 16, with the
  collectives counted (``collectives.counts()``): the dry run's count of
  the same cell on a fake group of 4 (``launch.dryrun.lower_cell``, in
  the test's own process, no data) must equal it call for call and byte
  for byte.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distribution import _run_ranks

from repro import configs as ref_configs
from repro.data import pipeline as rpipeline
from repro.models import Model as RefModel
from repro.optim import gradflow as rgradflow
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.config import ShapeConfig

ARCH = "internlm2-1.8b-smoke"
TAU, MAX_STEPS = 0.1, 6
GF_RTOL = 1e-6
FSDP_LOSS_RTOL = 1e-4
FSDP_GRAD_RTOL = 1e-9
COLL_BATCH, COLL_SEQ = 8, 16

RANKS = """
import numpy as np
from repro_torch import configs, interop
from repro_torch.data import pipeline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import make_pctx
from repro_torch.models import Model
from repro_torch.models import layers as L, moe_ep as ME, transformer as T
from repro_torch.models.spec import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw, gradflow
from repro_torch.parallel import collectives as coll
from repro_torch.train import step as tstep
mesh = make_debug_mesh(2, 2, device_type="cpu")
comm = coll.comm_of(mesh)
saved = np.load(TMP + "/ref.npz")
batch = {k: torch.from_numpy(saved[k]) for k in ("tokens", "targets")}


def whole(local, shardings):
    return [coll.gather_full(t, comm, s.dim_axes(t.dim()))
            for t, s in zip(tree_leaves(local), tree_leaves(shardings))]


# gradient flow: the sharded step against the unsharded one
model = Model(configs.get(ARCH).replace(dtype=torch.float32))
tree = tree_unflatten(model.specs(), [saved[f"p{i}"] for i in
                                      range(len(tree_leaves(model.specs())))])
full = interop.model_params_from_reference(tree, model, device="cpu")
pctx = make_pctx(model.cfg, mesh)
lay = model.layout(pctx)
local = tree_map(lambda t, s: s.shard(t), full, lay.shardings)
cfg = gradflow.GradFlowConfig(tau=TAU, max_steps=MAX_STEPS)
p2, st = gradflow.step(lambda p: model.loss(p, batch, pctx), local, cfg,
                       layout=lay)
OUT["gf_counts"] = torch.tensor([int(st.steps), int(st.attempts)])
OUT["gf_params"] = tuple(whole(p2, lay.shardings))
if RANK == 0:
    p1, st1 = gradflow.step(lambda p: model.loss(p, batch), full, cfg)
    OUT["gf_single_counts"] = torch.tensor([int(st1.steps),
                                            int(st1.attempts)])
    OUT["gf_single"] = tuple(tree_leaves(p1))
    OUT["gf_start"] = tuple(tree_leaves(full))

# the fsdp profile's loss, float32
losses = []
for arch in (ARCH, "deepseek-v3-671b-smoke"):
    cfg_a = configs.get(arch).replace(dtype=torch.float32, moe_cap_factor=8.0)
    m = Model(cfg_a)
    fp = dryrun.make_pctx(cfg_a, mesh, "train", "fsdp")
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    sh = m.param_shardings(fp)
    mine = tree_map(lambda t, s: s.shard(t), params, sh)
    with torch.no_grad():
        losses.append([float(m.loss(mine, batch, fp)),
                       float(m.loss(params, batch))])
OUT["fsdp_loss32"] = torch.tensor(losses, dtype=torch.float64)

# one tp_fsdp AdamW step, its collectives counted
dc = pipeline.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=COLL_SEQ,
                         global_batch=COLL_BATCH)
big = {k: torch.from_numpy(v) for k, v in
       pipeline.synthetic_batch(dc, 0).items()}
ocfg = adamw.AdamWConfig()
sh = tstep.state_shardings(model, pctx)
state = tstep.init_state(model, torch.Generator().manual_seed(0), ocfg,
                         device="cpu", shardings=sh)
train = tstep.make_train_step(model, pctx, ocfg, grad_shardings=sh.params)
coll.reset_counts()
train(state, big)
OUT["collectives"] = torch.tensor([list(coll.counts()[k])
                                   for k in coll.KINDS])

# the fsdp profile in float64: loss and gradients
L.f32 = T.f32 = ME.f32 = adamw.f32 = torch.float64
errs = []
for arch in (ARCH, "deepseek-v3-671b-smoke"):
    cfg_a = configs.get(arch).replace(dtype=torch.float64, moe_cap_factor=8.0)
    m = Model(cfg_a)
    fp = dryrun.make_pctx(cfg_a, mesh, "train", "fsdp")
    flay = m.layout(fp)
    params = tree_map(torch.Tensor.double,
                      m.init(torch.Generator().manual_seed(0), device="cpu"))
    mine = tree_map(lambda t, s: s.shard(t), params, flay.shardings)
    l1, g1 = tstep.value_and_grad(m.loss, params, batch)
    l2, g2 = tstep.value_and_grad(lambda p, b: m.loss(p, b, fp), mine, batch)
    g2 = flay.reduce_grads(g2)
    rel = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
           for a, b in zip(whole(g2, flay.shardings), tree_leaves(g1))]
    errs.append([abs(float(l2 - l1)) / abs(float(l1)), max(rel)])
OUT["fsdp64"] = torch.tensor(errs, dtype=torch.float64)
"""


FAMILIES = ("zamba2-7b-smoke", "xlstm-125m-smoke", "whisper-tiny-smoke",
            "qwen2-vl-2b-smoke")
FAMILY_TOL = 1e-9

FAMILY_RANKS = """
from repro_torch import configs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import make_pctx
from repro_torch.models import Model
from repro_torch.models import layers as L, moe_ep as ME, ssm as SS
from repro_torch.models import transformer as T
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.train import step as tstep
L.f32 = T.f32 = ME.f32 = adamw.f32 = torch.float64
if hasattr(SS, "f32"):
    SS.f32 = torch.float64
mesh = make_debug_mesh(2, 2, device_type="cpu")
comm = coll.comm_of(mesh)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


for arch in FAMILIES:
    cfg = configs.get(arch).replace(dtype=torch.float64)
    model = Model(cfg)
    pctx = make_pctx(cfg, mesh)
    lay = model.layout(pctx)
    g = torch.Generator().manual_seed(1)
    B, S = 4, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     dtype=torch.int32),
             "targets": torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=g, dtype=torch.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = 0.02 * torch.randn(
            (B, 4, cfg.d_model), generator=g, dtype=torch.float64)
    if cfg.enc_dec:
        batch["frames"] = 0.02 * torch.randn(
            (B, 8, cfg.d_model), generator=g, dtype=torch.float64)
    full = tree_map(torch.Tensor.double,
                    model.init(torch.Generator().manual_seed(0),
                               device="cpu"))
    local = tree_map(lambda t, s: s.shard(t), full, lay.shardings)
    errs = {}
    l1, g1 = tstep.value_and_grad(model.loss, full, batch)
    l2, g2 = tstep.value_and_grad(lambda p, b: model.loss(p, b, pctx),
                                  local, batch)
    g2 = lay.reduce_grads(g2)
    errs["loss"] = abs(float(l2 - l1)) / abs(float(l1))
    errs["grad"] = max(rel(coll.gather_full(x, comm, s.dim_axes(x.dim())), w)
                       for x, s, w in zip(tree_leaves(g2),
                                          tree_leaves(lay.shardings),
                                          tree_leaves(g1)))
    rows = B // 2
    r0 = comm.index("data") * rows
    with torch.no_grad():
        errs["forward"] = rel(model.forward(local, batch, pctx),
                              model.forward(full, batch)[r0:r0 + rows])
        c1 = model.init_cache(B, 8, device="cpu")
        c2 = model.init_cache(B, 8, device="cpu", pctx=pctx)
        enc = 0.02 * torch.randn((B, 8, cfg.d_model), generator=g,
                                 dtype=torch.float64)
        for i in range(3):
            b = {"tokens": batch["tokens"][:, i:i + 1],
                 "pos": torch.tensor(i, dtype=torch.int32)}
            if cfg.enc_dec:
                b["enc_out"] = enc
            y1, c1 = model.decode_step(full, b, c1)
            y2, c2 = model.decode_step(local, b, c2, pctx)
            errs[f"decode{i}"] = rel(y2, y1[r0:r0 + rows])
    OUT[arch] = torch.tensor([errs[k] for k in sorted(errs)],
                             dtype=torch.float64)
    OUT[arch + ":keys"] = tuple(sorted(errs))
"""


def _batch():
    d = rpipeline.DataConfig(vocab_size=ref_configs.get(ARCH).vocab_size,
                             seq_len=16, global_batch=4)
    return rpipeline.synthetic_batch(d, 0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gradflow_mesh")
    rmodel = RefModel(ref_configs.get(ARCH).replace(dtype=jnp.float32))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(rparams)
    np.savez(tmp / "ref.npz", **_batch(),
             **{f"p{i}": np.asarray(x) for i, x in enumerate(leaves)})
    body = (f"TMP, ARCH, TAU, MAX_STEPS = {str(tmp)!r}, {ARCH!r}, {TAU}, "
            f"{MAX_STEPS}\nCOLL_BATCH, COLL_SEQ = {COLL_BATCH}, {COLL_SEQ}\n"
            + textwrap.dedent(RANKS))
    return {"outs": _run_ranks(tmp, 4, body), "rparams": rparams,
            "rmodel": rmodel}


def _gf_errs(got, want):
    """Each leaf's max abs difference over its largest entry."""
    return [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(got, want)]


def test_gradflow_over_a_mesh_equals_the_unsharded_step(ranks):
    outs = ranks["outs"]
    single = outs[0]["gf_single"]
    counts = outs[0]["gf_single_counts"].tolist()
    assert counts[0] >= 1
    for out in outs:
        assert out["gf_counts"].tolist() == counts
        for a, b in zip(out["gf_params"], single):
            assert a.shape == b.shape
        assert max(_gf_errs(out["gf_params"], single)) <= GF_RTOL


def test_gradflow_mesh_gate_fails_a_wrong_step(ranks):
    """The parameter gate above lies well below the step's own
    movement: a step that returns its input, or half the update, lies
    past it."""
    out = ranks["outs"][0]
    start, single = out["gf_start"], out["gf_single"]
    assert max(_gf_errs(start, single)) > 100 * GF_RTOL
    half = [s + 0.5 * (p - s) for s, p in zip(start, single)]
    assert max(_gf_errs(half, single)) > 50 * GF_RTOL


def test_gradflow_unsharded_step_matches_the_reference(ranks):
    out = ranks["outs"][0]
    rmodel, rparams = ranks["rmodel"], ranks["rparams"]
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    rcfg = rgradflow.GradFlowConfig(tau=TAU, max_steps=MAX_STEPS)
    rp2, rst = rgradflow.step(lambda p: rmodel.loss(p, jb), rparams, rcfg)
    assert out["gf_single_counts"].tolist() == [int(rst.steps),
                                                int(rst.attempts)]
    for a, b in zip(out["gf_single"], jax.tree_util.tree_leaves(rp2)):
        b = np.asarray(b)
        bound = 10 * (rcfg.rtol * np.abs(b) + rcfg.atol)
        assert (np.abs(a.numpy() - b) <= bound).all()


def test_fsdp_profile_loss_equals_one_process(ranks):
    for out in ranks["outs"]:
        for sharded, single in out["fsdp_loss32"].tolist():
            assert abs(sharded - single) <= FSDP_LOSS_RTOL * abs(single)
        for loss_rel, grad_rel in out["fsdp64"].tolist():
            assert loss_rel <= FSDP_GRAD_RTOL and grad_rel <= FSDP_GRAD_RTOL


def test_dry_run_counts_the_collectives_of_a_real_step(ranks):
    """The fake group's dry run of the cell counts what the gloo ranks'
    real step handed its collectives."""
    from repro_torch.parallel import collectives as coll
    shape = ShapeConfig("coll", COLL_SEQ, COLL_BATCH, "train")
    with dryrun.fake_world(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        cell = dryrun.lower_cell(ARCH, shape, mesh, "debug",
                                 cfg=configs.get(ARCH).replace(
                                     dtype=torch.float32))
    want = {k: tuple(v) for k, v in zip(
        coll.KINDS, ranks["outs"][0]["collectives"].tolist())}
    assert cell["collectives"] == want
    for out in ranks["outs"]:
        assert out["collectives"].tolist() == \
            ranks["outs"][0]["collectives"].tolist()


@pytest.fixture(scope="module")
def family_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families_mesh")
    body = f"FAMILIES = {FAMILIES!r}\n" + textwrap.dedent(FAMILY_RANKS)
    return _run_ranks(tmp, 4, body)


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_on_a_mesh_equal_one_process(family_ranks, arch):
    """zamba2, xlstm, whisper (each parameter gathered whole at use, the
    layers on their batch rows) and qwen2-vl's M-RoPE path (tensor
    parallel) on data 2 x model 2, float64 with the float32
    accumulations widened: the loss, every gathered gradient, the
    forward pass's rows and three decode steps within FAMILY_TOL of one
    process's."""
    for r, out in enumerate(family_ranks):
        errs = dict(zip(out[arch + ":keys"], out[arch].tolist()))
        bad = {k: v for k, v in errs.items() if not v <= FAMILY_TOL}
        assert not bad, (arch, r, errs)
