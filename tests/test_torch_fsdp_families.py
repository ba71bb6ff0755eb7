"""The ``fsdp`` profile for zamba2, xlstm, whisper and qwen2-vl's vision
prefix, and decode caches in the reference's layout, on 4 gloo ranks.

One spawn of 4 ranks (``tests/test_torch_distribution.py:_run_ranks``),
behind a module fixture, runs in float64 (the modules' float32
accumulations widened, as ``tests/test_torch_sharded_train.py`` does),
from the JAX package's weights of each ``-smoke`` config (carried across
with ``interop.model_params_from_reference``):

* on ``make_debug_mesh(2, 2)`` (data 2 x model 2) under the ``fsdp``
  profile, each family's loss and every gathered gradient leaf, and its
  forward pass (this rank's rows and sequence block), within ``TOL``
  (relative to each tensor's largest entry) of one process's, on a
  sequence of 16 split over ``model`` (qwen2-vl: a vision prefix of 5
  and 11 text tokens, so the prefix ends inside rank 0's block);
* decode steps under ``fsdp`` with caches of 6 positions split over
  ``model`` (the cache rules put ``seq`` on it): a step of 4 tokens
  (split over ``model``, written across both ranks' blocks), then two
  of one, logits within ``TOL`` of one process's;
* the same steps for deepseek-v3-671b-smoke (its own seeded weights):
  MLA's latent caches split over positions, the MoE expert parallel;
* on ``make_debug_mesh(1, 4)`` (data 1 x model 4) under tp_fsdp,
  qwen2-vl-2b-smoke's decode, whose 2 kv heads do not divide 4, so its
  caches split ``head_dim`` (12 = 4 x 3): the same steps' logits within
  ``TOL`` of one process's, each rank's K/V cache a quarter of one
  process's.

The test process holds the one-process loss the ranks computed to the
JAX reference's ``Model.loss`` on the same weights and batch (the
reference cannot run sharded on this jax: ROADMAP C,
``test_small_mesh_dryrun_and_sharded_equals_single``).
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distribution import _run_ranks

from repro import configs as ref_configs
from repro.models import Model as RefModel

FAMILIES = ("zamba2-7b-smoke", "xlstm-125m-smoke", "whisper-tiny-smoke",
            "qwen2-vl-2b-smoke")
#: sharded against one process, float64, relative to the largest entry
TOL = 1e-9
#: the one-process float64 loss against the reference's float32 loss,
#: relative (tests/test_torch_archs.py's TOL)
REF_RTOL = 1e-4
B, S, VIS = 4, 16, 5
#: the tokens of each decode step (from position 0 on), the caches' length
STEPS, MAX_LEN = (4, 1, 1), 6
HD_ARCH = "qwen2-vl-2b-smoke"
MLA_ARCH = "deepseek-v3-671b-smoke"

RANKS = """
from repro_torch import configs, interop
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import Model
from repro_torch.models import layers as L, moe_ep as ME, ssm as SS
from repro_torch.models import transformer as T
from repro_torch.models.spec import tree_leaves, tree_map, tree_unflatten
from repro_torch.parallel import collectives as coll
from repro_torch.train import step as tstep
L.f32 = T.f32 = ME.f32 = SS.f32 = torch.float64


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def load(arch):
    saved = np.load(f"{TMP}/{arch}.npz")
    model = Model(configs.get(arch).replace(dtype=torch.float64))
    n = len(tree_leaves(model.specs()))
    tree = tree_unflatten(model.specs(), [saved[f"p{i}"] for i in range(n)])
    full = tree_map(torch.Tensor.double, interop.model_params_from_reference(
        tree, model, device="cpu"))
    batch = {k[2:]: torch.from_numpy(saved[k]) for k in saved.files
             if k.startswith("b:")}
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    return model, full, batch


# (each step's error, one process's caches, this rank's); under fsdp
# (blocks: this rank's sequence block and their count) a step whose
# tokens split over 'model' returns this rank's block
def decode(model, full, local, pctx, batch, lo, hi, blocks=None):
    c1 = model.init_cache(B, MAX_LEN, device="cpu")
    c2 = model.init_cache(B, MAX_LEN, device="cpu", pctx=pctx)
    errs, pos = [], 0
    with torch.no_grad():
        for n in STEPS:
            b = {"tokens": batch["tokens"][:, pos:pos + n],
                 "pos": torch.tensor(pos, dtype=torch.int32)}
            pos += n
            if "enc_out" in batch:
                b["enc_out"] = batch["enc_out"]
            y1, c1 = model.decode_step(full, b, c1)
            y2, c2 = model.decode_step(local, b, c2, pctx)
            y1 = y1[lo:hi]
            if blocks and n % blocks[1] == 0:
                m = n // blocks[1]
                y1 = y1[:, blocks[0] * m:(blocks[0] + 1) * m]
            errs.append(rel(y2, y1))
    return errs, c1, c2


mesh = make_debug_mesh(2, 2, device_type="cpu")
comm = coll.comm_of(mesh)
for arch in FAMILIES:
    model, full, batch = load(arch)
    pctx = dryrun.make_pctx(model.cfg, mesh, "train", "fsdp")
    lay = model.layout(pctx)
    local = tree_map(lambda t, s: s.shard(t), full, lay.shardings)
    l1, g1 = tstep.value_and_grad(model.loss, full, batch)
    l2, g2 = tstep.value_and_grad(lambda p, b: model.loss(p, b, pctx),
                                  local, batch)
    g2 = lay.reduce_grads(g2)
    errs = {"loss": abs(float(l2 - l1)) / abs(float(l1))}
    errs["grad"] = max(rel(coll.gather_full(x, comm, s.dim_axes(x.dim())), w)
                       for x, s, w in zip(tree_leaves(g2),
                                          tree_leaves(lay.shardings),
                                          tree_leaves(g1)))
    rows, n = B // 2, S // 2
    r0, s0 = comm.index("data") * rows, comm.index("model") * n
    with torch.no_grad():
        errs["forward"] = rel(model.forward(local, batch, pctx),
                              model.forward(full, batch)[r0:r0 + rows,
                                                         s0:s0 + n])
    dpctx = dryrun.make_pctx(model.cfg, mesh, "decode", "fsdp")
    derrs, _, c2 = decode(model, full, local, dpctx, batch, r0, r0 + rows,
                          (comm.index("model"), 2))
    errs.update({f"decode{i}": e for i, e in enumerate(derrs)})
    OUT[arch] = torch.tensor([errs[k] for k in sorted(errs)],
                             dtype=torch.float64)
    OUT[arch + ":keys"] = tuple(sorted(errs))
    OUT[arch + ":loss1"] = float(l1)

# MLA's latent caches split over positions, the MoE expert parallel
cfg = configs.get(MLA_ARCH).replace(dtype=torch.float64, moe_cap_factor=8.0)
model = Model(cfg)
full = tree_map(torch.Tensor.double,
                model.init(torch.Generator().manual_seed(0), device="cpu"))
dpctx = dryrun.make_pctx(cfg, mesh, "decode", "fsdp")
local = tree_map(lambda t, s: s.shard(t), full, model.param_shardings(dpctx))
tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                       generator=torch.Generator().manual_seed(3))
errs, _, c2 = decode(model, full, local, dpctx, {"tokens": tokens}, r0,
                     r0 + rows, (comm.index("model"), 2))
OUT["mla"] = torch.tensor(errs, dtype=torch.float64)
OUT["mla:shape"] = tuple(c2["c_kv"].shape)

# head_dim-split caches: qwen2-vl's 2 kv heads on a model axis of 4
mesh4 = make_debug_mesh(1, 4, device_type="cpu")
model, full, batch = load(HD_ARCH)
pctx = dryrun.make_pctx(model.cfg, mesh4, "decode", "tp_fsdp")
local = tree_map(lambda t, s: s.shard(t), full, model.param_shardings(pctx))
errs, c1, c2 = decode(model, full, local, pctx, batch, 0, B)
OUT["hd"] = torch.tensor(errs, dtype=torch.float64)
OUT["hd:shapes"] = (tuple(c1["k"].shape), tuple(c2["k"].shape))
"""


def _batch(cfg):
    rng = np.random.default_rng(0)
    s = S - VIS if cfg.mrope else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s), np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, s), np.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = 0.02 * rng.standard_normal(
            (B, VIS, cfg.d_model))
    if cfg.enc_dec:
        batch["frames"] = 0.02 * rng.standard_normal((B, S, cfg.d_model))
        batch["enc_out"] = 0.02 * rng.standard_normal((B, S, cfg.d_model))
    return batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_families")
    refs = {}
    for arch in FAMILIES:
        rcfg = ref_configs.get(arch).replace(dtype=jnp.float32)
        rmodel = RefModel(rcfg)
        rparams = rmodel.init(jax.random.PRNGKey(0))
        batch = _batch(rcfg)
        leaves = jax.tree_util.tree_leaves(rparams)
        np.savez(tmp / f"{arch}.npz",
                 **{f"b:{k}": v for k, v in batch.items()},
                 **{f"p{i}": np.asarray(x) for i, x in enumerate(leaves)})
        jb = {k: jnp.asarray(v, dtype=jnp.float32 if v.dtype.kind == "f"
                             else v.dtype) for k, v in batch.items()
              if k != "enc_out"}
        refs[arch] = float(rmodel.loss(rparams, jb))
    body = (f"TMP, FAMILIES, HD_ARCH, MLA_ARCH = {str(tmp)!r}, "
            f"{FAMILIES!r}, {HD_ARCH!r}, {MLA_ARCH!r}\nB, S, STEPS, MAX_LEN = {B}, {S}, {STEPS!r}, "
            f"{MAX_LEN}\n" + textwrap.dedent(RANKS))
    return {"outs": _run_ranks(tmp, 4, body), "refs": refs}


@pytest.mark.parametrize("arch", FAMILIES)
def test_fsdp_loss_gradients_forward_and_decode_equal_one_process(ranks,
                                                                   arch):
    for out in ranks["outs"]:
        errs = dict(zip(out[arch + ":keys"], out[arch].tolist()))
        assert set(errs) == {"loss", "grad", "forward"} | {
            f"decode{i}" for i in range(len(STEPS))}
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        assert not bad, (arch, bad)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_process_loss_matches_the_reference(ranks, arch):
    got = ranks["outs"][0][arch + ":loss1"]
    want = ranks["refs"][arch]
    assert abs(got - want) <= REF_RTOL * abs(want), (got, want)


def test_mla_fsdp_decode_equals_one_process(ranks):
    """deepseek-v3's latent caches split over positions (6 = 2 x 3) and
    its MoE expert parallel: the same steps' logits within ``TOL`` of one
    process's (the dense MoE)."""
    for out in ranks["outs"]:
        errs = out["mla"].tolist()
        assert len(errs) == len(STEPS) and max(errs) <= TOL, errs
        # (layers, rows, positions, latent): half the rows, half the
        # positions
        assert out["mla:shape"][1:3] == (B // 2, MAX_LEN // 2)


def test_head_dim_split_decode_equals_one_process(ranks):
    for out in ranks["outs"]:
        errs = out["hd"].tolist()
        assert len(errs) == len(STEPS) and max(errs) <= TOL, errs
        whole, mine = out["hd:shapes"]
        # (layers, batch, positions, kv heads, head_dim): head_dim / 4
        assert mine == whole[:4] + (whole[4] // 4,)
