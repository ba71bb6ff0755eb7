"""Dry run: one step of every (arch x shape x mesh) cell on abstract tensors.

The port's ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's step on the production mesh and reads XLA's memory and cost
analyses; eager PyTorch has no compiled program, so each cell's train,
prefill or decode step runs once here, on ``meta`` tensors, as rank 0 of
a fake process group of the mesh's size (256 ranks ``single``, 512
``multi``; ``backend="fake"``: no process, no data moved), each rank's
state the abstract shards its layout gives it
(``parallel.sharding``).  For each cell it records, a rank:

* ``stepcost``: the step's flops, HBM bytes and collective ring bytes
  (``analysis/stepcost.py``), and its collectives by kind (calls, bytes);
* ``memory``: the state shards' bytes (``argument_bytes``: parameters,
  moments and step, or parameters and decode caches; ``state_bytes``:
  parameters and moments), the global batch every rank is handed
  (``batch_bytes``), the step's peak of live bytes (those arguments and
  the batch included) and ``fits``: whether that peak is within the
  card's memory;
* ``roofline``: ``analysis.roofline.Roofline`` on the ``h100_sxm`` row
  (estimates from data-sheet ceilings, not measurements).

A cell that does not run records ``ok: false`` and its exception
("not lowered: <reason>" for a ``NotImplementedError``; every family
lowers under both profiles, a batch its data axes cannot split under a
gradient does not); the run goes on, and exits 1 if any cell failed.  Results go to ``--out`` (default
``build/dryrun/``), one JSON file a cell.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch internlm2-1.8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--device`` names the device type of the mesh (the card unless
``cpu``); the tensors are ``meta`` either way, so no kernel and no card
memory is used.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

from .. import configs
from ..analysis import roofline as rf
from ..analysis.stepcost import StepCost, tensors
from ..core.policies import resolve_device
from ..models import SHAPES, Model, ParallelCtx
from ..models.config import ShapeConfig
from ..models.spec import tree_map
from ..optim import adamw
from ..parallel import collectives as coll
from ..parallel import sharding as shd
from ..serve.decode import make_serve_step
from ..train import step as tstep

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: the card whose row the roofline reads
DEVICE_ROW = "h100_sxm"
#: a card's memory, the bound of ``fits`` (H100 SXM: 80 GB)
HBM_BYTES = 80e9
MESH_WORLD = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0
    (no other process, no data moved), torn down on exit
    (``collectives.close``); a process
    that already has a group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process with no process "
                           "group: it makes a fake one of the mesh's size")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        coll.close()


def make_pctx(cfg, mesh, shape_kind: str, profile: str = "tp_fsdp"):
    """The reference's ``make_pctx`` (``src/repro/launch/dryrun.py:55``):
    the profile's activation rules, expert parallelism over ('model',
    'data') when the experts divide them (``REPRO_EP_MULTI=0``: over
    'model' alone), the replicated token layout for a decode step."""
    names = shd.axis_names(mesh)
    sizes = shd.mesh_axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    ep_axis = "model"
    if (cfg.is_moe and os.environ.get("REPRO_EP_MULTI", "1") != "0"
            and cfg.n_experts % (sizes["model"] * sizes.get("data", 1)) == 0):
        ep_axis = ("model", "data")
    _, act_rules = shd.PROFILES[profile]
    return ParallelCtx(
        mesh=mesh, cst=shd.make_cst(mesh, act_rules),
        moe_impl="ep" if cfg.is_moe else "dense", dp_axes=dp,
        ep_axis=ep_axis,
        moe_token_layout="split" if shape_kind != "decode" else "replicated")


def _local(tree, shardings):
    """``meta`` tensors of each leaf's block on this rank."""
    return tree_map(lambda t, s: torch.empty(s.local_shape(t.shape),
                                             dtype=t.dtype, device="meta"),
                    tree, shardings)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _not_lowered(e: Exception) -> str:
    msg = f"{type(e).__name__}: {e}"
    return f"not lowered: {msg}" if isinstance(e, NotImplementedError) \
        else msg


def lower_cell(arch: str, shape_name, mesh, mesh_name: str, ocfg=None,
               profile: str = "tp_fsdp", microbatches: int = 1,
               cfg=None) -> Dict[str, Any]:
    """One cell's step on abstract shards of ``mesh`` (an initialised
    group of its size: :func:`fake_world`).  ``shape_name`` a name of
    ``SHAPES`` or a ``ShapeConfig``; ``cfg`` replaces ``arch``'s config
    (a cut of it)."""
    cfg = cfg or configs.get(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    model = Model(cfg)
    pctx = make_pctx(cfg, mesh, shape.kind, profile)
    ocfg = ocfg or adamw.AdamWConfig(
        moment_dtype=torch.bfloat16 if cfg.is_moe else torch.float32)
    chips = mesh.mesh.numel()
    t0 = time.perf_counter()
    batch = model.input_specs(shape)
    psh = model.param_shardings(pctx)
    if shape.kind == "train":
        astate = tstep.abstract_state(model, ocfg)
        state = tstep.TrainState(
            params=_local(astate.params, psh),
            opt=adamw.AdamWState(step=astate.opt.step,
                                 m=_local(astate.opt.m, psh),
                                 v=_local(astate.opt.v, psh)))
        step = tstep.make_train_step(model, pctx, ocfg,
                                     microbatches=microbatches,
                                     grad_shardings=psh)
        held = state
        state_bytes = _bytes((state.params, state.opt.m, state.opt.v))
        with StepCost(args=(state, batch)) as sc:
            step(state, batch)
    else:
        params = _local(model.abstract_params(), psh)
        held = state_bytes = None
        if shape.kind == "decode":
            held = (params, model.init_cache(
                shape.global_batch, shape.seq_len, device="meta",
                pctx=pctx))
        with StepCost(args=(held or params, batch)) as sc, torch.no_grad():
            if shape.kind == "prefill":
                model.loss(params, batch, pctx)
            else:
                make_serve_step(model, pctx)(params, batch, held[1])
        held = held or params
    lower_s = time.perf_counter() - t0
    mem = {"argument_bytes": _bytes(held),
           "state_bytes": state_bytes if state_bytes is not None
           else _bytes(held),
           "batch_bytes": _bytes(batch),
           "peak_bytes": sc.peak_bytes,
           "fits": sc.peak_bytes <= HBM_BYTES}
    summary = sc.summary()
    row = rf.Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=sc.flops, hlo_bytes=sc.bytes, coll_bytes=sc.coll_bytes,
        coll_net_bytes=sc.coll_net_bytes,
        model_flops=rf.model_flops_for(cfg, shape),
        coll_detail={k: v for k, v in summary.items()
                     if k.startswith("coll")},
        memory_per_chip=mem).finalize(DEVICE_ROW)
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "chips": chips, "profile": profile,
            "microbatches": microbatches, "lower_s": lower_s, "ok": True,
            "stepcost": summary,
            "collectives": coll.counts(sc.collectives),
            "collective_groups": sc.coll_rows(),
            "memory": mem, "roofline": row.to_dict(),
            "top_ops": sc.top_ops(), "top_collectives":
            sc.top_collectives()}


def _mesh(name: str, device_type: str):
    from .mesh import make_production_mesh
    return make_production_mesh(multi_pod=name == "multi",
                                device_type=device_type)


def run_cells(archs, shapes, meshes, out_dir, profile: str = "tp_fsdp",
              microbatches: int = 1, tag: str = "",
              device_type: str = "cuda"):
    """Every cell of ``archs`` x ``shapes`` x ``meshes`` (``"single"``,
    ``"multi"``), each in its own fake group; -> the cells' records."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    resolve_device(device_type)
    summary = []
    for mesh_name in meshes:
        with fake_world(MESH_WORLD[mesh_name]):
            mesh = _mesh(mesh_name, device_type)
            for arch in archs:
                for shape_name in shapes:
                    label = f"{arch} {shape_name} {mesh_name}"
                    if not configs.cell_is_runnable(arch, shape_name):
                        res = {"arch": arch, "shape": shape_name,
                               "mesh": "-", "ok": True, "skipped":
                               "long_500k needs sub-quadratic attention"}
                        summary.append(res)
                        _write(out_dir, arch, shape_name, "skipped", res,
                               tag)
                        print(f"SKIP {label} (full attention)", flush=True)
                        continue
                    try:
                        res = lower_cell(arch, shape_name, mesh, mesh_name,
                                         profile=profile,
                                         microbatches=microbatches)
                        rl = res["roofline"]
                        print(f"OK   {label}: {res['lower_s']:.1f} s, "
                              + row_line(rl), flush=True)
                    except Exception as e:       # recorded, and exit 1
                        traceback.print_exc()
                        res = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "profile": profile,
                               "ok": False, "error": _not_lowered(e)}
                        print(f"FAIL {label}: {res['error']}", flush=True)
                    summary.append(res)
                    _write(out_dir, arch, shape_name, mesh_name, res, tag)
    return summary


def row_line(rl: Dict) -> str:
    """One roofline row as a line: its terms, bottleneck and bounds."""
    mem = rl.get("memory_per_chip") or {}
    return (f"compute {rl['t_compute']:.4g} s, memory {rl['t_memory']:.4g}"
            f" s, collective {rl['t_collective']:.4g} s -> "
            f"{rl['bottleneck']}; useful {rl['useful_ratio']:.3f}, "
            f"MFU bound {rl['mfu_bound']:.2%}; peak "
            f"{mem.get('peak_bytes', 0) / 2**30:.2f} GiB a rank"
            f"{'' if mem.get('fits', True) else ' (does not fit)'}")


def _write(out_dir, arch, shape, mesh, res, tag: str = ""):
    suffix = f"__{tag}" if tag else ""
    path = Path(out_dir) / f"{arch}__{shape}__{mesh}{suffix}.json"
    path.write_text(json.dumps(res, indent=1, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--profile", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (perf iterations)")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--device", default=None,
                    help="device type of the mesh (default: the card)")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    device_type = resolve_device(args.device).type
    summary = run_cells(archs, shapes, meshes, args.out,
                        profile=args.profile,
                        microbatches=args.microbatches, tag=args.tag,
                        device_type=device_type)
    n_ok = sum(1 for r in summary if r.get("ok"))
    print(f"\n{n_ok}/{len(summary)} cells OK")
    if n_ok < len(summary):
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
