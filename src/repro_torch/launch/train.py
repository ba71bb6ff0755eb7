"""End-to-end training launcher (an example application as well).

The port's ``repro.launch.train``: real steps on one device (the card
unless ``--device cpu``), or on the production meshes
(``--mesh production``: 16x16 ``("data", "model")``, 256 ranks;
``production-multi``: 2x16x16 with ``"pod"``, 512) under ``torchrun``,
each rank holding its shards of the state.  Features exercised: the
data pipeline, sharded state, checkpoint/restart (resume is automatic),
straggler/fault bookkeeping, metrics logging.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch internlm2-1.8b-smoke --steps 50 --batch 8 --seq 64 \\
      --ckpt-dir /tmp/ckpt [--device cpu]
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
      --arch internlm2-1.8b --mesh production
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from ..core.policies import resolve_device
from ..data import pipeline
from ..models import Model, ParallelCtx
from ..optim import adamw
from ..parallel import collectives as coll
from ..parallel import sharding as shd
from ..train import checkpoint as ckpt
from ..train import fault
from ..train import step as tstep


def make_mesh(kind: str, device_type: str):
    """The ``--mesh`` layout over the default group (initialised from
    ``torchrun``'s environment when it is not yet): None for
    ``"none"``; a world of another size raises ``ValueError``."""
    if kind == "none":
        return None
    import os
    import torch.distributed as dist
    from .mesh import make_production_mesh
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=kind.endswith("multi"),
                                device_type=device_type)


def make_pctx(cfg, mesh) -> ParallelCtx:
    """The reference's ``ParallelCtx`` for ``mesh``
    (``src/repro/launch/train.py:48-57``)."""
    return ParallelCtx(mesh=mesh, cst=shd.make_cst(mesh),
                       moe_impl="ep" if (cfg.is_moe and mesh is not None)
                       else "dense",
                       dp_axes=tuple(a for a in ("pod", "data")
                                     if mesh and a in shd.axis_names(mesh))
                       or ("data",))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "production", "production-multi"])
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "gradflow"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    model = Model(cfg)
    # a group this launcher initialises (under torchrun) it tears down
    owned = args.mesh != "none" and not torch.distributed.is_initialized()
    mesh = make_mesh(args.mesh, dev.type)
    pctx = make_pctx(cfg, mesh)
    ocfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 1))
    sh = abstract = None
    rank, world = 0, 1
    if mesh is not None:
        import torch.distributed as dist
        from .mesh import mesh_device
        dev = mesh_device(mesh)
        rank, world = dist.get_rank(), dist.get_world_size()
        sh = tstep.state_shardings(model, pctx)
        abstract = tstep.abstract_state(model, ocfg)

    # --- init or resume ---
    start_step = 0
    state = tstep.init_state(model, args.seed, ocfg, device=dev,
                             shardings=sh)
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            if rank == 0:
                print(f"resuming from checkpoint step {last}")
            state = ckpt.restore(state if sh is None else abstract,
                                 args.ckpt_dir, last, shardings=sh,
                                 device=dev)
            start_step = last

    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed)
    train_step = tstep.make_train_step(model, pctx, ocfg,
                                       microbatches=args.microbatches)

    if args.optimizer == "gradflow":
        from ..optim import gradflow
        gf = gradflow.GradFlowConfig(tau=0.5, max_steps=10)
        lay = None
        if mesh is not None:
            lay = model.layout(pctx)

    mon = fault.HeartbeatMonitor(n_workers=world)
    hist = []
    t_ckpt = 0.0
    for step_i, batch_np in zip(range(start_step, args.steps),
                                pipeline.batches(dcfg, start_step)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        t0 = time.time()
        if args.optimizer == "gradflow":
            def lf(p):
                return model.loss(p, batch, pctx)
            new_params, st = gradflow.step(lf, state.params, gf,
                                           layout=lay)
            state = state._replace(params=new_params)
            with torch.no_grad():
                metrics = {"loss": model.loss(state.params, batch, pctx),
                           "ode_steps": st.steps}
        else:
            state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        mon.heartbeat(rank)
        mon.record_step(rank, dt)
        hist.append(metrics["loss"])
        if rank == 0:
            print(f"step {step_i:5d} loss={metrics['loss']:.4f} "
                  f"dt={dt*1e3:.1f}ms " +
                  " ".join(f"{k}={v:.3g}" for k, v in metrics.items()
                           if k != "loss"), flush=True)
        if args.ckpt_dir and (step_i + 1) % args.ckpt_every == 0:
            tc = time.time()
            ckpt.save(state, args.ckpt_dir, step_i + 1, shardings=sh)
            if rank == 0:
                ckpt.prune(args.ckpt_dir, keep=3)
            t_ckpt = time.time() - tc
    if args.ckpt_dir:
        ckpt.save(state, args.ckpt_dir, args.steps, shardings=sh)
    if rank == 0:
        print(f"done. first loss={hist[0]:.4f} last={hist[-1]:.4f} "
              f"(ckpt write {t_ckpt:.2f}s)")
    if owned:
        coll.close()
    return hist


if __name__ == "__main__":
    main()
