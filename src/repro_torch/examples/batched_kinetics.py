"""Submodel use case (paper §2, Fig. 5): many small independent stiff
kinetics systems integrated together.

The port of ``examples/batched_kinetics.py``.  Each system is a
Robertson problem with its own rate constants (numpy seed 0), so the
stiffness varies from cell to cell and each system takes its own
adaptive steps.  Everything goes through ``IVP`` + ``integrate``:

* default  — ``ensemble_dirk:sdirk2`` (adaptive SDIRK2 ensemble);
* ``--bdf`` — ``ensemble_bdf``, the batched BDF with per-system order
  and step and a pluggable linear solver: ``--lin-solver setup|direct``
  are the two ``BlockDiagGJ`` configurations (the saved block inverse,
  or a block solve each Newton iteration), ``spgmr`` is matrix-free
  Krylov.

On the card the hot ops run the CUDA kernels; ``--device cpu`` runs
their plain PyTorch versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.batched_kinetics \\
          [--cells 512] [--bdf] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.context import Context
from repro_torch.core.ivp import IVP, integrate
from repro_torch.core.linsol import SPGMR, BlockDiagGJ
from repro_torch.core.policies import ExecPolicy, resolve_device
from repro_torch.core.problems import batched_robertson, batched_robertson_soa


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=512)
    ap.add_argument("--tf", type=float, default=10.0)
    ap.add_argument("--bdf", action="store_true",
                    help="use the batched adaptive-order BDF ensemble")
    ap.add_argument("--order", type=int, default=5)
    ap.add_argument("--lin-solver", choices=("setup", "direct", "spgmr"),
                    default="setup",
                    help="ensemble-BDF linear solver: factor-once block "
                         "inverse, per-iteration block solve, or "
                         "matrix-free Krylov")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    n = args.cells
    dev = resolve_device(args.device)
    f, jac, y0 = batched_robertson(n, device=dev)
    f_soa, jac_soa = batched_robertson_soa(n, device=dev)
    ctx = Context(policy=ExecPolicy(device=str(dev)))
    opts = ctx.options(rtol=1e-5, atol=1e-10, max_steps=100_000)
    lin = {"setup": BlockDiagGJ(factor_once=True),
           "direct": BlockDiagGJ(factor_once=False),
           "spgmr": SPGMR(tol=1e-9, restart=30, max_restarts=4)}[
        args.lin_solver]
    prob = IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa)
    kind = f"BDF(1-{args.order}, {lin.name})" if args.bdf else "SDIRK2"
    print(f"integrating {n} independent stiff kinetics systems with {kind} "
          f"(block-diagonal Jacobian: {n} blocks of 3x3) to t={args.tf} "
          f"on {dev}")
    t0 = time.perf_counter()
    if args.bdf:
        sol = integrate(prob, 0.0, args.tf, method="ensemble_bdf", ctx=ctx,
                        opts=opts, order=args.order, lin_solver=lin)
    else:
        sol = integrate(prob, 0.0, args.tf, method="ensemble_dirk:sdirk2",
                        ctx=ctx, opts=opts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = sol.stats
    steps = st.steps.float()
    print(f"  all converged: {bool(sol.success)}   wall={wall:.2f}s")
    print(f"  per-system adaptive steps: min={int(st.steps.min())} "
          f"median={int(steps.median())} max={int(st.steps.max())}"
          f"   (stiffer cells take more steps)")
    if args.bdf:
        print(f"  Newton iters (median): {int(st.nni.float().median())}"
              f"   lsetups (median): {int(st.nsetups.float().median())}"
              f"   (Jacobian reuse across steps)")
        if sol.nli is not None and int(sol.nli) > 0:
            print(f"  Krylov inner iterations: {int(sol.nli)}")
    print(f"  solver workspace: {sol.workspace_bytes / 1024:.1f} KiB "
          f"(history + Newton blocks)")
    mass = sol.y.sum(dim=1)
    print(f"  mass conservation: max |1 - sum(y)| = "
          f"{float((mass - 1.0).abs().max()):.2e}")
    return sol


if __name__ == "__main__":
    main()
