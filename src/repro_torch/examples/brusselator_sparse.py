"""Sparse ensemble Brusselator: dense vs sparse-direct vs preconditioned
Krylov on a banded-Jacobian ensemble.

The port of ``examples/brusselator_sparse.py``.  Each ensemble member is
a 1-D Brusselator reaction-diffusion system (n = 2*nx
species-interleaved unknowns, banded Jacobian: 2x2 reaction blocks plus
Laplacian neighbour coupling, fill ~ 4/nx).  Three pluggable linear
solvers integrate the SAME problem through ``integrate(...,
"ensemble_bdf")``:

* ``BlockDiagGJ``        — dense batched Gauss-Jordan (O(n^2) storage)
* ``EnsembleSparseGJ``   — batched sparse LU on the shared pattern
                           (symbolic once, O(nnz) storage)
* ``SPGMR + BlockJacobi``— matrix-free GMRES, left block-Jacobi
                           preconditioning through PSetup/PSolve

On the card the hot ops run the CUDA kernels; ``--device cpu`` runs
their plain PyTorch versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.brusselator_sparse \\
          [--nsys 64] [--nx 16] [--tf 2.0] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.context import Context
from repro_torch.core.ivp import IVP, integrate
from repro_torch.core.linsol import SPGMR, BlockDiagGJ, EnsembleSparseGJ
from repro_torch.core.policies import ExecPolicy, resolve_device
from repro_torch.core.precond import BlockJacobiPrecond
from repro_torch.core.problems import ensemble_brusselator


def run(label, prob, tf, ctx, opts, lin_solver, dev):
    t0 = time.perf_counter()
    sol = integrate(prob, 0.0, tf, "ensemble_bdf", ctx=ctx, opts=opts,
                    lin_solver=lin_solver)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = sol.stats
    nps = 0 if sol.npsolves is None else int(sol.npsolves)
    print(f"  {label:22s}: steps(med)="
          f"{int(st.steps.float().median()):5d} "
          f"nni={int(sol.nni):7d} nli={int(sol.nli or 0):7d} "
          f"npsolves={nps:7d} nsetups={int(st.nsetups.sum()):6d} "
          f"ws={sol.workspace_bytes:9d}B "
          f"ok={bool(sol.success)!s:5s} wall={wall:6.2f}s")
    return sol, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsys", type=int, default=64)
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--tf", type=float, default=2.0)
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    f, jac, pattern, y0 = ensemble_brusselator(args.nsys, args.nx,
                                               device=dev)
    n = 2 * args.nx
    fill = pattern.sum() / (n * n)
    print(f"ensemble brusselator: nsys={args.nsys}, n={n} "
          f"(nnz={int(pattern.sum())}, fill={100 * fill:.1f}%), "
          f"tf={args.tf}, on {dev}")

    prob = IVP(f=f, jac=jac, jac_sparsity=pattern, y0=y0)
    ctx = Context(policy=ExecPolicy(device=str(dev)))
    opts = ctx.options(rtol=args.rtol, atol=1e-9, max_steps=400_000)

    sols = {}
    sols["dense"] = run("BlockDiagGJ (dense)", prob, args.tf, ctx, opts,
                        BlockDiagGJ(), dev)
    sols["sparse"] = run("EnsembleSparseGJ", prob, args.tf, ctx, opts,
                         EnsembleSparseGJ(), dev)
    sols["krylov"] = run("SPGMR+BlockJacobi", prob, args.tf, ctx, opts,
                         SPGMR(tol=1e-10, restart=10, max_restarts=6,
                               precond=BlockJacobiPrecond(block_size=2)),
                         dev)

    y_ref = sols["dense"][0].y
    for k in ("sparse", "krylov"):
        d = float((sols[k][0].y - y_ref).abs().max())
        sp = sols["dense"][1] / max(sols[k][1], 1e-9)
        print(f"  {k:7s} vs dense: max|dy|={d:.2e}, "
              f"dense/{k} wall ratio={sp:.2f}x")
    ws_d = sols["dense"][0].workspace_bytes
    ws_s = sols["sparse"][0].workspace_bytes
    print(f"  newton storage: dense O(n^2)={ws_d}B, "
          f"sparse O(nnz)={ws_s}B ({ws_s / ws_d:.2f}x)")
    return sols


if __name__ == "__main__":
    main()
