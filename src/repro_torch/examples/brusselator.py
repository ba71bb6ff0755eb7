"""The paper's §7 demonstration: 1D advection-reaction Brusselator.

The port of ``examples/brusselator.py``: IMEX (ARK3(2)4L[2]SA) with the
task-local Newton and its batched 3x3 block solve, against the global
Newton + GMRES configuration (the two solver configurations of the
paper's weak-scaling study), through
:func:`repro_torch.apps.brusselator.integrate`.  On the card the block
solve, the stage sums and the norms run the CUDA kernels; ``--device
cpu`` runs their plain PyTorch versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.brusselator \\
          [--nx 256] [--tf 1.0] [--solver task-local|global|both] \\
          [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.apps import brusselator as br
from repro_torch.configs.brusselator import BrusselatorConfig
from repro_torch.core.policies import ExecPolicy, resolve_device


def run(cfg, label, policy, dev):
    t0 = time.perf_counter()
    y, st = br.integrate(cfg, policy=policy)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print(f"  {label:11s}: steps={int(st.steps):5d} "
          f"attempts={int(st.attempts):5d} newton={int(st.nni):6d} "
          f"err_fails={int(st.netf):3d} conv_fails={int(st.ncfn):3d} "
          f"success={bool(st.success)} wall={wall:7.2f}s")
    return y, st, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--tf", type=float, default=1.0)
    ap.add_argument("--solver", default="both",
                    choices=["task-local", "global", "both"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    policy = ExecPolicy(device=str(dev))
    print(f"brusselator1d: nx={args.nx} (={3 * args.nx} ODEs), "
          f"tf={args.tf}, eps=5e-6 (stiff), on {dev}")

    results = {}
    for solver in (["task-local", "global"] if args.solver == "both"
                   else [args.solver]):
        cfg = BrusselatorConfig(nx=args.nx, t_final=args.tf, solver=solver)
        results[solver] = run(cfg, solver, policy, dev)

    if len(results) == 2:
        ytl = results["task-local"][0]
        ygl = results["global"][0]
        diff = float((ytl - ygl).abs().max())
        speedup = results["global"][2] / results["task-local"][2]
        print(f"  solutions agree to {diff:.2e}; task-local is "
              f"{speedup:.2f}x faster (paper: task-local >> global)")
    y = next(iter(results.values()))[0]
    print(f"  final ranges: u [{float(y[:, 0].min()):.4f}, "
          f"{float(y[:, 0].max()):.4f}]  w [{float(y[:, 2].min()):.4f}, "
          f"{float(y[:, 2].max()):.4f}]")
    return results


if __name__ == "__main__":
    main()
