"""Which of the two ensemble BDFs lies nearer the exact solution on
stiff decay chains (CPU only, both packages).

On the decay chain at n = 8 with rates 10^U(-1, 2) the port's
``ensemble_bdf`` and the JAX reference's take different steps (their
step decisions part on last-ulp differences), and at numpy seed 8 one
lane of 64 lies 1.99x the 10*(rtol*|y|+atol) gate from the reference's.
This script integrates each seed's 64 chains with both codes (rtol
1e-5, atol 1e-10, float64, t = 5), forms the exact solution
``expm(t J) y0`` per system, and prints, in units of rtol*|y_exact| +
atol: the two codes' gap and where it is largest, both codes' error
there, each code's mean over lanes of the lane's WRMS error, its
largest component error, and on how many lanes the port lies nearer.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/decay_chain_witness.py [--seeds 1 2 3 8]

About 6 s a seed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

RTOL, ATOL = 1e-5, 1e-10


def witness(seed, n=8, nsys=64, tf=5.0, lo=-1.0, hi=2.0):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    from scipy.linalg import expm

    from repro.core import batched as ref_batched
    from repro.core import problems as rprob
    from repro.core.arkode import ODEOptions as RefOptions
    from repro_torch.core import batched, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy

    k = 10.0 ** np.random.default_rng(seed).uniform(lo, hi, size=(nsys, n))
    y0 = np.zeros((nsys, n))
    y0[:, 0] = 1.0
    f, jac, _, _ = problems.decay_chain_family(n)
    F, J, _, _ = rprob.decay_chain_family(n)
    p, rp = {"k": torch.from_numpy(k)}, {"k": jnp.asarray(k)}
    y, _ = batched.ensemble_bdf_integrate(
        lambda t, y: f(t, y, p), lambda t, y: jac(t, y, p),
        torch.from_numpy(y0), 0.0, tf,
        opts=ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000),
        policy=ExecPolicy(device="cpu"))
    yr, _ = ref_batched.ensemble_bdf_integrate(
        lambda t, y: F(t, y, rp), lambda t, y: J(t, y, rp), jnp.asarray(y0),
        0.0, tf, opts=RefOptions(rtol=RTOL, atol=ATOL, max_steps=100_000))
    y, yr = y.numpy(), np.asarray(yr)
    exact = np.stack([expm(tf * (np.diag(-ks) + np.diag(ks[:-1], -1))) @ v
                      for ks, v in zip(k, y0)])
    w = 1.0 / (RTOL * np.abs(exact) + ATOL)
    gap = np.abs(y - yr) / (RTOL * np.abs(yr) + ATOL)
    lane, comp = np.unravel_index(np.argmax(gap), gap.shape)
    ep, er = (y - exact) * w, (yr - exact) * w
    wp, wr = (np.sqrt(np.mean(e ** 2, axis=1)) for e in (ep, er))
    return {"seed": seed, "gap": gap.max(), "lane": int(lane),
            "comp": int(comp), "port_there": abs(ep[lane, comp]),
            "ref_there": abs(er[lane, comp]), "port_mean": wp.mean(),
            "ref_mean": wr.mean(), "port_max": np.abs(ep).max(),
            "ref_max": np.abs(er).max(),
            "port_nearer": int((wp < wr).sum()), "lanes": nsys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 8])
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = witness(seed)
        print(f"seed {r['seed']}: gap {r['gap']:.4g} (lane {r['lane']}, "
              f"species {r['comp']}; there port {r['port_there']:.4g}, "
              f"reference {r['ref_there']:.4g} from exact); mean lane WRMS "
              f"port {r['port_mean']:.4g}, reference {r['ref_mean']:.4g}; "
              f"largest port {r['port_max']:.4g}, reference "
              f"{r['ref_max']:.4g}; port nearer on {r['port_nearer']} of "
              f"{r['lanes']} lanes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
