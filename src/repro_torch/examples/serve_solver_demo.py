"""Serving the solver stack: dynamic batching + warm-start streaming.

The port of ``examples/serve_solver_demo.py``.  Two client patterns
against one :class:`repro_torch.serve.solver.SolverServer`:

1. a mixed burst: many one-shot requests across two problem families
   (parametric Robertson kinetics n=3, linear decay chain n=6) with
   per-request physics, batched into padded bundles that share one
   bundle runner per shape;
2. a streaming client: one trajectory advanced leg by leg, each request
   warm-starting from the previous response's ``session`` handle (no
   cold order-1 restart between legs).

Bundles run on the card, through the CUDA kernels; ``--device cpu``
runs the plain PyTorch versions on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_solver_demo \\
          [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.problems import decay_chain_family, robertson_family
from repro_torch.serve.solver import ProblemFamily, SolverServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--robertson", type=int, default=40,
                    help="Robertson requests of the burst")
    ap.add_argument("--decay", type=int, default=20,
                    help="decay-chain requests of the burst")
    args = ap.parse_args(argv)

    fr = robertson_family()
    fd = decay_chain_family(6)
    server = SolverServer(
        [ProblemFamily("robertson", 3, fr[0], fr[1], fr[2], fr[3]),
         ProblemFamily("decay6", 6, fd[0], fd[1], fd[2], fd[3])],
        device=args.device, bucket_sizes=(16, 32), max_batch=32,
        max_wait=2e-3)

    # -- pattern 1: a mixed burst of one-shot requests ------------------
    rng = np.random.default_rng(0)
    futs = []
    with server:                                  # background pump
        for _ in range(args.robertson):
            futs.append(server.submit(
                "robertson", [1.0, 0.0, 0.0], 0.0, 0.4,
                params={"k1": 0.04, "k2": 1e4 * (0.5 + rng.random()),
                        "k3": 3e7 * 10.0 ** rng.uniform(-1, 1)}))
        for _ in range(args.decay):
            futs.append(server.submit(
                "decay6", np.ones(6), 0.0, 1.0,
                params={"k": rng.uniform(0.1, 5.0, 6)}))
        sols = [f.result(timeout=120) for f in futs]

    ok = sum(bool(s.success) for s in sols)
    t = sols[0].timings
    print(f"burst: {ok}/{len(sols)} solved on {server.device}; first-request "
          f"timings: queue_wait={t['queue_wait'] * 1e3:.1f}ms "
          f"compile={t['compile'] * 1e3:.2f}ms "
          f"execute={t['execute'] * 1e3:.1f}ms")

    # -- pattern 2: streaming warm-start continuation -------------------
    p = {"k1": 0.04, "k2": 1.2e4, "k3": 3e7}
    sol = None
    steps = []
    for leg in range(4):                          # 4 legs of 0.3 each
        fut = server.submit(
            "robertson", [1.0, 0.0, 0.0] if sol is None else sol.y,
            0.0 if sol is None else float(sol.t), 0.3 * (leg + 1),
            params=p, session=None if sol is None else sol.session)
        server.drain()
        sol = fut.result(timeout=120)
        steps.append(int(sol.stats.steps))
    print(f"stream: 4 legs to t={float(sol.t):.1f}, per-leg steps {steps} "
          f"(legs 2+ warm-start from the session handle instead of a cold "
          f"order-1 restart)")
    print(f"final state: {sol.y.cpu().numpy()}")

    # -- observability --------------------------------------------------
    m = server.metrics()
    cache = m["trace_cache"]
    print(f"metrics: {m['requests']} requests in {m['bundles']} bundles, "
          f"occupancy={m['occupancy']:.2f}, "
          f"p50={m['latency_p50_s'] * 1e3:.0f}ms "
          f"p99={m['latency_p99_s'] * 1e3:.0f}ms")
    print(f"bundle cache: {cache['hits']} hits / {cache['misses']} misses "
          f"(hit rate {cache['hit_rate']:.2f}), steady-state rebuilds: "
          f"{m['steady_misses']}")
    return {"burst": sols, "stream_steps": steps, "metrics": m}


if __name__ == "__main__":
    main()
