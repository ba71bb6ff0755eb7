"""Quickstart: the two faces of the port in one script.

The port of ``examples/quickstart.py``:

1. SUNDIALS on PyTorch: solve a stiff ODE through the unified front-end
   (``IVP`` + ``integrate(method=...)`` -> ``Solution``), with the dense
   Gauss-Jordan linear solver.
2. LM framework: train a small transformer for a few steps with AdamW,
   then with the gradient-flow (ODE) optimizer — the same integrator
   driving the parameters.

Runs on the card; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core.context import Context
from repro_torch.core.ivp import IVP, integrate
from repro_torch.core.linsol import DenseGJ
from repro_torch.core.policies import ExecPolicy, resolve_device
from repro_torch.data import pipeline
from repro_torch.models import Model
from repro_torch.optim import adamw, gradflow
from repro_torch.train import step as tstep


def ode_demo(dev):
    print("=== 1. stiff ODE via the unified front-end (CVODE analog) ===")

    def f(t, y):  # Robertson chemical kinetics
        return torch.stack([
            -0.04 * y[0] + 1e4 * y[1] * y[2],
            0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
            3e7 * y[1] ** 2])

    # ExecPolicy + MemoryHelper + run-wide counters
    ctx = Context(policy=ExecPolicy(device=str(dev)))
    prob = IVP(f=f, y0=torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                                    device=dev))
    sol = integrate(prob, 0.0, 40.0, method="bdf", ctx=ctx,
                    opts=ctx.options(rtol=1e-6, atol=1e-10),
                    lin_solver=DenseGJ(), device=dev)
    st = sol.stats
    print(f"  y(40) = {[float(v) for v in sol.y]}")
    print(f"  steps={int(st.steps)} newton_iters={int(sol.nni)} "
          f"err_fails={int(st.netf)}  mass={float(torch.sum(sol.y)):.9f}")
    print(f"  lin_solver={sol.lin_solver}  "
          f"workspace={sol.workspace_bytes}B")
    return sol


def lm_demo(dev, steps=5):
    print("=== 2. LM training (AdamW, then gradient-flow ODE optimizer) ===")
    cfg = configs.get("internlm2-1.8b-smoke")
    model = Model(cfg)
    state = tstep.init_state(model, 0, device=dev)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                               global_batch=8)
    train = tstep.make_train_step(model)
    losses = []
    for i, b in zip(range(steps), pipeline.batches(dcfg)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
        print(f"  adamw step {i}: loss={losses[-1]:.4f}")
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(pipeline.batches(dcfg, steps)).items()}

    def lf(p):
        return model.loss(p, batch)

    with torch.no_grad():
        before = float(lf(state.params))
    p2, st = gradflow.step(lf, state.params,
                           gradflow.GradFlowConfig(tau=0.2, max_steps=8))
    with torch.no_grad():
        after = float(lf(p2))
    print(f"  gradflow: {int(st.steps)} adaptive ODE steps, "
          f"loss {before:.4f} -> {after:.4f}")
    return losses, before, after


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return ode_demo(dev), lm_demo(dev)


if __name__ == "__main__":
    main()
