"""Gradient-flow optimizer: training as an ODE, driven by the port's core.

The port's ``repro.optim.gradflow``: dθ/dt = -∇L(θ) advanced over a
pseudo-time ``tau`` by the adaptive embedded-pair ERK integrator
(``core.arkode.erk_integrate``), whose WRMS error control sets an
effective learning rate per step.  The parameter dict crosses to the
integrator as a tuple of float32 leaves in ``models.spec.tree_leaves``
order (the port's N_Vector is a tensor or a tuple) and back; every ERK
stage is one full gradient (``torch.autograd.grad``).  On the card the
integrator's vector ops are the port's kernels (rows 12 and 14);
``policy`` pins them as any ``ExecPolicy`` does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core import arkode, butcher
from ..core.arkode import ODEOptions
from ..core.policies import DEFAULT, ExecPolicy
from ..models.spec import tree_leaves, tree_unflatten


class GradFlowConfig(NamedTuple):
    tau: float = 1.0          # pseudo-time horizon per optimizer step
    rtol: float = 1e-3
    atol: float = 1e-6
    table: str = "heun_euler"  # embedded 2(1) pair: 2 grads per attempt
    max_steps: int = 20


def step(loss_fn: Callable, params, cfg: GradFlowConfig = GradFlowConfig(),
         policy: Optional[ExecPolicy] = None):
    """One gradient-flow step: integrate dtheta/dt = -grad L over tau.

    loss_fn: params -> scalar (batch already bound).
    Returns (new_params, stats) where stats is the integrator's.
    """
    def rhs(t, y):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in y]
            loss = loss_fn(tree_unflatten(params, leaves)).to(torch.float32)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return tuple(-g.to(torch.float32) for g in grads)

    table = butcher.ERK_TABLES[cfg.table]
    p32 = tuple(x.detach().to(torch.float32) for x in tree_leaves(params))
    y, stats = arkode.erk_integrate(
        rhs, p32, 0.0, cfg.tau, table,
        ODEOptions(rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
                   policy=DEFAULT if policy is None else policy))
    new_params = tree_unflatten(params, [
        x.to(ref.dtype) for x, ref in zip(y, tree_leaves(params))])
    return new_params, stats
