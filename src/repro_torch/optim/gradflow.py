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

Over a mesh (``layout``, a ``models.sharded.Layout``) each rank holds
its shards of the parameters and every rank passes the global batch to
``loss_fn`` (the sharded loss): each stage's gradient comes back in the
parameters' layout (``Layout.reduce_grads``), the stage sums stay local
to each rank's shards (row 12), and the error test's WRMS norm is global
(:func:`mesh_norm`): row 14 on each rank's shards, a block replicated
over some axes counted on its first replica only, then one all_reduce
over the mesh, over the global element count.  Every rank so takes the
same steps as one device would.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core import arkode, butcher
from ..core import dispatch as dv
from ..core.arkode import ODEOptions
from ..core.policies import DEFAULT, ExecPolicy
from ..models.spec import tree_leaves, tree_unflatten
from ..parallel import collectives as coll


class GradFlowConfig(NamedTuple):
    tau: float = 1.0          # pseudo-time horizon per optimizer step
    rtol: float = 1e-3
    atol: float = 1e-6
    table: str = "heun_euler"  # embedded 2(1) pair: 2 grads per attempt
    max_steps: int = 20


def mesh_norm(shardings):
    """The WRMS norm ``(v, w, policy) -> 0-d tensor`` of a tuple of local
    shards laid out by ``shardings`` (a tree of ``NamedSharding``, in
    ``tree_leaves`` order): ``dispatch.wrms_ss`` (row 14) on each block's
    first replica, summed, one all_reduce over every mesh axis, over the
    global element count."""
    sh = tree_leaves(shardings)
    primary = [s.is_primary() for s in sh]
    comm = coll.comm_of(sh[0].mesh)

    def norm(v, w, policy=None):
        total = None
        for x, wx, first in zip(v, w, primary):
            if first:
                d = dv.wrms_ss(x, wx, policy)
                total = d if total is None else total + d
        if total is None:
            total = torch.zeros((), dtype=v[0].dtype, device=v[0].device)
        total = coll.all_reduce(total, comm, comm.names)
        n = sum(math.prod(s.global_shape(x.shape)) for x, s in zip(v, sh))
        return torch.sqrt(total / n)

    return norm


def step(loss_fn: Callable, params, cfg: GradFlowConfig = GradFlowConfig(),
         policy: Optional[ExecPolicy] = None, layout=None):
    """One gradient-flow step: integrate dtheta/dt = -grad L over tau.

    loss_fn: params -> scalar (batch already bound).  ``layout``: the
    ``models.sharded.Layout`` of ``params`` when they are this rank's
    shards on a mesh (every rank calls ``step``).
    Returns (new_params, stats) where stats is the integrator's.
    """
    def rhs(t, y):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in y]
            loss = loss_fn(tree_unflatten(params, leaves)).to(torch.float32)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if layout is not None:
            grads = tree_leaves(layout.reduce_grads(
                tree_unflatten(params, list(grads))))
        return tuple(-g.to(torch.float32) for g in grads)

    table = butcher.ERK_TABLES[cfg.table]
    p32 = tuple(x.detach().to(torch.float32) for x in tree_leaves(params))
    y, stats = arkode.erk_integrate(
        rhs, p32, 0.0, cfg.tau, table,
        ODEOptions(rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
                   policy=DEFAULT if policy is None else policy),
        norm=None if layout is None else mesh_norm(layout.shardings))
    new_params = tree_unflatten(params, [
        x.to(ref.dtype) for x, ref in zip(y, tree_leaves(params))])
    return new_params, stats
