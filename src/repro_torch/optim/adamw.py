"""From-scratch AdamW with global-norm clipping.

The port's ``repro.optim.adamw``.  States are zeros shaped as the
params, on their device, in ``moment_dtype`` (bf16 moments halve
optimizer memory).  :func:`update` runs leaf by leaf in
``models.spec.tree_leaves`` order (dict keys sorted, as the reference's
``jax.tree_util`` orders them), with the reference's op order and scalar
types, and writes the new moments and parameters in place under
``torch.no_grad()``: the port's counterpart of the reference's state
donation.  Its statistics stay 0-d device tensors (no host read).

The global norm is the N_Vector dot of the float32 gradients
(``core.dispatch.dot``, row 16's kernel on the card), one leaf at a time
so that only one leaf's float32 cast is alive at once, the per-leaf dots
summed in leaf order as the reference's ``vector.dot`` sums them.

Over a mesh (``shardings``: each leaf's ``parallel.sharding``
layout) the gradients, moments and parameters are this rank's local
shards: row 16 runs on each local shard, a leaf replicated over some
axes counts once (only its first replica adds its dot), and one
all_reduce over the mesh sums the ranks' totals; the update runs on the
local shards in place.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..core import dispatch
from ..models.spec import tree_leaves, tree_map
from ..parallel import collectives as coll


#: the global norm's dtype (the reference's float32 gradients)
f32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _const(like: torch.Tensor, value) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device, filled there (no copy
    from the host, so no wait for the device); a divisor as a tensor, as
    the card divides by a host scalar through its reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay (the production default); float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / _const(step, max(cfg.warmup_steps, 1)),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / _const(
        step, max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree, shardings=None):
    """sqrt(sum ||g||^2): the sum of the leaves' float32 dots, in order;
    over a mesh, of the local shards' dots, each block once, summed over
    the ranks."""
    leaves = tree_leaves(tree)
    sh = tree_leaves(shardings) if shardings is not None else None
    total = None
    for i, g in enumerate(leaves):
        if sh is not None and not sh[i].is_primary():
            continue
        g32 = g.to(f32)
        d = dispatch.dot(g32, g32)
        total = d if total is None else total + d
    if sh is not None:
        if total is None:
            total = _const(leaves[0], 0.0)
        comm = coll.comm_of(sh[0].mesh)
        total = coll.all_reduce(total, comm, comm.names)
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: AdamWState, params,
           cfg: AdamWConfig = AdamWConfig(), shardings=None):
    """Returns (params, state, stats), the params and the state's tensors
    updated in place; stats ``{"grad_norm", "lr"}`` are 0-d tensors.
    ``shardings``: the params' layouts when they are local shards."""
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(
        _const(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    state.step.add_(1)
    lr = schedule(cfg, state.step)
    stepf = state.step.to(torch.float32)
    b1c = 1 - torch.pow(_const(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(_const(stepf, cfg.b2), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        gf = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * gf
        v32 = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * gf * gf
        del gf
        mhat = m32 / b1c
        vhat = v32 / b2c
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        del mhat, vhat
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
