"""Training step: loss -> grad -> (accumulate) -> AdamW.

The port's ``repro.train.step``.  ``make_train_step`` builds the
canonical step:

* gradients from ``torch.autograd.grad`` of the model's loss with
  respect to detached views of the parameters (nothing accumulates in
  ``.grad``);
* optional microbatch accumulation: each microbatch's gradient (in the
  parameters' dtype) is cast to float32 and summed in float32, as the
  reference's ``lax.scan`` sums it, then scaled by ``1/microbatches``;
* grads/loss in float32, params in ``cfg.dtype`` (bf16);
* the AdamW update writes the parameters and moments in place, the
  port's counterpart of the reference's state donation: the state passed
  in is the state returned.

Over a mesh (``pctx.mesh``) the state holds this rank's shards
(``init_state(..., shardings=state_shardings(model, pctx))``), every
rank calls ``train(state, batch)`` with the global batch, and each
gradient comes back in its parameter's layout: its FSDP dims
reduce-scattered in the backward, then summed over the data-parallel
axes it is replicated over (``models.sharded.Layout.reduce_grads``) —
the reference's ``grad_shardings`` constraint.  ``grad_shardings=``,
when given, must be that layout.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.spec import tree_leaves, tree_map, tree_unflatten
from ..models.transformer import Model, ParallelCtx
from ..optim import adamw
from ..parallel import sharding as shd


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(model: Model, generator,
               ocfg: adamw.AdamWConfig = adamw.AdamWConfig(), device=None,
               shardings=None):
    """Parameters drawn from ``generator`` (a ``torch.Generator``, or an
    int seeding one on ``device``, default the card) and zero moments;
    with ``shardings`` (:func:`state_shardings`) this rank's shards of
    the same state."""
    params = model.init(generator, device=device,
                        shardings=None if shardings is None
                        else shardings.params)
    return TrainState(params=params, opt=adamw.init(params, ocfg))


def value_and_grad(loss_fn, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``; the loss
    detached, each gradient in its parameter's dtype."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, pctx: ParallelCtx = ParallelCtx(),
                    ocfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    microbatches: int = 1, grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place and the metrics are 0-d float32 device
    tensors (``loss``, ``grad_norm``, ``lr``)."""
    lay = None
    if pctx.mesh is not None:
        lay = model.layout(pctx)
        if grad_shardings is not None and tree_leaves(grad_shardings) != \
                tree_leaves(lay.shardings):
            raise ValueError("grad_shardings differ from the parameters' "
                             "layout on the mesh")
    elif grad_shardings is not None:
        raise ValueError("grad_shardings without a mesh (pctx.mesh)")

    def loss_fn(params, batch):
        return model.loss(params, batch, pctx)

    def compute_grads(params, batch):
        if microbatches <= 1:
            return value_and_grad(loss_fn, params, batch)
        b = next(iter(batch.values())).shape[0]
        assert all(x.shape[0] == b for x in batch.values())
        assert b % microbatches == 0
        per = b // microbatches
        first = tree_leaves(params)[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=first.device)
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(microbatches):
            mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
            loss, g = value_and_grad(loss_fn, params, mb)
            loss_sum = loss_sum + loss
            for a, gl in zip(tree_leaves(g_sum), tree_leaves(g)):
                a.add_(gl.to(torch.float32))
            del g
        inv = 1.0 / microbatches
        for a in tree_leaves(g_sum):
            a.mul_(inv)
        return loss_sum * inv, g_sum

    def train_step(state: TrainState, batch):
        loss, grads = compute_grads(state.params, batch)
        if lay is not None:
            grads = lay.reduce_grads(grads)
        new_params, new_opt, ostats = adamw.update(
            grads, state.opt, state.params, ocfg,
            None if lay is None else lay.shardings)
        metrics = {"loss": loss.to(torch.float32), **ostats}
        return TrainState(new_params, new_opt), metrics

    return train_step


def abstract_state(model: Model,
                   ocfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """The TrainState as ``meta`` tensors (shapes and dtypes, no storage)."""
    aparams = model.abstract_params()

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return TrainState(
        params=aparams,
        opt=adamw.AdamWState(step=meta((), torch.int32),
                             m=tree_map(lambda p: meta(
                                 p.shape, ocfg.moment_dtype), aparams),
                             v=tree_map(lambda p: meta(
                                 p.shape, ocfg.moment_dtype), aparams)))


def state_shardings(model: Model, pctx: ParallelCtx):
    """The TrainState's layouts on ``pctx.mesh``: the moments follow the
    params, the step is replicated."""
    ps = model.param_shardings(pctx)
    return TrainState(params=ps, opt=adamw.AdamWState(
        step=shd.NamedSharding(pctx.mesh, ()), m=ps, v=ps))


def state_axes(model: Model):
    """Logical-axes tree matching abstract_state (opt follows params)."""
    paxes = model.param_axes()
    return TrainState(
        params=paxes,
        opt=adamw.AdamWState(step=(), m=paxes, v=paxes))
