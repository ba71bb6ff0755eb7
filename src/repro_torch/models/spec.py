"""Parameter specs: one source of truth for shape, dtype, axes and init.

The port's ``repro.models.spec``.  A model builds a nested dict of
:class:`ParamSpec`; from it come the materialised parameters
(:func:`init_params`), the abstract ones (:func:`abstract_params`,
``meta``-device tensors: shapes and dtypes, no storage) and the
logical-axes tree (:func:`axes_tree`).

:func:`init_params` draws from an explicit ``torch.Generator``, leaf by
leaf in the reference's order (sorted keys, depth first), with the
reference's distributions; its values differ from ``jax.random``'s, so
a test that compares the two packages carries the reference's weights
across (``interop.model_params_from_reference``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim
    dtype: Any = torch.float32
    init: str = "normal"                 # 'normal' | 'zeros' | 'ones' | 'scaled'
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys sorted, as
    ``jax.tree_util`` orders them); ``rest`` are trees of the same
    structure whose leaves go along."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """Nested dicts shaped as ``like`` whose leaves are ``leaves``, taken
    in :func:`tree_leaves` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _materialize(spec: ParamSpec, gen: torch.Generator, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "scaled":  # fan-in scaled normal
        fan_in = spec.shape[0] if spec.shape else 1
        std = (1.0 / max(fan_in, 1)) ** 0.5
    else:
        std = spec.scale
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(spec.dtype)


def init_params(specs, generator: torch.Generator, device=None,
                shardings=None) -> Any:
    """Materialise a spec tree on ``device`` (default: the generator's),
    drawing every leaf from ``generator``.  With ``shardings`` (a tree
    of ``parallel.sharding.NamedSharding``) each rank draws every leaf
    whole, the values of the unsharded init, and keeps its block: one
    whole leaf is alive at a time."""
    dev = torch.device(device) if device is not None else generator.device
    if shardings is None:
        return tree_map(lambda s: _materialize(s, generator, dev), specs)
    return tree_map(lambda s, sh: sh.shard(_materialize(s, generator, dev)),
                    specs, shardings)


def abstract_params(specs) -> Any:
    """The spec tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def axes_tree(specs) -> Any:
    return tree_map(lambda s: s.axes, specs)


def param_count(specs) -> int:
    total = 0
    for s in tree_leaves(specs):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
