"""Fault-tolerant checkpointing: atomic, sharded, resumable.

The port's ``repro.train.checkpoint``, writing the reference's on-disk
format exactly, so that a checkpoint written by either package restores
in the other:

* every process writes ONLY its addressable shards (here: one process,
  the structure is process-indexed so multi-host simply fans out);
* writes go to ``step_<N>.tmp<process>/`` and are renamed to
  ``step_<N>/`` atomically — a crashed writer never corrupts the latest
  checkpoint;
* ``latest_step`` scans for complete checkpoints only (rename is the
  commit point), so restart-after-failure always finds a good one;
* leaves are stored as .npy keyed by the flattened tree path as the
  reference's ``jax.tree_util`` prints it (a NamedTuple field as
  ``.name``, a dict key as itself, a tuple index as its number, joined
  by ``__``; dict keys sorted); metadata (step, tree structure hash,
  process index, dtypes) in meta.json;
* a bfloat16 leaf is stored as its ``uint16`` bit pattern with dtype
  string ``"bfloat16"`` (numpy has no bfloat16 of its own).

A tree is nested dicts, NamedTuples, tuples and lists of tensors.

A sharded tree (each rank's local shards, ``shardings=`` their
``parallel.sharding`` layouts) is saved in the same format, with no
collective: every rank calls :func:`save`, rank 0 lays out each leaf's
``.npy`` file at its global shape, each block's first replica writes
its block into the file (memory-mapped: one shared directory, as the
ranks of one host have), and rank 0 commits; either package restores it
as an unsharded tree.  :func:`restore` with ``shardings=`` reads each
leaf's file memory-mapped and keeps this rank's block.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..core.policies import resolve_device
from ..parallel import collectives as coll

#: torch dtype -> the numpy dtype name the reference records
_NP_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
             torch.float32: "float32", torch.float64: "float64",
             torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
             torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_OF = {v: k for k, v in _NP_NAMES.items()}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_path(tree, path=()):
    """[(path, leaf)] in ``jax.tree_util.tree_leaves_with_path`` order;
    a path entry is ``.name``, a dict key or a sequence index."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaves_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in _leaves_with_path(getattr(tree, name),
                                              path + (f".{name}",))]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree)
                for item in _leaves_with_path(x, path + (str(i),))]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(tree, vals):
    it = iter(vals)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    return build(tree)


def _leaf_key(path) -> str:
    return "__".join(path) or "leaf"


def _np_name(dtype: torch.dtype) -> str:
    return _NP_NAMES[dtype]


def _fingerprint_of(leaves) -> str:
    keys = [_leaf_key(p) + ":" + str(tuple(leaf.shape)) + ":" +
            _np_name(leaf.dtype) for p, leaf in leaves]
    return hashlib.sha256("|".join(keys).encode()).hexdigest()[:16]


def _tree_fingerprint(tree) -> str:
    return _fingerprint_of(_leaves_with_path(tree))


def _to_savable(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    return t.numpy(), _np_name(t.dtype)


def _from_saved(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str == "bfloat16" and arr.dtype == np.uint16:
        # a copy: ``arr`` may be a read-only memory map of the file
        return torch.from_numpy(np.array(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_str)))


def _sharding_leaves(shardings, n: int) -> list:
    if shardings is None:
        return [None] * n
    out = [s for _, s in _leaves_with_path(shardings)]
    if len(out) != n:
        raise ValueError(f"{len(out)} shardings for {n} leaves")
    return out


def save(tree: Any, ckpt_dir: str, step: int,
         process_index: int = 0, shardings: Any = None) -> str:
    """Atomic save of (this process's view of) the tree; with
    ``shardings``, of the sharded tree's global value (every rank calls
    it; each writes its blocks, rank 0 commits)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    leaves = _leaves_with_path(tree)
    shs = _sharding_leaves(shardings, len(leaves))
    sharded = any(s is not None for s in shs)
    writer = not sharded or torch.distributed.get_rank() == 0
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    dtypes, whole = {}, []
    for (path, leaf), sh in zip(leaves, shs):
        key = _leaf_key(path)
        shape = tuple(leaf.shape) if sh is None else \
            sh.global_shape(leaf.shape)
        whole.append((path, torch.empty(shape, dtype=leaf.dtype,
                                        device="meta")))
        dtypes[key] = _np_name(leaf.dtype)
        if not sharded:
            savable, dtypes[key] = _to_savable(leaf)
            np.save(os.path.join(tmp, key + ".npy"), savable)
        elif writer:
            np.lib.format.open_memmap(
                os.path.join(tmp, key + ".npy"), mode="w+", shape=shape,
                dtype=np.uint16 if leaf.dtype == torch.bfloat16 else
                np.dtype(_np_name(leaf.dtype)))
    if sharded:
        coll.barrier()
        for (path, leaf), sh in zip(leaves, shs):
            if sh.is_primary():
                mm = np.load(os.path.join(tmp, _leaf_key(path) + ".npy"),
                             mmap_mode="r+")
                mm[sh.block(mm.shape)] = _to_savable(leaf)[0]
                mm.flush()
                del mm
        coll.barrier()
        if not writer:
            coll.barrier()
            return final
    meta = {"step": step, "fingerprint": _fingerprint_of(whole),
            "n_leaves": len(leaves), "process_index": process_index,
            "dtypes": dtypes}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    # commit point
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if sharded:
        coll.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest committed (fully renamed) checkpoint step, else None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(abstract_tree: Any, ckpt_dir: str, step: int,
            shardings: Any = None, device=None) -> Any:
    """Load into the abstract tree's structure (tensors, ``meta`` ones
    included, giving the global shapes and dtypes) on ``device``
    (default the card); verify the fingerprint.  ``shardings``: each
    leaf's layout, of which this rank loads its block."""
    dev = resolve_device(device)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    fp = _tree_fingerprint(abstract_tree)
    if meta["fingerprint"] != fp:
        raise ValueError(
            f"checkpoint fingerprint {meta['fingerprint']} != expected {fp}"
            " — model/optimizer structure changed since save")
    vals = []
    leaves = _leaves_with_path(abstract_tree)
    for (path, leaf), sh in zip(leaves,
                                _sharding_leaves(shardings, len(leaves))):
        key = _leaf_key(path)
        arr = np.load(os.path.join(final, key + ".npy"), mmap_mode="r")
        if sh is not None:
            arr = arr[sh.block(arr.shape)]
        t = _from_saved(arr, meta["dtypes"][key])
        vals.append(t.to(device=dev, dtype=leaf.dtype))
    return _unflatten(abstract_tree, vals)


def prune(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
