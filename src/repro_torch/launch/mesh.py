"""The ensemble's device layout (counterpart of ``repro.launch.mesh``).

:func:`make_ensemble_mesh` is the port of ``make_ensemble_mesh``
(``src/repro/launch/mesh.py:27``): the 1-D ``("systems",)`` layout over
the ranks of the default process group, each rank advancing its shard
of the batch with no collective (the paper's one integrator per
stream).  Where the reference's single controller sees every device,
PyTorch runs one process per rank (SPMD): the layout is a
``torch.distributed.device_mesh.DeviceMesh`` over the default group,
and a single process that initialised no group is a world of one
(:class:`WorldOfOne`), which needs no ``init_process_group``.

Each rank's device (:func:`mesh_device`) is ``cuda:{local_rank %
device_count}``, ``local_rank`` the ``LOCAL_RANK`` environment variable
or else the rank: the card, unless the caller asks for ``"cpu"``.
Without CUDA a ``"cuda"`` layout raises, as
:func:`repro_torch.core.policies.resolve_device` does.

:func:`make_production_mesh` and :func:`make_debug_mesh` are the model
launchers' layouts (``src/repro/launch/mesh.py:13,19``): a
``DeviceMesh`` over the default group with the reference's shapes and
axis names.  Each needs a world of exactly its size and raises a
``ValueError`` naming that size otherwise; neither builds a smaller mesh
in its place.
"""
from __future__ import annotations

import os

import torch

from ..core.policies import resolve_device

AXIS = "systems"


class WorldOfOne:
    """The ``("systems",)`` layout of one process with no process group:
    the parts of ``DeviceMesh``'s interface the ensemble reads, and no
    communicator (``get_group()`` is None)."""

    mesh_dim_names = (AXIS,)

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None


def _initialised() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def make_ensemble_mesh(n_devices: int = 0, device_type: str = "cuda"):
    """The 1-D ``("systems",)`` layout over every rank of the default
    process group (``n_devices`` 0 or the world size), or a
    :class:`WorldOfOne` when no group is initialised.  ``device_type``
    ``"cuda"`` (the card; raises without CUDA) or ``"cpu"``."""
    resolve_device(device_type)
    if not _initialised():
        if n_devices not in (0, 1):
            raise ValueError(f"n_devices={n_devices}: no process group is "
                             f"initialised, so the world has one rank")
        return WorldOfOne(device_type)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices not in (0, world):
        raise ValueError(f"n_devices={n_devices}: the ensemble layout spans "
                         f"every rank of the default group ({world})")
    if device_type == "cuda":
        # the rank's card is the process's current device before the
        # layout (and any NCCL communicator of it) is set up
        torch.cuda.set_device(_rank_card())
    return init_device_mesh(device_type, (world,), mesh_dim_names=(AXIS,))


def _model_mesh(shape, names, device_type):
    import math
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    world = dist.get_world_size() if _initialised() else 1
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} {names} mesh needs "
                         f"a world of {need} ranks, not {world}")
    resolve_device(device_type)
    if not _initialised():
        raise ValueError(f"a {names} mesh needs an initialised process "
                         "group (init_process_group), even of one rank")
    if device_type == "cuda":
        torch.cuda.set_device(_rank_card())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 ``("data", "model")`` (256 ranks, one pod) or 2x16x16
    ``("pod", "data", "model")`` (512 ranks, two pods)."""
    if multi_pod:
        return _model_mesh((2, 16, 16), ("pod", "data", "model"),
                           device_type)
    return _model_mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, pod: int = 0,
                    device_type: str = "cuda"):
    """A small ``("data", "model")`` mesh, or ``("pod", "data",
    "model")`` with ``pod`` > 0, for tests and path R."""
    if pod:
        return _model_mesh((pod, n_data, n_model), ("pod", "data", "model"),
                           device_type)
    return _model_mesh((n_data, n_model), ("data", "model"), device_type)


def _rank_card() -> torch.device:
    """``cuda:{local_rank % device_count}``."""
    if _initialised():
        import torch.distributed as dist
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    else:
        local = 0
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: ``cuda:{local_rank %
    device_count}`` for a ``"cuda"`` layout (raises without CUDA), else
    the CPU."""
    dev = resolve_device(mesh.device_type)
    return _rank_card() if dev.type == "cuda" else dev
