"""Problem and solver data carried between the JAX package and the port.

The system has no model weights: what must reach the port identically
is the problem's data (per-system rate constants, the Brusselator's
configuration), the solver's options and the methods' coefficients
(Butcher tables, IMEX pairs).  All cross as plain
numbers and numpy arrays, so this module imports neither package.  A
``jac_sparsity`` pattern needs nothing here: it is the same (n, n)
numpy bool array in both packages, and the port encodes it with its
own copy of the reference's host code (``core/spsolve.py``), so a test
hands the one array to both; a ``SparseCSR`` crosses as its values and
pattern (:func:`csr_from_reference`).  A warm-start ``SolverSession``
crosses as a dict of its numpy leaves (:func:`session_from_reference`,
:func:`session_to_numpy`): the solver state a client carries from one
coupling step to the next, the system's counterpart of weights.

The model stack's weights cross the same way: an ``ArchConfig`` as its
``dataclasses.asdict`` with ``dtype`` by name
(:func:`arch_config_from_reference`), a parameter tree and a decode
cache as nested dicts of numpy leaves under the reference's keys
(:func:`model_params_from_reference`, :func:`cache_from_reference`,
:func:`cache_to_numpy`), and a training state as
``{"params": ..., "opt": {"step", "m", "v"}}`` of numpy leaves
(:func:`train_state_from_reference`, :func:`train_state_to_numpy`).  A
bfloat16 leaf crosses through float32, which holds every bfloat16 value
exactly.  A sharded state (each rank's local shards) crosses gathered
(``train_state_to_numpy(state, shardings)``, every rank calling it), and
a numpy tree reaches one rank as its shards (``shardings=`` of
:func:`model_params_from_reference` and
:func:`train_state_from_reference`), so the JAX package's weights and
state reach a sharded port.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.brusselator import BrusselatorConfig
from .core.arkode import ODEOptions
from .core.batched import SolverSession
from .core.butcher import ButcherTable, IMEXTable
from .core.controller import ControllerConfig
from .core.sunmatrix import SparseCSR
from .models.config import ArchConfig
from .models.spec import tree_map
from .parallel import collectives as coll


def params_from_numpy(params: dict, *, device, dtype=torch.float64) -> dict:
    """``{"k1","k2","k3",...}`` numpy arrays (the reference serving
    families' per-system params, each ``(nsys,)``) -> tensors."""
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params.items()}


def options_from_reference(fields: dict) -> ODEOptions:
    """The port's ODEOptions from the reference's
    ``ODEOptions._asdict()`` values, with ``controller`` as a nested dict
    (``ControllerConfig._asdict()``).  The reference's ``policy`` is a
    JAX-side choice with no counterpart here and is refused."""
    if "policy" in fields:
        raise ValueError("options_from_reference takes no 'policy': pick the "
                         "port's ExecPolicy separately")
    fields = dict(fields)
    if "controller" in fields:
        fields["controller"] = ControllerConfig(**fields["controller"])
    return ODEOptions(**fields)


def table_from_reference(fields: dict) -> ButcherTable:
    """The port's ButcherTable from the reference's
    ``ButcherTable._asdict()`` (nested lists of floats, ints for the
    orders); every coefficient keeps its float value exactly."""
    def floats(v):
        return None if v is None else [
            floats(x) if isinstance(x, (list, tuple)) else float(x)
            for x in v]

    return ButcherTable(A=floats(fields["A"]), b=floats(fields["b"]),
                        c=floats(fields["c"]), order=int(fields["order"]),
                        b_emb=floats(fields.get("b_emb")),
                        emb_order=int(fields.get("emb_order", 0)))


def imex_table_from_reference(fields: dict) -> IMEXTable:
    """The port's IMEXTable from the reference's ``IMEXTable._asdict()``,
    its ``expl`` and ``impl`` given as ``ButcherTable._asdict()`` dicts
    (or anything with ``_asdict``)."""
    def table(t):
        return table_from_reference(t._asdict() if hasattr(t, "_asdict")
                                    else t)

    return IMEXTable(expl=table(fields["expl"]), impl=table(fields["impl"]),
                     order=int(fields["order"]),
                     emb_order=int(fields["emb_order"]))


def brusselator_config_from_reference(fields: dict) -> BrusselatorConfig:
    """The port's BrusselatorConfig from the reference's, given as
    ``dataclasses.asdict(cfg)``."""
    return BrusselatorConfig(**fields)


def csr_from_reference(data, indptr, indices, shape, *,
                       device) -> SparseCSR:
    """The port's :class:`~repro_torch.core.sunmatrix.SparseCSR` from
    the reference's, given as its ``data`` (a numpy array) and its
    ``indptr``, ``indices`` (tuples or integer arrays) and ``shape``."""
    return SparseCSR.from_pattern(indptr, indices, shape,
                                  data=torch.tensor(np.asarray(data)),
                                  device=device)


def solution_to_numpy(sol) -> dict:
    """A Solution's state, status and per-system stats as numpy arrays."""
    out = {"y": sol.y, "retcodes": sol.retcodes, "ok": sol.ok}
    out.update({f"stats.{k}": v for k, v in sol.stats._asdict().items()})
    return {k: v.detach().cpu().numpy() for k, v in out.items()
            if v is not None}


def session_from_reference(leaves: dict, *, device) -> SolverSession:
    """The port's :class:`~repro_torch.core.batched.SolverSession` from
    the reference's, given as ``{name: numpy array}`` of its fields
    (``SolverSession._asdict()``): dtypes kept, the system axis last."""
    return SolverSession(**{
        k: torch.tensor(np.asarray(leaves[k]), device=device)
        for k in SolverSession._fields})


def session_to_numpy(session: SolverSession) -> dict:
    """A session's leaves as numpy arrays (the reference takes them back
    as ``SolverSession(**{k: jnp.asarray(v) ...})``)."""
    return {k: v.detach().cpu().numpy()
            for k, v in session._asdict().items()}


def arch_config_from_reference(fields: dict) -> ArchConfig:
    """The port's ArchConfig from the reference's
    ``dataclasses.asdict(cfg)``, with ``dtype`` given by its name
    (``"bfloat16"``, ``"float32"``)."""
    fields = dict(fields)
    if "dtype" in fields:
        fields["dtype"] = getattr(torch, str(fields["dtype"]))
    return ArchConfig(**fields)


def _leaf(a, *, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bfloat16 of its own
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def model_params_from_reference(tree: dict, model, *, device,
                                shardings=None) -> dict:
    """The port's parameters from the reference's ``Model(cfg).init(...)``
    as nested dicts of numpy leaves: copied key for key and shape for
    shape into ``model``'s spec tree, each leaf in its spec's dtype;
    with ``shardings`` (``model.param_shardings(pctx)``) this rank's
    blocks."""
    specs = model.specs()
    _same_keys(specs, tree)
    shs = shardings if shardings is not None else tree_map(
        lambda s: None, specs)

    def copy(spec, a, sh):
        if tuple(np.shape(a)) != tuple(spec.shape):
            raise ValueError(f"reference leaf of shape {np.shape(a)}, spec "
                             f"{spec.shape}")
        return _leaf(_block(a, sh), device=device, dtype=spec.dtype)

    return tree_map(copy, specs, tree, shs)


def _block(a, sh):
    a = np.asarray(a)
    return a if sh is None else a[sh.block(a.shape)]


def _same_keys(a, b, where="params"):
    if isinstance(a, dict) != isinstance(b, dict):
        raise ValueError(f"{where}: a leaf against a subtree")
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"{where}: keys {sorted(a)} against "
                             f"{sorted(b)}")
        for k in a:
            _same_keys(a[k], b[k], f"{where}.{k}")


def cache_from_reference(tree: dict, *, device) -> dict:
    """A decode cache from the reference's (nested dicts of numpy leaves,
    ``pos`` included), dtypes kept."""
    return tree_map(lambda a: _leaf(a, device=device), tree)


def cache_to_numpy(caches: dict) -> dict:
    """A decode cache as nested dicts of numpy leaves (bfloat16 leaves as
    float32)."""
    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(to_np, caches)


def train_state_from_reference(tree: dict, model, *, device,
                               shardings=None):
    """The port's ``train.step.TrainState`` from the reference's, given as
    ``{"params": params, "opt": {"step": ..., "m": ..., "v": ...}}`` of
    numpy leaves: the params in ``model``'s spec dtypes, ``step`` as
    int32, the moments in their own dtypes (a bfloat16 leaf as
    bfloat16); with ``shardings`` (``train.step.state_shardings``) this
    rank's shards."""
    from .optim.adamw import AdamWState
    from .train.step import TrainState
    ps = None if shardings is None else shardings.params
    params = model_params_from_reference(tree["params"], model,
                                         device=device, shardings=ps)
    opt = tree["opt"]
    _same_keys(tree["params"], opt["m"], "opt.m")
    _same_keys(tree["params"], opt["v"], "opt.v")
    if ps is None:
        ps = tree_map(lambda a: None, tree["params"])

    def moment(a, sh):
        return _leaf(_block(a, sh), device=device)

    return TrainState(params=params, opt=AdamWState(
        step=torch.tensor(np.asarray(opt["step"]), dtype=torch.int32,
                          device=device),
        m=tree_map(moment, opt["m"], ps), v=tree_map(moment, opt["v"], ps)))


def _gathered(state, shardings):
    """A sharded TrainState's global value (every rank calls it)."""
    from .train.step import TrainState
    from .optim.adamw import AdamWState
    ps = shardings.params
    comm = coll.comm_of(shardings.opt.step.mesh)

    def full(t, sh):
        return coll.gather_full(t.detach(), comm, sh.dim_axes(t.dim()))

    return TrainState(
        params=tree_map(full, state.params, ps),
        opt=AdamWState(step=state.opt.step,
                       m=tree_map(full, state.opt.m, ps),
                       v=tree_map(full, state.opt.v, ps)))


def train_state_to_numpy(state, shardings=None) -> dict:
    """A TrainState as ``{"params", "opt": {"step", "m", "v"}}`` of numpy
    leaves (bfloat16 leaves as float32, ``step`` as int32); a sharded
    state (``shardings``) gathered."""
    if shardings is not None:
        state = _gathered(state, shardings)
    return {"params": cache_to_numpy(state.params),
            "opt": {"step": np.asarray(state.opt.step.detach().cpu().numpy(),
                                       dtype=np.int32),
                    "m": cache_to_numpy(state.opt.m),
                    "v": cache_to_numpy(state.opt.v)}}
