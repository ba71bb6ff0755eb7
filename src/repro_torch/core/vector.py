"""N_Vector functions that the reference does not dispatch.

Counterpart of ``repro.core.vector`` (``vector.py:51-265``): the
streaming ops ``const_like``, ``prod``, ``div``, ``scale``, ``vabs``,
``inv``, ``add_const``, ``compare`` and the reductions ``max_norm``,
``vmin``, ``l1_norm``, ``wl2_norm``, ``constr_mask``, ``min_quotient``,
``inv_test``, plus ``tree_size``.  A vector is a tensor or a tuple of
tensors (the reference's pytrees); streaming ops map over the leaves and
reductions combine them in leaf order, as the reference does.  They are
plain tensor code in the reference too; the hot ops that have kernels
(``linear_combination``, ``dot``, ``wrms_norm``, ...) are
:mod:`repro_torch.core.dispatch`'s.

The paper's §4 vectors (reference ``vector.py:266-399``):
:class:`MeshVector`, the MPIPlusX analog, a node-local vector with a
communicator whose every reduction ends in one collective; and
:func:`many_vector`, the ManyVector, which is the tuple of its
subvectors (the port's vector form already).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch


def tmap(f, *vs):
    if isinstance(vs[0], tuple):
        return tuple(f(*ls) for ls in zip(*vs))
    return f(*vs)


def leaves(v) -> list:
    """The tensors of a vector, in order."""
    return list(v) if isinstance(v, tuple) else [v]


def _keep_dtype(out: torch.Tensor, *operands) -> torch.Tensor:
    """SUNDIALS realtype semantics: a result keeps its operands' dtype
    (a float64 coefficient does not upcast a float32 state)."""
    want = functools.reduce(torch.promote_types, (t.dtype for t in operands))
    return out if out.dtype == want else out.to(want)


def tree_size(x) -> int:
    """The number of elements over every leaf."""
    return sum(leaf.numel() for leaf in leaves(x))


def const_like(c, x):
    """z_i = c   (N_VConst)."""
    return tmap(lambda xl: torch.full_like(xl, c), x)


def prod(x, y):
    """z = x .* y   (N_VProd)."""
    return tmap(torch.mul, x, y)


def div(x, y):
    """z = x ./ y   (N_VDiv)."""
    return tmap(torch.div, x, y)


def scale(c, x):
    """z = c*x   (N_VScale)."""
    return tmap(lambda xl: _keep_dtype(c * xl, xl), x)


def vabs(x):
    """z = |x|   (N_VAbs)."""
    return tmap(torch.abs, x)


def inv(x):
    """z = 1./x   (N_VInv)."""
    return tmap(lambda xl: 1.0 / xl, x)


def add_const(x, b):
    """z = x + b   (N_VAddConst)."""
    return tmap(lambda xl: _keep_dtype(xl + b, xl), x)


def compare(c, x):
    """z_i = 1 if |x_i| >= c else 0   (N_VCompare)."""
    return tmap(lambda xl: (xl.abs() >= c).to(xl.dtype), x)


def _reduce(per_leaf, combine, x, init):
    acc = init
    for leaf in leaves(x):
        acc = combine(acc, per_leaf(leaf))
    return acc


def _scalar(value, x) -> torch.Tensor:
    """A 0-d tensor of ``value`` in the result type of x's leaves, on
    their device."""
    ls = leaves(x)
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ls))
    return torch.full((), value, dtype=dtype, device=ls[0].device)


def max_norm(x) -> torch.Tensor:
    """max |x_i|   (N_VMaxNorm)."""
    return _reduce(lambda l: l.abs().max(), torch.maximum, x, _scalar(0.0, x))


def vmin(x) -> torch.Tensor:
    """min x_i   (N_VMin)."""
    return _reduce(torch.min, torch.minimum, x, _scalar(float("inf"), x))


def l1_norm(x) -> torch.Tensor:
    """sum |x_i|   (N_VL1Norm)."""
    return _reduce(lambda l: l.abs().sum(), torch.add, x, _scalar(0.0, x))


def _sum_sq(x) -> torch.Tensor:
    return _reduce(lambda l: (l * l).sum(), torch.add, x, _scalar(0.0, x))


def wl2_norm(x, w) -> torch.Tensor:
    """sqrt( sum (x_i w_i)^2 )   (N_VWL2Norm)."""
    return torch.sqrt(_sum_sq(prod(x, w)))


def constr_mask(c, x):
    """N_VConstrMask: ``(all_ok, mask of violations)``.

    c_i =  2 : x_i >  0 required;  1 : x_i >= 0;  0 : none;
    c_i = -1 : x_i <= 0;          -2 : x_i <  0.
    """
    def leaf(cl, xl):
        viol = torch.where(cl.abs() > 1.5, xl * cl <= 0.0,
                           (cl.abs() > 0.5) & (xl * cl < 0.0))
        return viol.to(xl.dtype)

    m = tmap(leaf, c, x)
    return l1_norm(m) == 0, m


def min_quotient(num, den) -> torch.Tensor:
    """min num_i/den_i over den_i != 0   (N_VMinQuotient)."""
    def leaf(nl, dl):
        nz = dl != 0
        return torch.where(nz, nl / torch.where(nz, dl, 1.0),
                           float("inf")).min()

    acc = _scalar(float("inf"), num)
    for nl, dl in zip(leaves(num), leaves(den)):
        acc = torch.minimum(acc, leaf(nl, dl))
    return acc


def inv_test(x):
    """N_VInvTest: z = 1/x where x != 0; returns ``(no_zero_found, z)``."""
    def leaf(xl):
        nz = xl != 0
        return torch.where(nz, 1.0 / torch.where(nz, xl, 1.0), 0.0)

    z = tmap(leaf, x)
    has_zero = functools.reduce(torch.logical_or,
                                ((l == 0).any() for l in leaves(x)))
    return ~has_zero, z


# ---------------------------------------------------------------------------
# MeshVector — the MPIPlusX analog.
# ---------------------------------------------------------------------------

MODES = ("gspmd", "explicit")


@dataclass(frozen=True)
class MeshVectorSpec:
    """Pairs node-local vector data with a communicator for global
    reductions (reference ``vector.py:266``).

    ``comm`` is the "MPI communicator": a ``torch.distributed``
    ``ProcessGroup`` or a 1-D ``DeviceMesh`` over the ranks that hold
    this vector's shards; None issues no collective (the reference's
    empty ``axis_names``).  Streaming ops never touch it.

    ``mode`` is ``"explicit"``, the literal MPIPlusX form: ``data`` is
    this rank's shard, and each reduction computes its node-local
    partial, then issues exactly one ``all_reduce`` (SUM, MAX or MIN)
    over ``comm``.  Or ``"gspmd"``: ``data`` holds the whole vector, a
    tensor or a ``DTensor`` sharded ``Shard(0)`` (PyTorch's sharding
    propagation then inserts the collective, as GSPMD does), and a
    reduction returns the op's value as it is.

    ``policy`` selects the node-local implementations through
    :mod:`repro_torch.core.dispatch` (None: the default
    ``ExecPolicy()``, the kernels on the card); a ``DTensor`` runs only
    under ``ExecPolicy(backend="torch")``.
    """

    comm: Any = None
    mode: str = "gspmd"
    policy: Optional[Any] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown MeshVector mode {self.mode!r}; "
                             f"valid: {', '.join(MODES)}")


class MeshVector:
    """MPIPlusX analog: node-local data + a communicator.

    In ``"explicit"`` mode every rank of ``spec.comm`` calls each
    reduction, in the same order: the node-local partial, then exactly
    one collective, as MPIPlusX runs the node-local op then
    ``MPI_Allreduce``.
    """

    def __init__(self, data, spec: MeshVectorSpec = MeshVectorSpec()):
        self.data = data
        self.spec = spec

    def wrap(self, data) -> "MeshVector":
        return MeshVector(data, self.spec)

    def _dv(self):
        # function-level import: dispatch imports this module
        from . import dispatch
        return dispatch

    # -- streaming ops: purely node-local ---------------------------------
    def linear_sum(self, a, b, other: "MeshVector") -> "MeshVector":
        return self.wrap(self._dv().linear_sum(a, self.data, b, other.data,
                                               self.spec.policy))

    def scale(self, c) -> "MeshVector":
        return self.wrap(scale(c, self.data))

    def const(self, c) -> "MeshVector":
        return self.wrap(const_like(c, self.data))

    def prod(self, other: "MeshVector") -> "MeshVector":
        return self.wrap(prod(self.data, other.data))

    def div(self, other: "MeshVector") -> "MeshVector":
        return self.wrap(div(self.data, other.data))

    def abs(self) -> "MeshVector":
        return self.wrap(vabs(self.data))

    def inv(self) -> "MeshVector":
        return self.wrap(inv(self.data))

    def add_const(self, b) -> "MeshVector":
        return self.wrap(add_const(self.data, b))

    # -- reductions: node-local partial + one collective -------------------
    def _finish(self, partial: torch.Tensor, op: str) -> torch.Tensor:
        """``partial`` (a fresh 0-d tensor) reduced over ``spec.comm`` in
        place in explicit mode; as it is otherwise."""
        comm = self.spec.comm
        if self.spec.mode != "explicit" or comm is None:
            return partial
        import torch.distributed as dist
        group = comm.get_group() if hasattr(comm, "get_group") else comm
        dist.all_reduce(partial, op=getattr(dist.ReduceOp, op), group=group)
        return partial

    def dot(self, other: "MeshVector") -> torch.Tensor:
        return self._finish(self._dv().dot(self.data, other.data,
                                           self.spec.policy), "SUM")

    def l1_norm(self) -> torch.Tensor:
        return self._finish(l1_norm(self.data), "SUM")

    def max_norm(self) -> torch.Tensor:
        return self._finish(max_norm(self.data), "MAX")

    def min(self) -> torch.Tensor:
        return self._finish(vmin(self.data), "MIN")

    def wrms_norm(self, w: "MeshVector",
                  global_size: Optional[int] = None) -> torch.Tensor:
        """WRMS norm; in explicit mode the caller passes the GLOBAL
        element count (the node-local ``tree_size`` is the shard's)."""
        n = global_size if global_size is not None else tree_size(self.data)
        ss = self._finish(self._dv().wrms_ss(self.data, w.data,
                                             self.spec.policy), "SUM")
        return torch.sqrt(ss / n)


# ---------------------------------------------------------------------------
# ManyVector — n vectors as one cohesive vector (paper §4): the tuple of
# the subvectors, which every op of the port takes as a vector.
# ---------------------------------------------------------------------------


def many_vector(*subvectors) -> tuple:
    """Combine subvectors into a single cohesive vector (a tuple)."""
    return tuple(subvectors)


def many_vector_num_subvectors(mv: tuple) -> int:
    return len(mv)
