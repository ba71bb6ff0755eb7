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
:mod:`repro_torch.core.dispatch`'s.  ``MeshVector`` waits for ROADMAP
queue A.7.
"""
from __future__ import annotations

import functools

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
