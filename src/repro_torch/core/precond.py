"""Preconditioners: the PSetup/PSolve plug-in point, ensemble surface.

Counterpart of ``repro.core.precond`` (``precond.py:57-272``), SoA
surface only (used by the ``ensemble_bdf`` Krylov path; setup runs at
CVODE's lsetup triggers, so psetup counts ride ``nsetups``):

* ``soa_psetup(vals, pattern, gamma, policy=None) -> pdata`` where the
  Newton matrix arrives either dense (``vals: (n, n, nsys)``,
  ``pattern=None``) or as shared-pattern CSR values
  (``vals: (nnz, nsys)``, ``pattern=(indptr, indices)``);
* ``soa_psolve(pdata, r, policy=None) -> z`` with ``r: (n, nsys)``;
* ``soa_pdata_init(n, nsys, dtype, device)`` — zero pdata for the
  integrator carry (every leaf keeps the ``nsys`` lane axis LAST).

The scalar surface (``psetup``/``psolve``) waits for the scalar
integrators, ROADMAP queue A item 7, and raises.

=================  ========================================================
JacobiPrecond      diagonal of M
BlockJacobiPrecond b x b diagonal blocks of M, inverted once per psetup by
                   ``bsr_block_jacobi_inverse_soa`` (the Gauss-Jordan
                   inverse over the flattened nblk*nsys batch); psolve is
                   one block-diagonal SpMV
ILU0Precond        incomplete LU with zero fill on the shared CSR pattern
=================  ========================================================

Static index tensors are built once per (pattern, device) and cached.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import dispatch as dv
from . import spsolve

_SCALAR = ("the scalar preconditioner surface waits for the scalar "
           "integrators, ROADMAP queue A item 7")


def csr_diag_positions(indptr, indices) -> tuple:
    """Static nnz slot of entry (i, i) per row of a CSR pattern; raises
    if any diagonal entry is absent (``repro.core.sunmatrix``'s helper,
    which moves with that module to ROADMAP queue A item 7)."""
    pos = []
    for i in range(len(indptr) - 1):
        hits = [k for k in range(indptr[i], indptr[i + 1])
                if indices[k] == i]
        if not hits:
            raise ValueError(
                f"CSR pattern lacks diagonal entry ({i},{i}); build "
                "with ensure_diag=True for SUNMatScaleAddI use")
        pos.append(hits[0])
    return tuple(pos)


@functools.lru_cache(maxsize=64)
def _diag_slots(indptr: tuple, indices: tuple, device: torch.device):
    return torch.as_tensor(csr_diag_positions(indptr, indices),
                           dtype=torch.int64, device=device)


class Preconditioner:
    """Base protocol; see the module docstring."""

    name = "precond"

    def psetup(self, t, y, gamma, policy=None):
        raise NotImplementedError(_SCALAR)

    def psolve(self, pdata, r, policy=None):
        raise NotImplementedError(_SCALAR)

    def soa_psetup(self, vals, pattern, gamma, policy=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no ensemble psetup")

    def soa_psolve(self, pdata, r, policy=None):
        raise NotImplementedError

    def soa_pdata_init(self, n, nsys, dtype, device):
        raise NotImplementedError


@dataclass(frozen=True)
class JacobiPrecond(Preconditioner):
    """Diagonal (point-Jacobi) preconditioner: P = diag(M), read from
    the Newton matrix.  (The reference's ``jac_diag=`` serves its scalar
    surface and comes with it, ROADMAP A.7.)"""

    name = "jacobi"

    def soa_psetup(self, vals, pattern, gamma, policy=None):
        if pattern is None:
            idx = torch.arange(vals.shape[0], device=vals.device)
            d = vals[idx, idx]                       # (n, nsys)
        else:
            d = vals[_diag_slots(*pattern, vals.device)]
        return 1.0 / d

    def soa_psolve(self, pdata, r, policy=None):
        return pdata * r

    def soa_pdata_init(self, n, nsys, dtype, device):
        return torch.zeros((n, nsys), dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _block_slots(indptr: tuple, indices: tuple, b: int,
                 device: torch.device):
    """(I, bi, bj, k) index tensors of every CSR entry k that lies in
    diagonal block I, at (bi, bj) inside it."""
    Is, bis, bjs, ks = [], [], [], []
    for i in range(len(indptr) - 1):
        I, bi = divmod(i, b)
        for k in range(indptr[i], indptr[i + 1]):
            J, bj = divmod(indices[k], b)
            if J == I:
                Is.append(I)
                bis.append(bi)
                bjs.append(bj)
                ks.append(k)
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (Is, bis, bjs, ks))


@dataclass(frozen=True)
class BlockJacobiPrecond(Preconditioner):
    """Block-Jacobi: invert the ``b x b`` diagonal blocks of M once per
    psetup (one batched Gauss-Jordan inverse over the flattened
    ``nblk * nsys`` batch); psolve is one block-diagonal SpMV.

    The carry layout is the reference's: ``inv.reshape(b, b, nblk,
    nsys)`` reads the flattened batch as block I of system s at
    ``I*nsys + s`` (a reshape, not a transpose).  (The reference's
    ``jac=`` serves its scalar surface, ROADMAP A.7.)"""

    name = "block_jacobi"
    block_size: int = 1

    def _diag_block_values(self, vals, pattern, n, nsys):
        """(nblk, b, b, nsys) diagonal-block values of M."""
        b = self.block_size
        nblk = n // b
        if pattern is None:
            V5 = vals.reshape(nblk, b, nblk, b, nsys)
            ar = torch.arange(nblk, device=vals.device)
            return V5[ar, :, ar]
        Is, bis, bjs, ks = _block_slots(*pattern, b, vals.device)
        D = torch.zeros((nblk, b, b, nsys), dtype=vals.dtype,
                        device=vals.device)
        D[Is, bis, bjs] = vals[ks]
        return D

    def soa_psetup(self, vals, pattern, gamma, policy=None):
        n = vals.shape[0] if pattern is None else len(pattern[0]) - 1
        nsys = vals.shape[-1]
        b = self.block_size
        nblk = n // b
        D = self._diag_block_values(vals, pattern, n, nsys)
        diag_pat = (tuple(range(nblk)), tuple(range(nblk)), nblk)
        inv = dv.bsr_block_jacobi_inverse_soa(D, diag_pat, policy)
        return inv.reshape(b, b, nblk, nsys)

    def soa_psolve(self, pdata, r, policy=None):
        b, _, nblk, nsys = pdata.shape
        r_soa = r.reshape(nblk, b, nsys).permute(1, 0, 2) \
            .reshape(b, nblk * nsys)
        z = dv.blockdiag_spmv_soa(pdata.reshape(b, b, nblk * nsys), r_soa,
                                  policy)
        return z.reshape(b, nblk, nsys).permute(1, 0, 2) \
            .reshape(nblk * b, nsys)

    def soa_pdata_init(self, n, nsys, dtype, device):
        b = self.block_size
        return torch.zeros((b, b, n // b, nsys), dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _ilu0_plan(indptr: tuple, indices: tuple) -> spsolve.LUPlan:
    """ILU(0) symbolic phase: no reordering, no fill — the factored
    pattern IS the matrix pattern, updates outside it are dropped."""
    return spsolve.symbolic_lu(indptr, indices, order=False, fill=False)


@dataclass(frozen=True)
class ILU0Precond(Preconditioner):
    """Incomplete LU with zero fill on the shared CSR pattern.

    ``sparsity`` is the static pattern: an encoded ``(indptr,
    indices)`` pair or anything :func:`spsolve.encode_pattern` accepts;
    left unset, ``integrate`` binds the problem's ``jac_sparsity``
    (:meth:`with_sparsity`).  The symbolic phase runs once per pattern
    (host, cached); each psetup is a numeric refactor unrolled over the
    pattern, elementwise across the ensemble lanes.  (The reference's
    ``jac=`` serves its scalar surface, ROADMAP A.7.)"""

    name = "ilu0"
    sparsity: Optional[tuple] = None

    def __post_init__(self):
        if self.sparsity is not None and not (
                isinstance(self.sparsity, tuple)
                and len(self.sparsity) == 2
                and isinstance(self.sparsity[0], tuple)):
            object.__setattr__(self, "sparsity",
                               spsolve.encode_pattern(self.sparsity))

    def with_sparsity(self, enc) -> "ILU0Precond":
        return self if self.sparsity is not None else \
            dataclasses.replace(self, sparsity=enc)

    def _plan(self) -> spsolve.LUPlan:
        if self.sparsity is None:
            raise ValueError("ILU0Precond needs sparsity= (or a "
                             "jac_sparsity on the problem)")
        return _ilu0_plan(*self.sparsity)

    def soa_psetup(self, vals, pattern, gamma, policy=None):
        plan = self._plan()
        if pattern is None:
            vals0 = spsolve.gather_filled(plan, vals)
        else:
            vals0 = spsolve.scatter_from_csr(plan, pattern[0], pattern[1],
                                             vals)
        return spsolve.numeric_lu(plan, vals0)

    def soa_psolve(self, pdata, r, policy=None):
        return spsolve.lu_solve(self._plan(), pdata, r)

    def soa_pdata_init(self, n, nsys, dtype, device):
        return torch.zeros((self._plan().nnz_factored, nsys), dtype=dtype,
                           device=device)
