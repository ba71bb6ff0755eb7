"""Preconditioners: the PSetup/PSolve plug-in point.

Counterpart of ``repro.core.precond`` (``precond.py:57-272``).  A
:class:`Preconditioner` has two surfaces, as the linear solvers do.

**Scalar** (one system; the scalar ``bind`` of the Krylov solvers):

* ``psetup(t, y, gamma, policy=None) -> pdata`` for the Newton matrix
  ``M = I - gamma*J`` at the current iterate (called at each lin_solve,
  the PSetup moment), from the user's ``jac_diag`` (Jacobi) or dense
  ``jac`` (block Jacobi, ILU0);
* ``psolve(pdata, r, policy=None) -> z``: ``P^{-1} r`` on the raveled
  ``(n,)`` residual.

**Ensemble SoA** (the ``ensemble_bdf`` Krylov path; setup runs at
CVODE's lsetup triggers, so psetup counts ride ``nsetups``):

* ``soa_psetup(vals, pattern, gamma, policy=None) -> pdata`` where the
  Newton matrix arrives either dense (``vals: (n, n, nsys)``,
  ``pattern=None``) or as shared-pattern CSR values
  (``vals: (nnz, nsys)``, ``pattern=(indptr, indices)``);
* ``soa_psolve(pdata, r, policy=None) -> z`` with ``r: (n, nsys)``;
* ``soa_pdata_init(n, nsys, dtype, device)`` — zero pdata for the
  integrator carry (every leaf keeps the ``nsys`` lane axis LAST).

=================  ========================================================
JacobiPrecond      diagonal of M
BlockJacobiPrecond b x b diagonal blocks of M, inverted once per psetup
                   (ensemble: by ``bsr_block_jacobi_inverse_soa``, the
                   Gauss-Jordan inverse over the flattened nblk*nsys
                   batch; scalar: ``torch.linalg.inv``, as the reference
                   uses ``jnp.linalg.inv``); psolve is one block-diagonal
                   product
ILU0Precond        incomplete LU with zero fill on the shared CSR pattern
=================  ========================================================

Static index tensors are built once per (pattern, device) and cached.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import dispatch as dv
from . import spsolve
from .sunmatrix import csr_diag_positions


@functools.lru_cache(maxsize=64)
def _diag_slots(indptr: tuple, indices: tuple, device: torch.device):
    return torch.as_tensor(csr_diag_positions(indptr, indices),
                           dtype=torch.int64, device=device)


class Preconditioner:
    """Base protocol; see the module docstring."""

    name = "precond"

    def psetup(self, t, y, gamma, policy=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no scalar psetup")

    def psolve(self, pdata, r, policy=None):
        raise NotImplementedError

    def soa_psetup(self, vals, pattern, gamma, policy=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no ensemble psetup")

    def soa_psolve(self, pdata, r, policy=None):
        raise NotImplementedError

    def soa_pdata_init(self, n, nsys, dtype, device):
        raise NotImplementedError


@dataclass(frozen=True)
class JacobiPrecond(Preconditioner):
    """Diagonal (point-Jacobi) preconditioner: P = diag(M).

    ``jac_diag(t, y) -> (n,)`` supplies the Jacobian diagonal on the
    scalar surface (a matrix-free integrator cannot extract it); the
    ensemble surface reads it from the Newton matrix."""

    name = "jacobi"
    jac_diag: Optional[Callable] = None

    def psetup(self, t, y, gamma, policy=None):
        if self.jac_diag is None:
            raise ValueError("scalar JacobiPrecond needs jac_diag=")
        return 1.0 / (1.0 - gamma * self.jac_diag(t, y))

    def psolve(self, pdata, r, policy=None):
        return pdata * r

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
    ``I*nsys + s`` (a reshape, not a transpose).  ``jac(t, y) -> (n,
    n)`` supplies the dense Jacobian on the scalar surface."""

    name = "block_jacobi"
    block_size: int = 1
    jac: Optional[Callable] = None

    def psetup(self, t, y, gamma, policy=None):
        if self.jac is None:
            raise ValueError("scalar BlockJacobiPrecond needs jac=")
        J = self.jac(t, y)
        b = self.block_size
        nblk = J.shape[0] // b
        ar = torch.arange(nblk, device=J.device)
        D = torch.eye(b, dtype=J.dtype, device=J.device)[None] - \
            gamma * J.reshape(nblk, b, nblk, b)[ar, :, ar, :]
        return torch.linalg.inv(D)                   # (nblk, b, b)

    def psolve(self, pdata, r, policy=None):
        nblk, b, _ = pdata.shape
        return torch.einsum("nij,nj->ni", pdata,
                            r.reshape(nblk, b)).reshape(-1)

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
    pattern, elementwise across the ensemble lanes.  ``jac(t, y) ->
    (n, n)`` supplies the dense Jacobian on the scalar surface."""

    name = "ilu0"
    sparsity: Optional[tuple] = None
    jac: Optional[Callable] = None

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

    def psetup(self, t, y, gamma, policy=None):
        if self.jac is None:
            raise ValueError("scalar ILU0Precond needs jac=")
        plan = self._plan()
        J = self.jac(t, y)
        M = torch.eye(J.shape[0], dtype=J.dtype, device=J.device) - gamma * J
        return spsolve.numeric_lu(plan, spsolve.gather_filled(plan, M))

    def psolve(self, pdata, r, policy=None):
        return spsolve.lu_solve(self._plan(), pdata, r)

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
