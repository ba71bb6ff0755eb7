"""Pluggable linear solvers: the SUNLinearSolver object layer.

Counterpart of ``repro.core.linsol`` (``linsol.py:95-576``), with its
two call surfaces.

**Scalar** (``arkode``'s implicit stages): :meth:`LinearSolver.bind`
``(fi, policy=..., mem=...)`` returns ``lin_solve(t, z, gamma, rhs) ->
dz`` solving ``(I - gamma*J_fi(t, z)) dz = rhs``.  The Krylov solvers
are matrix-free: ``J v`` is ``torch.func.jvp`` of ``fi`` and the matvec
``v - gamma*J v`` goes through ``dispatch.linear_sum``; a bare callable
``precond=`` is applied right, and a
:class:`~repro_torch.core.precond.Preconditioner` object runs its
scalar ``psetup`` at each ``lin_solve`` and its ``psolve`` LEFT (counted
in the Krylov stats' ``npsolves``), as in the reference.
:class:`DenseGJ` builds ``J`` with ``torch.func.jacfwd`` and solves
with ``torch.linalg.solve_ex`` (the reference's ``jnp.linalg.solve`` is
no kernel either).  A tuple state is flattened for the solve.
:func:`as_lin_solve` normalizes the integrators' ``lin_solver``
argument.

**SoA batch** (``batched.ensemble_bdf_integrate``, the CVODE
lsetup/lsolve split; the system batch rides the last axis):

* :meth:`LinearSolver.soa_setup` ``(Jsoa, gamma, policy)`` -> the saved
  per-step linear object, a tensor or a tuple of them whose every leaf
  keeps the ``nsys`` axis LAST (so the integrator's masked per-system
  carry update broadcasts);
* :meth:`LinearSolver.soa_solve` ``(MJ, gamma, gamrat, rhs, policy,
  mem)`` -> ``(dz, nli, npsolves)``, the counts 0-d int32 tensors on
  the device (or 0 for the direct solvers);
* :meth:`LinearSolver.soa_residual_solve` ``(MJ, gamma, gamrat, z, fz,
  psi, policy, mem)``: the residual's negation ``-(z - gamma*fz - psi)``
  solved as by ``soa_solve``.  By default the two dispatch ops
  ``newton_residual_soa`` and the solver's lsolve; :class:`BlockDiagGJ`
  takes the port's fused op ``newton_residual_lsolve_soa`` instead (one
  launch) where it can;
* :meth:`LinearSolver.soa_newton_update` ``(MJ, gamma, gamrat, z, fz,
  psi, w, mask, policy, mem)`` -> ``(z_new, dn, nli, npsolves)``, what
  a Newton iteration calls: :meth:`soa_residual_solve`, then the masked
  update and correction norm ``masked_update_wrms_soa``;
  :class:`BlockDiagGJ` takes the port's fused op ``newton_update_soa``
  instead (one launch) where it can;
* :meth:`LinearSolver.soa_carry_init` / :meth:`soa_workspace_shapes`;
* :meth:`LinearSolver.with_sparsity` binds a static ``jac_sparsity``
  (encoded ``(indptr, indices)``); solvers without a sparse path return
  themselves unchanged.

================  =======================================================
SPGMR             restarted GMRES
SPFGMR            flexible GMRES (stores the preconditioned basis)
SPBCGS            BiCGStab
SPTFQMR           transpose-free QMR
PCG               preconditioned conjugate gradient (SPD systems)
DenseGJ           dense jacfwd Jacobian + LU solve (scalar surface)
BlockDiagGJ       batched block-diagonal Gauss-Jordan over the SoA
                  kernels (``factor_once=True`` inverts at lsetup,
                  ``False`` re-solves with the current gamma)
EnsembleSparseGJ  the SUNLINSOL_CUSOLVERSP_BATCHQR analog: shared static
                  sparsity, symbolic analysis once per pattern (host,
                  cached), numeric refactor at the lsetup triggers,
                  O(nnz) storage
================  =======================================================

A Krylov solver's ``precond=`` takes a bare callable (right
preconditioning) or a :class:`~repro_torch.core.precond.Preconditioner`
(psetup at the lsetup triggers, psolve applied LEFT, counted in
``npsolves``).  With a sparsity pattern bound, a Krylov solver saves
only the ``(nnz, nsys)`` Jacobian values and its matvec is the
shared-pattern ``bsr_spmv_soa`` with 1x1 blocks.  The static index
tensors a pattern needs (CSR rows and columns, diagonal slots, the 1x1
block pattern) are built once per (pattern, device) and cached.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import block_solve as _bs
from ..kernels.block_solve import newton_blocks_soa
from ..kernels import newton as _nw
from . import dispatch as dv
from . import krylov
from . import spsolve


def encode_sparsity(pattern) -> tuple:
    """Normalize a ``jac_sparsity`` to the hashable static encoding the
    solvers carry: an (n, n) boolean/0-1 array (or an already-encoded
    ``(indptr, indices)`` pair) -> ``(indptr, indices)`` tuples with
    the diagonal forced in."""
    if isinstance(pattern, tuple) and len(pattern) == 2 and \
            isinstance(pattern[0], tuple):
        return pattern
    return spsolve.encode_pattern(pattern)


def _csr_rows_cols(indptr, indices):
    rows = np.repeat(np.arange(len(indptr) - 1),
                     np.diff(np.asarray(indptr)))
    return rows, np.asarray(indices, np.int64)


def _is_precond_obj(p) -> bool:
    return p is not None and hasattr(p, "psetup") and hasattr(p, "psolve")


class _PatternIndex(NamedTuple):
    rows: torch.Tensor       # (nnz,) CSR row of each slot
    cols: torch.Tensor       # (nnz,) CSR column of each slot
    diag: torch.Tensor       # slots of the diagonal entries
    blocks: tuple            # the 1x1 block pattern (brows, bcols, n)


@functools.lru_cache(maxsize=64)
def _pattern_index(indptr: tuple, indices: tuple,
                   device: torch.device) -> _PatternIndex:
    rows, cols = _csr_rows_cols(indptr, indices)
    return _PatternIndex(
        rows=torch.as_tensor(rows, device=device),
        cols=torch.as_tensor(cols, device=device),
        diag=torch.as_tensor(np.nonzero(rows == cols)[0], device=device),
        blocks=(tuple(int(r) for r in rows), tuple(int(c) for c in cols),
                len(indptr) - 1))


def _shape_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _shape_leaves(t)]
    return [tuple(tree.shape)]


def _ravel(v):
    """``(flat, unravel)``: a tensor stays as it is; a tuple of tensors
    becomes one flat vector and ``unravel`` splits it back."""
    if not isinstance(v, tuple):
        return v, lambda f: f
    shapes = [t.shape for t in v]
    sizes = [t.numel() for t in v]

    def unravel(f):
        return tuple(part.reshape(shape) for part, shape
                     in zip(torch.split(f, sizes), shapes))

    return torch.cat([t.reshape(-1) for t in v]), unravel


class LinearSolver:
    """Base protocol; see the module docstring."""

    name = "linear_solver"

    def bind(self, fi, *, policy=None, mem=None):
        """``lin_solve(t, z, gamma, rhs) -> dz`` for ``fi``."""
        raise NotImplementedError(
            f"{type(self).__name__} is an ensemble (SoA) solver; scalar "
            "integrators want DenseGJ or a Krylov solver")

    def soa_setup(self, Jsoa, gamma, policy=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no SoA batch path")

    def soa_solve(self, MJ, gamma, gamrat, rhs, policy=None, mem=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no SoA batch path")

    def soa_residual_solve(self, MJ, gamma, gamrat, z, fz, psi, policy=None,
                           mem=None):
        """One Newton iteration's correction: :meth:`soa_solve` of the
        Newton right-hand side ``-(z - gamma*fz - psi)``."""
        rhs = dv.newton_residual_soa(z, fz, psi, gamma, policy, negate=True)
        return self.soa_solve(MJ, gamma, gamrat, rhs, policy, mem=mem)

    def soa_newton_update(self, MJ, gamma, gamrat, z, fz, psi, w, mask,
                          policy=None, mem=None):
        """One Newton iteration: :meth:`soa_residual_solve`, then
        ``masked_update_wrms_soa`` -> ``(z_new, dn, nli, npsolves)``."""
        dz, nli, nps = self.soa_residual_solve(MJ, gamma, gamrat, z, fz, psi,
                                               policy, mem=mem)
        z_new, dn = dv.masked_update_wrms_soa(z, dz, w, mask, policy)
        return z_new, dn, nli, nps

    def soa_carry_init(self, n, nsys, dtype, device):
        return torch.zeros((n, n, nsys), dtype=dtype, device=device)

    def soa_workspace_shapes(self, n, nsys):
        return [("newton_blocks", (n, n, nsys))]

    def with_sparsity(self, enc: tuple) -> "LinearSolver":
        return self


# ---------------------------------------------------------------------------
# Matrix-free Krylov family
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _KrylovSolver(LinearSolver):
    """Shared machinery: the matvec and the SoA global solve.

    Each solve runs ONE Krylov iteration over the flattened
    block-diagonal system of all ``nsys`` systems, with convergence on
    the aggregate residual, as the reference does.  The saved object is
    ``(Jrepr, pdata)``: the Jacobian (dense SoA, or values only when a
    pattern is bound) and the preconditioner's psetup product (an empty
    tuple when unpreconditioned)."""

    tol: float = 1e-4
    atol: float = 0.0
    precond: Optional[Any] = None
    sparsity: Optional[tuple] = None

    def _run(self, matvec, b, *, policy=None, mem=None, precond=None,
             precond_left=None):
        raise NotImplementedError

    def with_sparsity(self, enc: tuple) -> "_KrylovSolver":
        new = self
        if new.sparsity is None:
            new = dataclasses.replace(new, sparsity=enc)
        # pattern-needing preconditioners (ILU0) pick the pattern up from
        # the same jac_sparsity binding
        p = new.precond
        if p is not None and hasattr(p, "with_sparsity"):
            p2 = p.with_sparsity(enc)
            if p2 is not p:
                new = dataclasses.replace(new, precond=p2)
        return new

    def _resolved_precond(self):
        """-> (legacy_right_callable, precond_object); at most one set."""
        p = self.precond
        if _is_precond_obj(p):
            return None, p
        return p, None

    # -- scalar surface ----------------------------------------------------
    def bind(self, fi, *, policy=None, mem=None):
        legacy, pobj = self._resolved_precond()

        def lin_solve(t, z, gamma, rhs):
            _, unravel = _ravel(rhs)

            def matvec(vf):
                v = unravel(vf)
                _, jv = torch.func.jvp(lambda zz: fi(t, zz), (z,), (v,))
                return _ravel(dv.linear_sum(1.0, v, -gamma, jv, policy))[0]

            kw = {}
            if pobj is not None:
                pdata = pobj.psetup(t, z, gamma, policy=policy)
                kw["precond_left"] = lambda vf: pobj.psolve(
                    pdata, vf.reshape(-1), policy=policy).reshape(vf.shape)
            elif legacy is not None:
                kw["precond"] = lambda vf: _ravel(legacy(unravel(vf)))[0]
            x, _ = self._run(matvec, _ravel(rhs)[0], policy=policy, mem=mem,
                             **kw)
            return unravel(x)

        return lin_solve

    def _index(self, device) -> _PatternIndex:
        return _pattern_index(*self.sparsity, device)

    def _sparse_newton_vals(self, Jvals, gamma):
        """(nnz, nsys) values of M = I - gamma*J on the static pattern."""
        mvals = -gamma[None, :] * Jvals
        mvals[self._index(Jvals.device).diag] += 1.0
        return mvals

    def soa_setup(self, Jsoa, gamma, policy=None):
        _, pobj = self._resolved_precond()
        if self.sparsity is not None:
            ix = self._index(Jsoa.device)
            Jrepr = Jsoa[ix.rows, ix.cols]
            pdata = pobj.soa_psetup(self._sparse_newton_vals(Jrepr, gamma),
                                    self.sparsity, gamma, policy=policy) \
                if pobj is not None else ()
            return (Jrepr, pdata)
        pdata = pobj.soa_psetup(newton_blocks_soa(Jsoa, gamma), None, gamma,
                                policy=policy) if pobj is not None else ()
        return (Jsoa, pdata)

    def soa_solve(self, MJ, gamma, gamrat, rhs, policy=None, mem=None):
        legacy, pobj = self._resolved_precond()
        Jrepr, pdata = MJ
        if self.sparsity is not None:
            pat = self._index(Jrepr.device).blocks
            V = self._sparse_newton_vals(Jrepr, gamma)[:, None, None, :]

            def matvec(v):                       # 1x1 blocks
                return dv.bsr_spmv_soa(V, v[:, None, :], pat,
                                       policy)[:, 0, :]
        else:
            M_cur = newton_blocks_soa(Jrepr, gamma)

            def matvec(v):
                return dv.blockdiag_spmv_soa(M_cur, v, policy)

        kw = {}
        if pobj is not None:
            kw["precond_left"] = \
                lambda v: pobj.soa_psolve(pdata, v, policy=policy)
        elif legacy is not None:
            kw["precond"] = legacy
        x, st = self._run(matvec, rhs, policy=policy, mem=mem, **kw)
        return x, st.iters, st.npsolves

    def soa_carry_init(self, n, nsys, dtype, device):
        _, pobj = self._resolved_precond()
        shape = (len(self.sparsity[1]), nsys) if self.sparsity is not None \
            else (n, n, nsys)
        pdata = pobj.soa_pdata_init(n, nsys, dtype, device) \
            if pobj is not None else ()
        return (torch.zeros(shape, dtype=dtype, device=device), pdata)

    def soa_workspace_shapes(self, n, nsys):
        shapes = [("newton_vals", (len(self.sparsity[1]), nsys))
                  if self.sparsity is not None
                  else ("newton_blocks", (n, n, nsys))]
        _, pobj = self._resolved_precond()
        if pobj is not None:
            # shapes only: the meta device allocates nothing
            leaves = _shape_leaves(pobj.soa_pdata_init(
                n, nsys, torch.float64, torch.device("meta")))
            shapes.extend((f"precond{i}", shape)
                          for i, shape in enumerate(leaves))
        return shapes


@dataclass(frozen=True)
class SPGMR(_KrylovSolver):
    name = "spgmr"
    restart: int = 20
    max_restarts: int = 2

    def _run(self, matvec, b, *, policy=None, mem=None, precond=None,
             precond_left=None):
        return krylov.gmres(matvec, b, tol=self.tol, atol=self.atol,
                            restart=self.restart,
                            max_restarts=self.max_restarts,
                            precond=precond, precond_left=precond_left,
                            policy=policy, mem=mem)


@dataclass(frozen=True)
class SPFGMR(_KrylovSolver):
    name = "spfgmr"
    restart: int = 20
    max_restarts: int = 2

    def _run(self, matvec, b, *, policy=None, mem=None, precond=None,
             precond_left=None):
        return krylov.fgmres(matvec, b, tol=self.tol, atol=self.atol,
                             restart=self.restart,
                             max_restarts=self.max_restarts,
                             precond=precond, precond_left=precond_left,
                             policy=policy, mem=mem)


@dataclass(frozen=True)
class SPBCGS(_KrylovSolver):
    name = "spbcgs"
    maxiter: int = 200

    def _run(self, matvec, b, *, policy=None, mem=None, precond=None,
             precond_left=None):
        return krylov.bicgstab(matvec, b, tol=self.tol, atol=self.atol,
                               maxiter=self.maxiter, precond=precond,
                               precond_left=precond_left, policy=policy,
                               mem=mem)


@dataclass(frozen=True)
class SPTFQMR(_KrylovSolver):
    name = "sptfqmr"
    maxiter: int = 200

    def _run(self, matvec, b, *, policy=None, mem=None, precond=None,
             precond_left=None):
        return krylov.tfqmr(matvec, b, tol=self.tol, atol=self.atol,
                            maxiter=self.maxiter, precond=precond,
                            precond_left=precond_left, policy=policy,
                            mem=mem)


@dataclass(frozen=True)
class PCG(_KrylovSolver):
    name = "pcg"
    maxiter: int = 200

    def _run(self, matvec, b, *, policy=None, mem=None, precond=None,
             precond_left=None):
        return krylov.pcg(matvec, b, tol=self.tol, atol=self.atol,
                          maxiter=self.maxiter, precond=precond,
                          precond_left=precond_left, policy=policy, mem=mem)


# ---------------------------------------------------------------------------
# Direct solvers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenseGJ(LinearSolver):
    """Dense direct Newton solver: J by ``torch.func.jacfwd`` at the
    current iterate on every call (full Newton), then one LU solve; for
    the small systems of the scalar integrators."""

    name = "dense_gj"

    def bind(self, fi, *, policy=None, mem=None):
        def lin_solve(t, z, gamma, rhs):
            zf, unravel = _ravel(z)
            shape = zf.shape
            zf = zf.reshape(-1)
            n = zf.numel()
            if mem is not None:
                mem.register("densegj.newton_matrix", (n, n), zf.dtype)

            def f_flat(v):
                return _ravel(fi(t, unravel(v.reshape(shape))))[0].reshape(-1)

            J = torch.func.jacfwd(f_flat)(zf)
            M = torch.eye(n, dtype=J.dtype, device=J.device) - gamma * J
            x, _ = torch.linalg.solve_ex(M, _ravel(rhs)[0].reshape(-1))
            return unravel(x.reshape(shape))

        return lin_solve


@dataclass(frozen=True)
class BlockDiagGJ(LinearSolver):
    """Batched block-diagonal Gauss-Jordan over the SoA dispatch ops.

    ``factor_once=True`` (the default, CVODE's lsetup/lsolve split):
    lsetup inverts every Newton block once and each Newton iteration is
    one block-diagonal SpMV against the saved inverse, scaled by
    ``2/(1+gamrat)`` for the gamma drift since lsetup.
    ``factor_once=False`` keeps the bare Jacobian and solves
    ``(I - gamma*J) dz = rhs`` with the current gamma every iteration.
    A ``jac_sparsity`` is ignored (the blocks stay dense).

    With ``factor_once=True`` and blocks of at most
    :data:`~repro_torch.kernels.newton.RESIDUAL_MAX_N` rows, a Newton
    iteration (:meth:`soa_newton_update`) is the one op
    ``newton_update_soa``: the residual, the SpMV, the correction, the
    masked update and the correction norm in one launch, bit for bit
    their composition; :meth:`soa_residual_solve` alone is the one op
    ``newton_residual_lsolve_soa``.  A policy that pins any op of the
    composition (:data:`UPDATE_OPS`, to any backend) keeps it, so the
    pin reaches its op: a pin of ``masked_update_wrms_soa`` keeps
    ``newton_residual_lsolve_soa`` and the update, a pin of
    ``newton_residual_soa`` or ``blockdiag_spmv_soa`` the residual and
    the SpMV.  Larger blocks and ``factor_once=False`` take the
    composition too.  Likewise lsetup (:meth:`soa_setup`) at b <=
    :data:`~repro_torch.kernels.block_solve.UNROLL_MAX_B` is the one op
    ``newton_block_inverse_soa``, the Newton blocks formed inside the
    inverse, unless ``block_inverse_soa`` is pinned.
    """

    name = "blockdiag_gj"
    factor_once: bool = True
    #: the ops of the composed Newton lsolve: a pin of either keeps the
    #: residual and the SpMV
    COMPOSED_OPS = ("newton_residual_soa", "blockdiag_spmv_soa")
    #: the ops a Newton iteration takes apart from newton_update_soa: a
    #: pin of any keeps the composition
    UPDATE_OPS = ("newton_residual_lsolve_soa",) + COMPOSED_OPS + (
        "masked_update_wrms_soa",)

    def soa_setup(self, Jsoa, gamma, policy=None):
        """lsetup: the saved inverse of M = I - gamma*J, (n,n,nsys), or
        the bare Jacobian for ``factor_once=False``."""
        if not self.factor_once:
            return Jsoa
        if Jsoa.shape[0] <= _bs.UNROLL_MAX_B and not (
                policy is not None and policy.pinned("block_inverse_soa")):
            return dv.newton_block_inverse_soa(Jsoa, gamma, policy)
        return dv.block_inverse_soa(newton_blocks_soa(Jsoa, gamma), policy)

    def soa_solve(self, MJ, gamma, gamrat, rhs, policy=None, mem=None):
        """lsolve: ``(dz, nli, npsolves)``; direct, so both counts are 0."""
        if not self.factor_once:
            return dv.block_solve_soa(newton_blocks_soa(MJ, gamma), rhs,
                                      policy), 0, 0
        corr = 2.0 / (1.0 + gamrat)
        return corr[None, :] * dv.blockdiag_spmv_soa(MJ, rhs, policy), 0, 0

    def soa_residual_solve(self, MJ, gamma, gamrat, z, fz, psi, policy=None,
                           mem=None):
        """The Newton iteration as ``newton_residual_lsolve_soa`` where
        the class docstring says; else residual, then :meth:`soa_solve`."""
        if not self.factor_once or MJ.shape[0] > _nw.RESIDUAL_MAX_N or (
                policy is not None and
                any(policy.pinned(op) for op in self.COMPOSED_OPS)):
            return super().soa_residual_solve(MJ, gamma, gamrat, z, fz, psi,
                                              policy, mem=mem)
        return dv.newton_residual_lsolve_soa(z, fz, psi, gamma, gamrat, MJ,
                                             policy), 0, 0

    def soa_newton_update(self, MJ, gamma, gamrat, z, fz, psi, w, mask,
                          policy=None, mem=None):
        """The Newton iteration as ``newton_update_soa`` where the class
        docstring says; else :meth:`soa_residual_solve`, then the
        update."""
        if not self.factor_once or MJ.shape[0] > _nw.RESIDUAL_MAX_N or (
                policy is not None and
                any(policy.pinned(op) for op in self.UPDATE_OPS)):
            return super().soa_newton_update(MJ, gamma, gamrat, z, fz, psi, w,
                                             mask, policy, mem=mem)
        z_new, dn = dv.newton_update_soa(z, fz, psi, gamma, gamrat, MJ, w,
                                         mask, policy)
        return z_new, dn, 0, 0


@dataclass(frozen=True)
class EnsembleSparseGJ(LinearSolver):
    """Batched sparse direct solver for ensembles sharing one Jacobian
    sparsity pattern (the SUNLINSOL_CUSOLVERSP_BATCHQR analog).

    * symbolic setup once per pattern (host, cached:
      :func:`repro_torch.core.spsolve.symbolic_lu`): reverse
      Cuthill-McKee fill ordering, fill-in, the unrolled schedule;
    * numeric refactor at the lsetup triggers only: ``soa_setup``
      gathers the ``(nnzf, nsys)`` Newton values ``M = I - gamma*J`` at
      the static (filled, permuted) positions and runs the no-pivot LU
      elementwise across the lanes;
    * lsolve: two unrolled triangular sweeps on the saved factor, with
      CVODE's ``2/(1+gamrat)`` correction for the gamma drift.

    The carry and registered workspace are ``(nnzf, nsys)``.  Construct
    with ``sparsity=`` or let ``integrate(..., "ensemble_bdf")`` bind
    the problem's ``jac_sparsity`` via :meth:`with_sparsity`.
    """

    name = "ensemble_sparse_gj"
    sparsity: Optional[tuple] = None
    reorder: bool = True

    def __post_init__(self):
        if self.sparsity is not None:
            object.__setattr__(self, "sparsity",
                               encode_sparsity(self.sparsity))

    def with_sparsity(self, enc: tuple) -> "EnsembleSparseGJ":
        return self if self.sparsity is not None else \
            dataclasses.replace(self, sparsity=enc)

    def _plan(self) -> spsolve.LUPlan:
        if self.sparsity is None:
            raise ValueError(
                "EnsembleSparseGJ needs a sparsity pattern: pass "
                "sparsity= or set IVP.jac_sparsity")
        return spsolve.symbolic_lu(*self.sparsity, order=self.reorder,
                                   fill=True)

    def soa_setup(self, Jsoa, gamma, policy=None):
        plan = self._plan()
        # gather FIRST, then form M = I - gamma*J on the (nnzf, nsys)
        # values: no O(n^2 * nsys) dense intermediate at lsetup
        mvals = -gamma[None, :] * spsolve.gather_filled(plan, Jsoa)
        mvals[spsolve.diag_index(plan, Jsoa.device)] += 1.0
        return spsolve.numeric_lu(plan, mvals)

    def soa_solve(self, MJ, gamma, gamrat, rhs, policy=None, mem=None):
        corr = 2.0 / (1.0 + gamrat)
        return corr[None, :] * spsolve.lu_solve(self._plan(), MJ, rhs), 0, 0

    def soa_carry_init(self, n, nsys, dtype, device):
        return torch.zeros((self._plan().nnz_factored, nsys), dtype=dtype,
                           device=device)

    def soa_workspace_shapes(self, n, nsys):
        return [("newton_vals", (self._plan().nnz_factored, nsys))]


def as_lin_solve(lin_solver, fi, *, policy=None, mem=None,
                 default: Optional[LinearSolver] = None):
    """The integrators' ``lin_solver`` argument as a callable
    ``(t, z, gamma, rhs) -> dz``: a :class:`LinearSolver` is bound to
    ``fi``, a bare callable is returned as it is, None binds ``default``
    (itself a solver; SPGMR when None too)."""
    if lin_solver is None:
        lin_solver = default if default is not None else SPGMR()
    if hasattr(lin_solver, "bind"):
        return lin_solver.bind(fi, policy=policy, mem=mem)
    return lin_solver
