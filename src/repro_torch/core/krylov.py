"""Matrix-free Krylov linear solvers (SUNLinearSolver analogs).

Counterpart of ``repro.core.krylov`` (``krylov.py:63-504``): SPGMR,
SPFGMR, SPBCGS, SPTFQMR and PCG written against the vector ops of
:mod:`repro_torch.core.dispatch` only, so on the card their inner
products are the ``dot`` kernel and their vector updates the
linear-combination kernel (the paper's point: a GPU vector makes the
Krylov solvers GPU solvers).  A vector is one real tensor of any shape;
complex dtypes raise (the reference keeps ``jnp.vdot`` for them).

All solvers accept
  matvec  : v -> A v
  b       : right-hand side
  precond : v -> M^{-1} v  (right preconditioning; identity default).
            For pcg the one canonical SPD slot (z = M^{-1} r).
  precond_left : v -> M_L^{-1} v  (LEFT preconditioning: the solver
            iterates on M_L^{-1} A x = M_L^{-1} b; pcg maps it onto
            its canonical slot)
  mem     : optional MemoryHelper; the solver registers its workspace
and return ``(x, SolveStats)``.

SolveStats convention (identical across all five solvers, as in the
reference):

* ``res_norm``  : the TRUE unpreconditioned residual 2-norm
  ``||b - A x||_2`` at the returned ``x`` (one extra matvec at exit).
* ``converged`` : ``res_norm <= max(tol * ||b||_2, atol)``.
* ``iters``     : inner iterations actually performed: Arnoldi steps
  for gmres/fgmres, CG iterations for pcg, full BiCGStab iterations,
  TFQMR outer iterations.
* ``npsolves``  : EXACT count of preconditioner applications.
* ``npsetups``  : always 0 here (psetup belongs to the linear-solver
  layer).

Every field is a 0-d tensor on the vectors' device (``iters`` and
``npsolves`` int32).

Host loops.  The reference's Arnoldi loop is a fixed-count
``fori_loop`` whose updates freeze once ``done``; here it is a fixed
host loop over m steps with ``torch.where`` freezing and no sync.  The
GMRES restart loop and the ``while_loop``s of BiCGStab, TFQMR and PCG
read their device condition once per trip (counted in
:data:`repro_torch.core.loops.loop_counts`, ``krylov_trips`` and
``host_syncs``).  The Givens and Hessenberg arithmetic stays on the
device as 0-d tensors, under the profiler range :data:`HESSENBERG`,
so a trace can sum its device time.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from . import dispatch as dv
from .loops import loop_counts, read
from .policies import ExecPolicy


#: profiler range of GMRES's Givens, Hessenberg and back-substitution
#: arithmetic on m-sized vectors (dozens of tiny launches a step)
HESSENBERG = "gmres.hessenberg"


class SolveStats(NamedTuple):
    """Uniform solver stats (see the module docstring)."""

    iters: torch.Tensor
    res_norm: torch.Tensor
    converged: torch.Tensor
    npsolves: Any = 0
    npsetups: Any = 0


def _identity(v):
    return v


def _real(b: torch.Tensor) -> None:
    if b.is_complex():
        raise TypeError("the port's Krylov solvers take real systems; "
                        f"got {b.dtype}")


def _int(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=like.device)


def _trip(cond: torch.Tensor) -> bool:
    """One counted loop trip decision read from the device."""
    loop_counts["krylov_trips"] += 1
    return bool(read(cond))


def _left_wrap(matvec, b, precond_left):
    """Left preconditioning: return (matvec', b', n_ml_initial) so the
    caller iterates on M_L^{-1} A x = M_L^{-1} b.  The exit-time true
    residual always uses the ORIGINAL matvec and b."""
    if precond_left is None:
        return matvec, b, 0
    return (lambda v: precond_left(matvec(v))), precond_left(b), 1


def _nz(x: torch.Tensor) -> torch.Tensor:
    """x where it is nonzero, else 1 (a guarded divisor)."""
    return torch.where(x != 0, x, torch.ones_like(x))


# ----------------------------------------------------------------------------
# GMRES (right-preconditioned, modified Gram-Schmidt, Givens rotations)
# ----------------------------------------------------------------------------


def gmres(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
          atol: float = 0.0, restart: int = 30, max_restarts: int = 10,
          precond: Optional[Callable] = None,
          precond_left: Optional[Callable] = None,
          policy: Optional[ExecPolicy] = None, flexible: bool = False,
          mem=None):
    """Restarted GMRES(m).  Solves A x = b with right preconditioning:
    A M^{-1} u = b, x = M^{-1} u.

    ``flexible=True`` is true FGMRES (SPFGMR): the preconditioned basis
    vectors z_j = M^{-1} v_j are stored and the correction is formed as
    Z y, so ``precond`` may vary between iterations.  Plain GMRES
    applies M once to the assembled correction instead."""
    _real(b)
    M = precond or _identity
    mv_in, b_in, ml = _left_wrap(matvec, b, precond_left)
    mr = 1 if precond is not None else 0
    shape = b.shape
    b_flat = b.reshape(-1)
    bin_flat = b_in.reshape(-1)
    n = b_flat.numel()
    dtype = b.dtype
    m = min(restart, n)
    if mem is not None:
        label = "spfgmr" if flexible else "spgmr"
        mem.register(f"{label}.basis",
                     (m + 1 + (m if flexible else 0), n), dtype)
        mem.register(f"{label}.hessenberg", (m + 1, m), dtype)

    def unravel(v):
        return v.reshape(shape)

    def flat_mv(v):                  # v -> (A M^{-1} v) flattened
        return mv_in(M(unravel(v))).reshape(-1)

    def norm(a):
        return torch.sqrt(dv.dot(a, a, policy))

    zero = torch.zeros((), dtype=dtype, device=b.device)
    x = torch.zeros_like(b_flat) if x0 is None else x0.reshape(-1).clone()
    target = torch.clamp(tol * torch.linalg.vector_norm(b_flat), min=atol)
    # left preconditioning: the inner iteration controls the
    # PRECONDITIONED residual; the exit report stays on the truth
    target_in = torch.clamp(tol * torch.linalg.vector_norm(bin_flat),
                            min=atol)
    r0 = bin_flat - mv_in(unravel(x)).reshape(-1)
    conv = torch.linalg.vector_norm(r0) <= target_in
    iters = _int(0, b)
    restarts = 0
    while restarts < max_restarts and _trip(~conv):
        # x lives in solution space: (inner) residual is M_L^{-1}(b - A x)
        r = bin_flat - mv_in(unravel(x)).reshape(-1)
        beta = norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        V[0] = torch.where(beta > 0, r / torch.where(beta > 0, beta, 1.0), r)
        # FGMRES keeps the preconditioned basis Z[j] = M^{-1} V[j]
        Z = torch.zeros((m if flexible else 0, n), dtype=dtype,
                        device=b.device)
        Hcols = [torch.zeros((m + 1,), dtype=dtype, device=b.device)
                 for _ in range(m)]
        cs, sn = [zero] * m, [zero] * m
        g = [beta] + [zero] * m
        done = torch.zeros((), dtype=torch.bool, device=b.device)
        nit = _int(0, b)
        for j in range(m):
            # one Arnoldi step; once `done` its updates are frozen (the
            # step still runs, as the reference's fixed-count loop does)
            if flexible:
                zj = M(unravel(V[j])).reshape(-1)
                w = mv_in(unravel(zj)).reshape(-1)
            else:
                w = flat_mv(V[j])
            # modified Gram-Schmidt against V[0..j] (the reference's
            # masked terms for i > j add exactly 0)
            hcol = [zero] * (m + 1)
            for i in range(j + 1):
                hij = dv.dot(V[i], w, policy)
                w = w - hij * V[i]
                hcol[i] = hij
            hj1 = norm(w)
            hcol[j + 1] = hj1
            v_next = torch.where(hj1 > 0,
                                 w / torch.where(hj1 > 0, hj1, 1.0), w)
            with torch.profiler.record_function(HESSENBERG):
                # previous Givens rotations on the new column
                for i in range(j):
                    t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                    hcol[i] = t
                # the rotation that zeroes hcol[j+1]
                denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                pos = denom > 0
                c = torch.where(pos, hcol[j] / torch.where(pos, denom, 1.0),
                                1.0)
                s = torch.where(pos,
                                hcol[j + 1] / torch.where(pos, denom, 1.0),
                                0.0)
                hcol[j], hcol[j + 1] = denom, zero
                gj1 = -s * g[j]
                gj = c * g[j]
                # commit unless done before this step (the old values
                # of V[j+1], Z[j], H[:, j], cs[j], sn[j], g[j+1] are 0)
                keep = done
                Hcols[j] = torch.where(keep, Hcols[j], torch.stack(hcol))
                cs[j] = torch.where(keep, cs[j], c)
                sn[j] = torch.where(keep, sn[j], s)
                g[j] = torch.where(keep, g[j], gj)
                g[j + 1] = torch.where(keep, g[j + 1], gj1)
                nit = nit + (~keep).to(torch.int32)
                done = done | (gj1.abs() <= target_in) | (hj1 == 0.0)
            V[j + 1] = torch.where(keep, V[j + 1], v_next)
            if flexible:
                Z[j] = torch.where(keep, Z[j], zj)
        # back substitution on the m x m triangular system (frozen
        # columns have H[j,j] = 0 and g[j] = 0: guard the division)
        with torch.profiler.record_function(HESSENBERG):
            H = torch.stack(Hcols, dim=1)            # (m+1, m)
            y = torch.zeros((m,), dtype=dtype, device=b.device)
            for j in range(m - 1, -1, -1):
                sj = g[j] - torch.dot(H[j], y)
                hjj = H[j, j]
                y[j] = torch.where(hjj != 0,
                                   sj / torch.where(hjj != 0, hjj, 1.0), 0.0)
        if flexible:
            x = x + y @ Z
        else:
            x = x + M(unravel(y @ V[:m])).reshape(-1)
        # |g[m]| is the rotation estimate of the residual
        conv = g[m].abs() <= target_in
        iters = iters + nit
        restarts += 1
    rn = torch.linalg.vector_norm(b_flat - matvec(unravel(x)).reshape(-1))
    # exact psolve count: (ml + mr) per Arnoldi step, ml per cycle
    # (initial residual) plus, non-flexible only, mr per cycle (final
    # correction), plus 2*ml before the loop (M_L b and the residual)
    nps = iters * (ml + mr) + \
        restarts * (ml + (0 if flexible else mr)) + 2 * ml
    return unravel(x), SolveStats(iters=iters, res_norm=rn,
                                  converged=rn <= target, npsolves=nps)


def fgmres(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
           atol: float = 0.0, restart: int = 30, max_restarts: int = 10,
           precond: Optional[Callable] = None,
           precond_left: Optional[Callable] = None,
           policy: Optional[ExecPolicy] = None, mem=None):
    """Flexible GMRES (SPFGMR): :func:`gmres` with ``flexible=True``."""
    return gmres(matvec, b, x0, tol=tol, atol=atol, restart=restart,
                 max_restarts=max_restarts, precond=precond,
                 precond_left=precond_left, policy=policy, flexible=True,
                 mem=mem)


# ----------------------------------------------------------------------------
# Conjugate Gradient (PCG)
# ----------------------------------------------------------------------------


def pcg(matvec: Callable, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
        maxiter: int = 200, precond: Optional[Callable] = None,
        precond_left: Optional[Callable] = None,
        policy: Optional[ExecPolicy] = None, mem=None):
    """Preconditioned CG for SPD systems.  CG has ONE canonical
    preconditioner slot, ``z = M^{-1} r``; ``precond_left`` maps onto
    it.  ``precond=None`` is plain CG and ``npsolves`` stays 0."""
    _real(b)
    if precond is None and precond_left is not None:
        precond = precond_left
    mp = 1 if precond is not None else 0
    M = precond or _identity
    if mem is not None:
        mem.register("pcg.work", (4, b.numel()), b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = dv.linear_sum(1.0, b, -1.0, matvec(x), policy)
    z = M(r)
    p = z
    rz = dv.dot(r, z, policy)
    target = torch.clamp(tol * torch.sqrt(dv.dot(b, b, policy)), min=atol)
    it = 0
    while it < maxiter and _trip(torch.sqrt(dv.dot(r, r, policy)) > target):
        Ap = matvec(p)
        alpha = rz / dv.dot(p, Ap, policy)
        x = dv.axpy(alpha, p, x, policy)
        r = dv.axpy(-alpha, Ap, r, policy)
        z = M(r)
        rz_new = dv.dot(r, z, policy)
        beta = rz_new / rz
        p = dv.linear_sum(1.0, z, beta, p, policy)
        rz = rz_new
        it += 1
    # uniform convention: true residual at exit, not the recursive one
    rt = dv.linear_sum(1.0, b, -1.0, matvec(x), policy)
    rn = torch.sqrt(dv.dot(rt, rt, policy))
    # exact psolve count: one z = M r before the loop, one per iteration
    return x, SolveStats(iters=_int(it, b), res_norm=rn,
                         converged=rn <= target,
                         npsolves=_int((it + 1) * mp, b))


# ----------------------------------------------------------------------------
# BiCGStab
# ----------------------------------------------------------------------------


def bicgstab(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
             atol: float = 0.0, maxiter: int = 200,
             precond: Optional[Callable] = None,
             precond_left: Optional[Callable] = None,
             policy: Optional[ExecPolicy] = None, mem=None):
    _real(b)
    M = precond or _identity
    mr = 1 if precond is not None else 0
    mv_in, b_in, ml = _left_wrap(matvec, b, precond_left)
    if mem is not None:
        mem.register("spbcgs.work", (8, b.numel()), b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = dv.linear_sum(1.0, b_in, -1.0, mv_in(x), policy)
    rhat = r
    rho = dv.dot(rhat, r, policy)
    p = r
    target = torch.clamp(tol * torch.sqrt(dv.dot(b, b, policy)), min=atol)
    # the inner loop controls the (left-)preconditioned residual
    target_in = torch.clamp(tol * torch.sqrt(dv.dot(b_in, b_in, policy)),
                            min=atol)
    brk = torch.zeros((), dtype=torch.bool, device=b.device)
    it = 0
    while it < maxiter and _trip(
            (torch.sqrt(dv.dot(r, r, policy)) > target_in) & ~brk):
        ph = M(p)
        v = mv_in(ph)
        denom = dv.dot(rhat, v, policy)
        alpha = rho / _nz(denom)
        s = dv.axpy(-alpha, v, r, policy)
        sh = M(s)
        t = mv_in(sh)
        tt = dv.dot(t, t, policy)
        omega = dv.dot(t, s, policy) / _nz(tt)
        x_new = dv.linear_combination([1.0, alpha, omega], [x, ph, sh],
                                      policy)
        r_new = dv.axpy(-omega, t, s, policy)
        rho_new = dv.dot(rhat, r_new, policy)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p_new = dv.linear_combination([1.0, beta, -beta * omega],
                                      [r_new, p, v], policy)
        # breakdowns must not poison the carry this iteration:
        #  * denom = <rhat, v> = 0: alpha is garbage -> freeze everything;
        #  * tt = <t, t> = 0: the "lucky" breakdown after the BiCG
        #    half-step: commit the half-update x + alpha p_hat, whose
        #    residual is s
        brk_denom = denom == 0
        brk_tt = ~brk_denom & (tt == 0)
        brk = brk_denom | brk_tt
        x_half = dv.axpy(alpha, ph, x, policy)
        x = torch.where(brk_denom, x, torch.where(brk_tt, x_half, x_new))
        r = torch.where(brk_denom, r, torch.where(brk_tt, s, r_new))
        p = torch.where(brk, p, p_new)
        rho = torch.where(brk, rho, rho_new)
        it += 1
    # uniform convention: true residual at exit, not the recursive one
    rt = dv.linear_sum(1.0, b, -1.0, matvec(x), policy)
    rn = torch.sqrt(dv.dot(rt, rt, policy))
    # exact psolve count: 2 right (ph, sh) + 2 left (inside each of the
    # two matvecs) per iteration, plus 2*ml before the loop
    return x, SolveStats(iters=_int(it, b), res_norm=rn,
                         converged=rn <= target,
                         npsolves=_int(it * 2 * (mr + ml) + 2 * ml, b))


# ----------------------------------------------------------------------------
# TFQMR (transpose-free QMR)
# ----------------------------------------------------------------------------


def tfqmr(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 200,
          precond: Optional[Callable] = None,
          precond_left: Optional[Callable] = None,
          policy: Optional[ExecPolicy] = None, mem=None):
    _real(b)
    M = precond or _identity
    mr = 1 if precond is not None else 0
    mv_in, b_in, ml = _left_wrap(matvec, b, precond_left)
    if mem is not None:
        mem.register("sptfqmr.work", (7, b.numel()), b.dtype)

    def amv(v):
        return mv_in(M(v))

    u = torch.zeros_like(b) if x0 is None else x0
    r0 = dv.linear_sum(1.0, b_in, -1.0, mv_in(u), policy)
    w = r0
    y = r0
    v = amv(y)
    d = torch.zeros_like(b)
    tau = torch.sqrt(dv.dot(r0, r0, policy))
    theta = torch.zeros((), dtype=tau.dtype, device=b.device)
    eta = torch.zeros((), dtype=tau.dtype, device=b.device)
    rho = dv.dot(r0, r0, policy)
    target = torch.clamp(tol * torch.sqrt(dv.dot(b, b, policy)), min=atol)
    # tau tracks the (left-)preconditioned residual estimate
    target_in = torch.clamp(tol * torch.sqrt(dv.dot(b_in, b_in, policy)),
                            min=atol)
    brk = torch.zeros((), dtype=torch.bool, device=b.device)
    it = 0
    while it < maxiter and _trip((tau > target_in) & ~brk):
        sigma = dv.dot(r0, v, policy)
        alpha = rho / _nz(sigma)
        # two half-iterations
        y2 = dv.axpy(-alpha, v, y, policy)
        for ym in (y, y2):
            w = dv.axpy(-alpha, amv(ym), w, policy)
            d = dv.linear_sum(1.0, ym, (theta ** 2) * eta / _nz(alpha), d,
                              policy)
            theta = torch.sqrt(dv.dot(w, w, policy)) / _nz(tau)
            cfac = 1.0 / torch.sqrt(1.0 + theta ** 2)
            tau = tau * theta * cfac
            eta = (cfac ** 2) * alpha
            u = dv.axpy(eta, d, u, policy)
        rho_new = dv.dot(r0, w, policy)
        beta = rho_new / _nz(rho)
        y = dv.axpy(beta, y2, w, policy)
        # v = A y_new + beta (A y2 + beta v)   (Freund's transpose-free QMR)
        v = dv.linear_sum(1.0, amv(y), beta,
                          dv.linear_sum(1.0, amv(y2), beta, v, policy),
                          policy)
        brk = (sigma == 0) | (rho == 0)
        rho = rho_new
        it += 1
    x = M(u) if precond is not None else u
    r = dv.linear_sum(1.0, b, -1.0, matvec(x), policy)
    rn = torch.sqrt(dv.dot(r, r, policy))
    # exact psolve count: right, 4 amv per iteration + the initial
    # v = amv(y) + the final x = M u; left, those same amv calls plus
    # M_L b and the initial residual's matvec
    nps = it * 4 * (mr + ml) + mr * 2 + ml * 3
    return x, SolveStats(iters=_int(it, b), res_norm=rn,
                         converged=rn <= target, npsolves=_int(nps, b))
