"""Ensemble (submodel) integration: many small independent systems
advanced together, each with its own step size (and, for BDF, order).

Counterpart of ``repro.core.batched`` (``batched.py:204-1074``):

* :func:`ensemble_erk_integrate` — adaptive explicit RK (nonstiff);
* :func:`ensemble_dirk_integrate` — adaptive DIRK whose stage Newton
  runs a fixed number of iterations, each a batched block solve;
* :func:`ensemble_bdf_integrate` — CVODE-style adaptive order and step,
  convergence-tested modified Newton with Jacobian reuse;
* :func:`ensemble_bdf_integrate_sharded` — the same, its systems
  sharded over the ranks of a ``("systems",)`` layout
  (:mod:`repro_torch.launch.mesh`), one integrator per device.

The reference runs its step loops and the BDF Newton loop as
``lax.while_loop``s on the device; here they are Python loops that read
each loop condition with ONE device->host sync per trip (:func:`_read`,
counted in :data:`loop_counts`), and the two ``lax.cond``s of the BDF
lsetup become one host branch fed by one sync.  The DIRK stage Newton
has a fixed trip count and needs no sync.  Every constant of the
reference is kept.

The ERK and DIRK loops follow the reference's bodies line for line. The
DIRK loop keeps its state in SoA layout throughout (its error terms then
reach ``wrms_soa`` without a transpose); each stage Newton iteration is
one fused residual and one batched Gauss-Jordan solve
(``block_solve_soa``), and each stage ends with two ``wrms_soa``.

BDF layout: structure of arrays with the system axis LAST, as in the
reference: history ``Z (QMAX+1, n, nsys)``, Newton iterate and weights
``(n, nsys)``, saved inverse ``(n, n, nsys)``.  Each Newton iteration is
the solver's ``LinearSolver.soa_newton_update``: for ``BlockDiagGJ()``
at n <= 8 one launch of ``newton_update_soa`` (the residual, the SpMV
against the saved inverse, the gamma-drift correction, the masked update
and the correction norm); otherwise one fused residual, the solver's
lsolve (with ``BlockDiagGJ(factor_once=False)`` a block solve) and one
fused masked update + correction norm.  Twice a step the history is
rebuilt by ``lagrange_rescale_soa`` (``history_rescale_soa`` with its
Lagrange matrix formed from each system's eta and history count inside
the kernel) and once a step the error test runs ``wrms_soa``; lsetup
inverts the Newton blocks (for ``BlockDiagGJ()`` at n <= 8 one launch of
``newton_block_inverse_soa``, the blocks formed inside the inverse).
These ops are the CUDA kernels of :mod:`repro_torch.kernels` on the
card.

The BDF loop owns its state: the counters are updated in place, and each
step's new history replaces the old one, so PyTorch's caching allocator
hands the same blocks back from step to step.  Any linear solver of
:mod:`repro_torch.core.linsol` plugs in (``linear_solver=``); its saved
object is a tensor or a tuple of tensors, each with the system axis
last, and a partial lsetup merges it leaf by leaf.  ``jac_sparsity``
binds a static pattern to the solver (``with_sparsity``), as in the
reference.  The inner-iteration and psolve counts of the Krylov solvers
stay device tensors (no read per Newton iteration).

Warm start (:class:`SolverSession`, ``session=`` / ``return_session=``)
and step telemetry (``telemetry=K``, a ring of
:mod:`repro_torch.observability.telemetry` on the solve's device) follow
the reference.  A telemetry record stores values the step computed
anyway, with no host read, so the loop's syncs and bits are those of a
run without it.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch

from . import controller as ctrl
from . import cvode as _cv
from . import dispatch as dv
from . import status
from .arkode import ODEOptions
from .butcher import ButcherTable
from ..observability.telemetry import ring_init, ring_record
from .linsol import BlockDiagGJ, encode_sparsity, newton_blocks_soa
# the host loops' counted reads and trip counts (shared with krylov)
from .loops import loop_counts, reset_loop_counts  # noqa: F401
from .loops import read as _read
from .loops import region as _region


def _wrap_soa(f, jac, f_soa, jac_soa):
    """SoA forms of the AoS batch callables when no native ones are
    given: a transpose at the call boundary only (made contiguous, as
    the kernels take contiguous tensors)."""
    if f_soa is None:
        f_soa = lambda t, z: f(t, z.T).T.contiguous()
    if jac_soa is None:
        jac_soa = lambda t, z: jac(t, z.T).permute(1, 2, 0).contiguous()
    return f_soa, jac_soa


def _merge(need: torch.Tensor, new, old):
    """``where(need, new, old)`` on every leaf of a saved linear object
    (a tensor or nested tuples of them, system axis last)."""
    if isinstance(new, tuple):
        return tuple(_merge(need, a, b) for a, b in zip(new, old))
    return torch.where(need, new, old)


class EnsembleStats(NamedTuple):
    steps: torch.Tensor       # (nsys,) accepted steps per system
    attempts: torch.Tensor
    netf: torch.Tensor
    nni: torch.Tensor
    success: torch.Tensor     # (nsys,) bool
    nsetups: Optional[torch.Tensor] = None   # (nsys,) lsetup count
    ncfn: Optional[torch.Tensor] = None      # (nsys,) Newton conv failures
    nli: Optional[torch.Tensor] = None       # (nsys,) linear iterations
    npsolves: Optional[torch.Tensor] = None  # (nsys,) preconditioner solves
    retcodes: Optional[torch.Tensor] = None  # (nsys,) int32, 0 == SUCCESS
    ok: Optional[torch.Tensor] = None        # (nsys,) bool, retcodes == 0

    def masked(self, live) -> "EnsembleStats":
        """The stats of the ``live`` lanes of a padded bundle (reference
        ``batched.py:112``).

        A dead lane (a ``tf == t0`` no-op) did no work: its per-lane
        counters are zeroed, its retcode is 0 and it reports success, so
        sums over the batch describe live systems only.  ``nli`` and
        ``npsolves`` are totals of the batched inner solves, broadcast
        over the lanes, and pass through unchanged.
        """
        live = torch.as_tensor(live, dtype=torch.bool,
                               device=self.steps.device)

        def z(x):
            return None if x is None else torch.where(live, x, 0)

        return self._replace(
            steps=z(self.steps), attempts=z(self.attempts),
            netf=z(self.netf), nni=z(self.nni),
            success=self.success | ~live,
            nsetups=z(self.nsetups), ncfn=z(self.ncfn),
            retcodes=z(self.retcodes),
            ok=None if self.ok is None else self.ok | ~live)


class SolverSession(NamedTuple):
    """Warm-start continuation state of ``ensemble_bdf`` (reference
    ``batched.py:138-202``).

    The final step-loop state of one integration, exported with
    ``return_session=True`` and taken back with ``session=``, so a
    client that integrates again from where it stopped (a coupling step
    of a reacting-flow code) re-enters at its last order and step size
    instead of the cold order-1 start.  Every leaf keeps the system axis
    LAST, so :meth:`lanes` and :meth:`concat` slice and join bundles.

    ``h <= 0`` marks a cold lane: re-entry takes the default ``h0``
    there, which is how :meth:`cold` reproduces the plain ``y0`` start
    bit for bit.  The integrator clones every leaf it takes, so the
    caller's handle is unchanged by the call, and exports the loop's
    outputs.
    """

    t: torch.Tensor       # (nsys,) time reached
    h: torch.Tensor       # (nsys,) step size; <= 0 marks a cold lane
    q: torch.Tensor       # (nsys,) int32 current BDF order
    Z: torch.Tensor       # (QMAX+1, n, nsys) uniform-grid history
    e1: torch.Tensor      # (nsys,) controller err_prev
    e2: torch.Tensor      # (nsys,) controller err_prev2
    steps: torch.Tensor   # (nsys,) int32 cumulative accepted steps
    #                       (bounds how much of Z is valid history)

    @property
    def nsys(self) -> int:
        return self.Z.shape[-1]

    @property
    def n(self) -> int:
        return self.Z.shape[-2]

    @classmethod
    def cold(cls, y0: torch.Tensor, t0) -> "SolverSession":
        """A cold-start session for ``y0`` (nsys, n) at ``t0``: the same
        bits as passing ``y0`` without a session."""
        nsys, n = y0.shape
        dtype, dev = y0.dtype, y0.device
        Z = torch.zeros((_cv.QMAX + 1, n, nsys), dtype=dtype, device=dev)
        Z[0] = y0.T
        return cls(
            t=torch.as_tensor(t0, dtype=dtype, device=dev).expand(nsys)
            .clone(),
            h=torch.zeros((nsys,), dtype=dtype, device=dev),
            q=torch.ones((nsys,), dtype=torch.int32, device=dev), Z=Z,
            e1=torch.ones((nsys,), dtype=dtype, device=dev),
            e2=torch.ones((nsys,), dtype=dtype, device=dev),
            steps=torch.zeros((nsys,), dtype=torch.int32, device=dev))

    def lanes(self, idx) -> "SolverSession":
        """The session of lane(s) ``idx``, kept as a system axis (pass a
        slice or an index tensor so the result can be concatenated)."""
        return SolverSession(*(x[..., idx] for x in self))

    @staticmethod
    def concat(sessions) -> "SolverSession":
        """Join sessions along the system axis (mixed warm and cold
        bundles)."""
        return SolverSession(*(torch.cat(xs, dim=-1)
                               for xs in zip(*sessions)))


def _start(t0, tf, opts: ODEOptions, nsys: int, dtype, dev):
    """``(t, tf, h)`` per system: ``opts.h0`` seeds the step, else
    ``max(1e-6*(tf - t0), 1e-12)``."""
    t = torch.as_tensor(t0, dtype=dtype, device=dev).expand(nsys).clone()
    tf = torch.as_tensor(tf, dtype=dtype, device=dev).expand(nsys)
    if opts.h0 > 0:
        h = torch.full((nsys,), opts.h0, dtype=dtype, device=dev)
    else:
        h = torch.clamp(1e-6 * (tf - t), min=1e-12)
    return t, tf, h


def _pi_eta(cfg, err, e1, p: int, accept, active):
    """The ERK/DIRK per-system PI controller: ``(eta, e)`` with
    ``e = max(err, 1e-10)``; a rejected active step shrinks by >= 0.3."""
    e = torch.clamp(err, min=1e-10)
    eprev = torch.clamp(e1, min=1e-10)
    eta = cfg.safety * e ** (-cfg.k1 / p) * eprev ** (cfg.k2 / p)
    eta = torch.clamp(eta, cfg.eta_min, cfg.eta_max)
    eta = torch.where(accept | ~active, eta, torch.clamp(eta, max=0.3))
    return eta, e


def ensemble_erk_integrate(f: Callable, y0: torch.Tensor, t0, tf,
                           table: ButcherTable,
                           opts: ODEOptions = ODEOptions()):
    """Adaptive ERK over a batch of independent systems; returns
    ``(y (nsys, n), EnsembleStats)``.

    f  : (t:(nsys,), y:(nsys, n)) -> (nsys, n)   vectorized RHS
    y0 : (nsys, n);  t0, tf broadcastable to (nsys,)

    Each system carries its own (t, h).  A table without an embedding
    gives no error estimate, so the step stays fixed (halved only on a
    non-finite step), as in the reference.  The carry stays in the
    caller's layout (nsys, n); the error test hands ``wrms_soa``
    contiguous SoA copies of the error and the weights.
    """
    nsys, n = y0.shape
    has_emb = table.b_emb is not None
    dtype, dev = y0.dtype, y0.device
    t, tf, h = _start(t0, tf, opts, nsys, dtype, dev)
    p = max(table.emb_order + 1, 2)
    i32 = torch.int32
    y = y0
    e1 = torch.ones((nsys,), dtype=dtype, device=dev)
    steps, att, netf = (torch.zeros((nsys,), dtype=i32, device=dev)
                        for _ in range(3))
    stall = torch.zeros((nsys,), dtype=torch.bool, device=dev)
    tf_run = tf * (1 - 1e-12)

    while True:
        active = (t < tf_run) & ~stall
        if not _read(active.any() & (att < opts.max_steps).all()):
            break
        loop_counts["step_trips"] += 1
        hs = torch.minimum(h, tf - t)
        ks = []
        for i in range(table.stages):
            yi = y
            for j in range(i):
                if table.A[i][j] != 0.0:
                    yi = yi + (hs * table.A[i][j])[:, None] * ks[j]
            ks.append(f(t + table.c[i] * hs, yi))
        y_new = y
        for bi, k in zip(table.b, ks):
            if bi != 0.0:
                y_new = y_new + (hs * bi)[:, None] * k
        y_err = torch.zeros_like(y)
        if has_emb:
            for bi, bh, k in zip(table.b, table.b_emb, ks):
                if (bi - bh) != 0.0:
                    y_err = y_err + (hs * (bi - bh))[:, None] * k
        w = 1.0 / (opts.rtol * y.abs() + opts.atol)
        err = dv.wrms_soa(y_err.T.contiguous(), w.T.contiguous(),
                          opts.policy)
        bad = ~torch.isfinite(err) | ~torch.isfinite(y_new).all(dim=1)
        err = torch.where(bad, 2.0, err)
        accept = (err <= 1.0) & ~bad & active
        if has_emb:
            eta, e = _pi_eta(opts.controller, err, e1, p, accept, active)
        else:
            # no error signal: keep h, halve it only on a non-finite step
            e = torch.clamp(err, min=1e-10)
            eta = torch.ones_like(e).masked_fill_(bad & active, 0.5)
        t = torch.where(accept, t + hs, t)
        y = torch.where(accept[:, None], y_new, y)
        h_next = torch.where(active, torch.clamp(hs * eta, min=1e-14), h)
        stall = stall | (active & (h_next < 1e-13))
        e1 = torch.where(accept, e, e1)
        h = h_next
        steps += accept.to(i32)
        att += active.to(i32)
        netf += (active & ~accept).to(i32)

    return y, EnsembleStats(steps=steps, attempts=att, netf=netf,
                            nni=torch.zeros_like(steps),
                            success=t >= tf * (1 - 1e-10))


def ensemble_dirk_integrate(fi: Callable, jac: Callable, y0: torch.Tensor,
                            t0, tf, table: ButcherTable,
                            opts: ODEOptions = ODEOptions(), policy=None,
                            newton_iters: int = 4,
                            f_soa: Optional[Callable] = None,
                            jac_soa: Optional[Callable] = None,
                            telemetry: Optional[int] = None):
    """Adaptive DIRK over a batch of independent stiff systems with the
    batched block-diagonal Newton solve; returns ``(y (nsys, n),
    EnsembleStats)``.

    fi  : (t:(nsys,), y:(nsys,n)) -> (nsys,n)
    jac : (t:(nsys,), y:(nsys,n)) -> (nsys,n,n)   per-system Jacobian
    ``f_soa``/``jac_soa`` are native SoA forms (``y:(n,nsys)``).
    policy : an ExecPolicy; None takes ``opts.policy``.

    Each implicit stage runs ``newton_iters`` Newton iterations with no
    convergence test inside the loop (so no host sync): every iteration
    re-evaluates the Jacobian, forms ``M = I - h*a_ii*J`` and solves it
    with ``block_solve_soa``.  The stage is then accepted on the WRMS of
    its residual.  Failed lanes are quarantined with a CV_*-style
    retcode, as in the BDF loop.

    ``telemetry=K`` records each attempt in a K-slot ring on y0's device
    (reference ``batched.py:442-470``: ``q`` is the method's order, no
    lsetup) and returns ``(y, stats, ring)``.
    """
    policy = opts.policy if policy is None else policy
    nsys, n = y0.shape
    dtype, dev = y0.dtype, y0.device
    f_s, jac_s = _wrap_soa(fi, jac, f_soa, jac_soa)
    t, tf, h = _start(t0, tf, opts, nsys, dtype, dev)
    p = max(table.emb_order + 1, 2)
    unit_w = torch.ones((n, nsys), dtype=dtype, device=dev)
    i32 = torch.int32

    def zeros_i32():
        return torch.zeros((nsys,), dtype=i32, device=dev)

    y = y0.T.contiguous()                        # (n, nsys)
    e1 = torch.ones((nsys,), dtype=dtype, device=dev)
    steps, att, netf, nni, rc, ncf_cur, nef_cur = (zeros_i32()
                                                   for _ in range(7))
    tf_run = tf * (1 - 1e-12)
    ring = None if telemetry is None else ring_init(telemetry, (nsys,),
                                                    dtype, dev)

    while True:
        active = (t < tf_run) & (rc == 0)
        # the integer att backstop never binds, as in the BDF loop
        if not _read(active.any() & (att <= opts.max_steps).all()):
            break
        loop_counts["step_trips"] += 1
        ai = active.to(i32)
        hs = torch.minimum(h, tf - t)
        ks = []
        nl_ok = torch.ones((nsys,), dtype=torch.bool, device=dev)
        nni_step = zeros_i32()
        for i in range(table.stages):
            r = y
            for j in range(i):
                if table.A[i][j] != 0.0:
                    r = r + (hs * table.A[i][j])[None, :] * ks[j]
            aii = table.A[i][i]
            ti = t + table.c[i] * hs
            if aii == 0.0:
                ks.append(f_s(ti, r))
                continue
            gam = hs * aii
            z = r
            for _ in range(newton_iters):
                with _region("ensemble_dirk:newton"):
                    loop_counts["newton_trips"] += 1
                    rhs = dv.newton_residual_soa(z, f_s(ti, z), r, gam,
                                                 policy, negate=True)
                    M = newton_blocks_soa(jac_s(ti, z), gam)
                    z = z + dv.block_solve_soa(M, rhs, policy)
                    # nni counts per ACTIVE system
                    nni_step += ai
            fz = f_s(ti, z)           # final RHS: residual AND stage
            g = dv.newton_residual_soa(z, fz, r, gam, policy)
            res = dv.wrms_soa(g, unit_w, policy)
            tol_nl = opts.newton_tol_fac * (
                opts.rtol * dv.wrms_soa(z, unit_w, policy) + opts.atol)
            nl_ok = nl_ok & ((res <= torch.clamp(tol_nl, min=1e-12)) |
                             ~active)
            ks.append(fz)
        y_new = y
        for bi, k in zip(table.b, ks):
            if bi != 0.0:
                y_new = y_new + (hs * bi)[None, :] * k
        y_err = torch.zeros_like(y)
        if table.b_emb is not None:
            for bi, bh, k in zip(table.b, table.b_emb, ks):
                if (bi - bh) != 0.0:
                    y_err = y_err + (hs * (bi - bh))[None, :] * k
        w = 1.0 / (opts.rtol * y.abs() + opts.atol)
        err_raw = dv.wrms_soa(y_err, w, policy)
        bad = ~torch.isfinite(err_raw) | ~nl_ok
        err = torch.where(bad, 2.0, err_raw)
        accept = (err <= 1.0) & ~bad & active
        eta, e = _pi_eta(opts.controller, err, e1, p, accept, active)
        eta = torch.where(nl_ok | ~active, eta, opts.eta_cf)
        t_new = t + hs
        if ring is not None:
            ring = ring_record(ring, (t_new, hs, p, nni_step, err, False,
                                      nl_ok, accept, active))
        t = torch.where(accept, t_new, t)
        y = torch.where(accept[None, :], y_new, y)
        h_next = torch.where(active, torch.clamp(hs * eta, min=1e-14), h)
        e1 = torch.where(accept, e, e1)

        # ---- per-lane retcode escalation, same contract as the BDF
        # loop: decided only for active lanes, sticky once nonzero
        ncf = active & ~nl_ok
        etf = active & nl_ok & ~accept & torch.isfinite(err_raw)
        ncf_cur = torch.where(accept, 0, ncf_cur + ncf.to(i32))
        nef_cur = torch.where(accept, 0, nef_cur + etf.to(i32))
        # relative step-size underflow: t + h == t
        hfail = active & (t + h_next == t)
        nanstep = active & nl_ok & ~torch.isfinite(err_raw)
        att += ai
        unfinished = t < tf_run
        rc = torch.where(active & unfinished & (att >= opts.max_steps),
                         status.TOO_MUCH_WORK, rc)
        rc = torch.where(active & ((nef_cur >= status.MXNEF) |
                                   (hfail & nl_ok)), status.ERR_FAILURE, rc)
        rc = torch.where(active & ((ncf_cur >= status.MXNCF) |
                                   (hfail & ~nl_ok)), status.CONV_FAILURE, rc)
        rc = torch.where(nanstep, status.RHSFUNC_FAIL, rc)

        h = h_next
        steps += accept.to(i32)
        netf += (active & ~accept).to(i32)
        nni += nni_step

    tf_end = tf * (1 - 1e-10)
    retcodes = torch.where((rc == 0) & (t < tf_end), status.TOO_MUCH_WORK, rc)
    st = EnsembleStats(steps=steps, attempts=att, netf=netf, nni=nni,
                       success=t >= tf_end, retcodes=retcodes,
                       ok=retcodes == 0)
    if ring is not None:
        return y.T.contiguous(), st, ring
    return y.T.contiguous(), st


def ensemble_bdf_integrate(f: Callable, jac: Callable, y0: torch.Tensor,
                           t0, tf, *, order: int = 5,
                           opts: ODEOptions = ODEOptions(),
                           policy=None, linear_solver=None,
                           lin_mode: Optional[str] = None,
                           jac_sparsity=None, msbp: int = 20,
                           dgmax: float = 0.3, mem=None,
                           f_soa: Optional[Callable] = None,
                           jac_soa: Optional[Callable] = None,
                           session=None, return_session: bool = False,
                           telemetry: Optional[int] = None):
    """Adaptive batched BDF (orders 1-``order``) over ``nsys`` stiff
    systems; returns ``(y (nsys, n), EnsembleStats)``.

    f   : (t:(nsys,), y:(nsys,n)) -> (nsys,n)   vectorized RHS
    jac : (t:(nsys,), y:(nsys,n)) -> (nsys,n,n) per-system Jacobian
    y0  : (nsys, n) on the device the run uses; t0, tf broadcastable to
          (nsys,).  ``f_soa``/``jac_soa`` (``y:(n,nsys)``) are native SoA
          forms that skip the boundary transposes.
    policy : an ExecPolicy; None takes ``opts.policy``.

    The corrector is CVODE's modified Newton: the Newton matrix is
    refreshed only on the first step, after a convergence failure,
    every ``msbp`` attempts, or when gamma drifted by more than
    ``dgmax``.  A refresh evaluates ``jac`` over ALL systems and merges
    where needed, as in the reference.  Failed lanes are quarantined
    with a CV_*-style retcode (:mod:`repro_torch.core.status`).

    linear_solver : any solver of :mod:`repro_torch.core.linsol`;
    None is ``BlockDiagGJ()``.  jac_sparsity : an (n, n) boolean
    pattern, bound to the solver; a sparse solver then keeps only the
    pattern's values.  A Krylov solver runs one global iteration over
    all systems per Newton iteration, and ``stats.nli`` /
    ``stats.npsolves`` count its inner iterations and psolves (totals,
    broadcast over the systems, as in the reference).
    ``lin_mode='setup' | 'direct'`` is the reference's deprecated string
    form of ``BlockDiagGJ(factor_once=True | False)``; it warns.

    **Warm start** (reference ``batched.py:670-975``).  ``session=``
    re-enters the loop from a :class:`SolverSession` exported by an
    earlier call with ``return_session=True`` (which returns ``(y,
    stats, session)``): history, order, step size and controller memory
    resume per lane, from ``t0 = session.t``.  ``y0`` may then be None
    (a given one must have the session's shape).  Lanes with ``h <= 0``
    start cold with the default ``h0``.  The saved linear object is not
    part of the session: the first warm step refreshes it.
    ``stats.steps`` counts this call's accepted steps; ``session.steps``
    stays cumulative (it bounds the valid history).  A lane that failed
    is exported cold (``h = 0``, ``q = 1``, ``e1 = e2 = 1``, ``steps =
    0``), anchored at its last accepted state ``Z[0]``.

    **Step telemetry.**  ``telemetry=K`` records ``(t, h, q, nni, err,
    lsetup, conv, accept, active)`` for each attempt of each system in a
    K-slot ring on y0's device, appended last to the returned tuple.
    """
    if lin_mode is not None:
        warnings.warn(
            "repro-compat: ensemble_bdf_integrate(lin_mode=...) is "
            "deprecated; pass linear_solver=BlockDiagGJ(factor_once="
            f"{lin_mode == 'setup'}) (or any LinearSolver with an SoA "
            "batch path)", DeprecationWarning, stacklevel=2)
        if lin_mode not in ("setup", "direct"):
            raise ValueError(f"lin_mode must be 'setup' or 'direct', got "
                             f"{lin_mode!r}")
        if linear_solver is None:
            linear_solver = BlockDiagGJ(factor_once=(lin_mode == "setup"))
    ls = BlockDiagGJ() if linear_solver is None else linear_solver
    if jac_sparsity is not None:
        ls = ls.with_sparsity(encode_sparsity(jac_sparsity))
    if not 1 <= order <= _cv.QMAX:
        raise ValueError(f"order must lie in 1..{_cv.QMAX}, got {order}")
    policy = opts.policy if policy is None else policy
    QMAX = _cv.QMAX
    if session is not None:
        n, nsys = session.n, session.nsys
        dtype, dev = session.Z.dtype, session.Z.device
        if y0 is not None and tuple(y0.shape) != (nsys, n):
            raise ValueError(
                f"y0 shape {tuple(y0.shape)} disagrees with the session "
                f"({(nsys, n)}); pass y0=None to resume from the session")
        t0 = session.t          # per-lane resume times
    elif y0 is None:
        raise ValueError("ensemble_bdf_integrate needs y0 (or a session= "
                         "to resume from)")
    else:
        nsys, n = y0.shape
        dtype, dev = y0.dtype, y0.device
    f_s, jac_s = _wrap_soa(f, jac, f_soa, jac_soa)
    if mem is not None:
        mem.register("ensemble_bdf.history", (QMAX + 1, n, nsys), dtype)
        for suffix, shape in ls.soa_workspace_shapes(n, nsys):
            mem.register(f"ensemble_bdf.{suffix}", shape, dtype)

    t, tf, h = _start(t0, tf, opts, nsys, dtype, dev)
    one = torch.ones((), dtype=dtype, device=dev)
    alpha_t, beta_t, predp_t = _cv.bdf_tables(dtype, dev)
    tiny = torch.finfo(dtype).tiny
    cfg = opts.controller
    i32 = torch.int32

    def zeros_i32():
        return torch.zeros((nsys,), dtype=i32, device=dev)

    if session is None:
        q = torch.ones((nsys,), dtype=i32, device=dev)
        Z = torch.zeros((QMAX + 1, n, nsys), dtype=dtype, device=dev)
        Z[0] = y0.T
        e1 = torch.ones((nsys,), dtype=dtype, device=dev)
        e2 = torch.ones((nsys,), dtype=dtype, device=dev)
        steps = zeros_i32()
    else:
        # every leaf the loop updates is cloned: the caller's handle
        # must survive the call
        h = torch.where(session.h > 0, session.h, h)
        q = torch.clamp(session.q, 1, order).to(i32)
        Z = session.Z.clone()
        e1, e2 = session.e1.clone(), session.e2.clone()
        steps = session.steps.to(i32).clone()
    steps0 = steps.clone()
    MJ = ls.soa_carry_init(n, nsys, dtype, dev)
    gam_saved = torch.zeros((nsys,), dtype=dtype, device=dev)
    ncf_prev = torch.zeros((nsys,), dtype=torch.bool, device=dev)
    since_jac, att, netf = (zeros_i32() for _ in range(3))
    nni, nsetups, ncfn, rc, ncf_cur, nef_cur = (zeros_i32() for _ in range(6))
    nli = torch.zeros((), dtype=i32, device=dev)
    nps = torch.zeros((), dtype=i32, device=dev)
    tf_run = tf * (1 - 1e-12)
    ring = None if telemetry is None else ring_init(telemetry, (nsys,),
                                                    dtype, dev)

    while True:
        active = (t < tf_run) & (rc == 0)
        # the integer att backstop never binds (a lane reaching max_steps
        # quarantines with TOO_MUCH_WORK first), as in the reference
        if not _read(active.any() & (att <= opts.max_steps).all()):
            break
        loop_counts["step_trips"] += 1
        hs = torch.where(active, torch.minimum(h, tf - t), h)
        nvalid = torch.clamp(steps, max=QMAX)
        # h clipped to hit tf: rescale the history.  Unclipped systems
        # have eta_clip == 1 exactly, where the rebuild is the identity,
        # so they are masked out and copied through
        eta_clip = torch.where(active, hs / h, one)
        Z = dv.lagrange_rescale_soa(eta_clip, nvalid, Z,
                                    active & (eta_clip != one), policy)
        qi = q - 1
        alphas = alpha_t[:, qi]                      # (QMAX+1, nsys)
        beta = beta_t[qi]
        pred_c = predp_t[:, torch.minimum(nvalid, q)]
        y_pred = (pred_c[:, None, :] * Z).sum(0)     # (n, nsys)
        psi = -(alphas[1:, None, :] * Z[:-1]).sum(0)
        gamma = beta * hs
        t_new = t + hs
        w = 1.0 / (opts.rtol * Z[0].abs() + opts.atol)

        # ---- lsetup where stale; one sync reads "any" and "all" ----
        gamrat = gamma / torch.where(gam_saved != 0, gam_saved, gamma)
        need = active & ((gam_saved == 0) | ncf_prev |
                         (since_jac >= msbp) | ((gamrat - 1.0).abs() > dgmax))
        any_need, all_need = _read(torch.stack([need.any(), need.all()]))
        if any_need:
            loop_counts["lsetups"] += 1
            MJ_new = ls.soa_setup(jac_s(t_new, y_pred), gamma, policy)
            MJ = MJ_new if all_need else _merge(need, MJ_new, MJ)
        gam_saved = torch.where(need, gamma, gam_saved)
        since_jac = torch.where(need, 0, since_jac)
        gamrat = torch.where(need, 1.0, gamrat)

        # ---- convergence-tested modified Newton ----
        z = y_pred
        dn_prev = torch.zeros((nsys,), dtype=dtype, device=dev)
        crate = torch.ones((nsys,), dtype=dtype, device=dev)
        conv = ~active
        div = torch.zeros((nsys,), dtype=torch.bool, device=dev)
        nni_s = zeros_i32()
        it = 0
        while it < opts.newton_max:
            iterate = active & ~conv & ~div
            if not _read(iterate.any()):
                break
            with _region("ensemble_bdf:newton"):
                loop_counts["newton_trips"] += 1
                z, dn, nli_inc, nps_inc = ls.soa_newton_update(
                    MJ, gamma, gamrat, z, f_s(t_new, z), psi, w, iterate,
                    policy, mem=mem)
                crate_new = crate
                if it > 0:
                    crate_new = torch.maximum(
                        0.3 * crate, dn / torch.clamp(dn_prev, min=1e-30))
                    div = div | (iterate & (dn > 2.0 * dn_prev))
                conv = conv | (iterate & (dn * torch.clamp(crate_new, max=1.0)
                                          < opts.newton_tol_fac))
                dn_prev = torch.where(iterate, dn, dn_prev)
                crate = torch.where(iterate, crate_new, crate)
                nni_s += iterate.to(i32)
                if torch.is_tensor(nli_inc):   # direct solvers return 0
                    nli += nli_inc
                    nps += nps_inc
            it += 1

        # ---- local error test (LTE ~ (z - pred)/(q+1), uniform grid) ----
        err_raw = dv.wrms_soa(z - y_pred, w, policy) / (q.to(dtype) + 1.0)
        bad = ~torch.isfinite(err_raw) | ~conv
        err = torch.where(bad, 2.0, err_raw)
        accept = (err <= 1.0) & ~bad & active

        eta, cst = ctrl.eta_from_error(cfg, ctrl.ControllerState(e1, e2), err,
                                       q + 1, after_failure=(~accept) & conv)
        eta = torch.where(conv | ~active, eta, opts.eta_cf)
        eta = torch.clamp(eta, 0.1, 10.0)
        # fold [hmin, hmax] into eta: the history is rescaled onto the
        # hs*eta grid, so clamping h afterwards would desync the two
        hs_safe = torch.clamp(hs, min=tiny)
        eta = torch.clamp(eta, min=opts.hmin / hs_safe, max=opts.hmax / hs_safe)
        e1 = torch.where(accept, cst.err_prev, e1)
        e2 = torch.where(accept, cst.err_prev2, e2)

        # accepted systems: shift history, insert z, ramp order
        Z_acc = torch.roll(Z, 1, 0)
        Z_acc[0] = z
        Z_next = torch.where(accept[None, None, :], Z_acc, Z)
        q_next = torch.where(accept, torch.clamp(q + 1, max=order), q)
        # rescale each system's history onto its new uniform grid
        nval_after = torch.clamp(steps + accept.to(i32), max=QMAX)
        Z = dv.lagrange_rescale_soa(torch.where(active, eta, one), nval_after,
                                    Z_next, active, policy)

        t_next = torch.where(accept, t_new, t)
        ncf = active & ~conv
        etf = (~accept) & conv & active
        ai = active.to(i32)
        att += ai

        # ---- per-lane retcode escalation (CVODE CVHandleFailure).
        # Failure is only decided for active lanes, so a quarantined
        # lane's retcode is sticky.  Priority (last write wins):
        # TOO_MUCH_WORK < ERR_FAILURE < CONV_FAILURE < RHSFUNC_FAIL
        ncf_cur = torch.where(accept, 0, ncf_cur + ncf.to(i32))
        nef_cur = torch.where(accept, 0, nef_cur + etf.to(i32))
        # relative step-size underflow: t + h == t
        hfail = active & (t + hs * eta == t)
        nanstep = active & conv & ~torch.isfinite(err_raw)
        unfinished = t_next < tf_run
        rc = torch.where(active & unfinished & (att >= opts.max_steps),
                         status.TOO_MUCH_WORK, rc)
        rc = torch.where(active & ((nef_cur >= status.MXNEF) |
                                   (hfail & conv)), status.ERR_FAILURE, rc)
        rc = torch.where(active & ((ncf_cur >= status.MXNCF) |
                                   (hfail & ~conv)), status.CONV_FAILURE, rc)
        rc = torch.where(nanstep, status.RHSFUNC_FAIL, rc)
        if ring is not None:
            ring = ring_record(ring, (t_new, hs, q, nni_s, err, need, conv,
                                      accept, active))

        t = t_next
        h = torch.where(active, hs * eta, h)
        q = q_next
        since_jac += ai
        ncf_prev = ncf
        steps += accept.to(i32)
        netf += etf.to(i32)
        nni += nni_s
        nsetups += need.to(i32)
        ncfn += ncf.to(i32)

    # a lane still marked healthy but short of tf is TOO_MUCH_WORK, so
    # retcodes == 0 <=> the lane reached tf
    tf_end = tf * (1 - 1e-10)
    retcodes = torch.where((rc == 0) & (t < tf_end), status.TOO_MUCH_WORK, rc)
    st = EnsembleStats(
        steps=steps - steps0, attempts=att, netf=netf, nni=nni,
        success=t >= tf_end, nsetups=nsetups, ncfn=ncfn,
        nli=nli.expand(nsys).clone(), npsolves=nps.expand(nsys).clone(),
        retcodes=retcodes, ok=retcodes == 0)
    out = [Z[0].T.contiguous(), st]
    if return_session:
        # quarantine hygiene: a failed lane resumes cold (h = 0, order
        # 1, no valid history) from its last accepted state Z[0]
        ok = retcodes == 0
        out.append(SolverSession(
            t=t, h=torch.where(ok, h, 0.0), q=torch.where(ok, q, 1), Z=Z,
            e1=torch.where(ok, e1, 1.0), e2=torch.where(ok, e2, 1.0),
            steps=torch.where(ok, steps, 0)))
    if ring is not None:
        out.append(ring)
    return tuple(out)


def _tree_map(fn, tree):
    """``fn`` over the tensors of a dict / tuple / list tree; None (no
    ``params``) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _all_gather_rows(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """Every rank's equal-sized shard of ``t`` joined along dim 0, bit
    for bit, on ``t``'s device.  Gloo gathers only host tensors, so a
    CUDA tensor under a group without NCCL goes through the host; bools
    travel as bytes."""
    import torch.distributed as dist
    src = t.view(torch.uint8) if t.dtype == torch.bool else t
    host = src.is_cuda and "nccl" not in str(dist.get_backend(group))
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src.contiguous(), group=group)
    out = torch.cat(parts)
    if host:
        out = out.to(t.device)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def ensemble_bdf_integrate_sharded(f: Callable, jac: Callable,
                                   y0: torch.Tensor, t0, tf, *,
                                   params=None, mesh=None,
                                   axis: str = "systems", **kw):
    """Shard :func:`ensemble_bdf_integrate` over the system axis
    (reference ``batched.py:980-1074``).

    SPMD: every rank of ``mesh`` calls it with the same global ``y0``,
    ``t0``, ``tf`` and ``params``.  The batch is padded to a multiple of
    the world size with finished dummy systems (``tf = t0``, the last
    row repeated), each rank moves its contiguous shard to its device
    (:func:`repro_torch.launch.mesh.mesh_device`) and runs the masked
    adaptive loop there on its own, with no collective and its own trip
    counts; then ``y`` and every ``EnsembleStats`` field are gathered
    to the global ``(nsys, ...)`` on every rank, ``nli`` and
    ``npsolves`` become the global totals broadcast over the lanes, and
    the padding is stripped.  A world of one runs exactly the unsharded
    call on its device.

    params : optional tree (dict, tuple, list) of per-system tensors
             (leading axis nsys), sharded alongside ``y0``; ``f``/``jac``
             are then called as ``f(t, y, params_shard)``.  Closed-over
             global ``(nsys, ...)`` tensors would NOT be sharded.
    mesh   : a 1-D ``("systems",)`` layout; None builds
             :func:`repro_torch.launch.mesh.make_ensemble_mesh` (the
             card).
    """
    from ..launch.mesh import make_ensemble_mesh, mesh_device

    # an explicit None is the documented "no native SoA form" default of
    # the non-sharded API — only an actual callable is rejected here
    if kw.pop("f_soa", None) is not None or \
            kw.pop("jac_soa", None) is not None:
        raise ValueError(
            "ensemble_bdf_integrate_sharded takes the AoS f/jac only: a "
            "native SoA callable would close over unsharded (.., nsys) "
            "arrays; route per-system data through params= instead (the "
            "per-shard SoA wrapping happens inside each device's loop)")
    if kw.pop("session", None) is not None or kw.pop("return_session",
                                                    False):
        raise ValueError(
            "ensemble_bdf_integrate_sharded takes no session=/"
            "return_session=: a SolverSession's (.., nsys) leaves would "
            "close over the shard_map body unsharded; warm-start "
            "continuation is a serving-layer (single-mesh-shard) "
            "feature for now")
    if kw.get("telemetry") is not None:
        raise ValueError("ensemble_bdf_integrate_sharded takes no "
                         "telemetry=: each rank's ring holds its own shard")
    if mesh is None:
        mesh = make_ensemble_mesh()
    if tuple(mesh.mesh_dim_names or ()) != (axis,):
        raise ValueError(f"the mesh's dimensions are {mesh.mesh_dim_names}, "
                         f"want ({axis!r},)")
    dev = mesh_device(mesh)
    world = mesh.size()
    if world == 1:
        y0, params = y0.to(dev), _tree_map(lambda p: p.to(dev), params)
        if params is None:
            return ensemble_bdf_integrate(f, jac, y0, t0, tf, **kw)
        return ensemble_bdf_integrate(lambda t, y: f(t, y, params),
                                      lambda t, y: jac(t, y, params),
                                      y0, t0, tf, **kw)
    nsys, n = y0.shape
    dtype = y0.dtype
    t0a = torch.as_tensor(t0, dtype=dtype, device=y0.device).expand(nsys)
    tfa = torch.as_tensor(tf, dtype=dtype, device=y0.device).expand(nsys)
    pad = (-nsys) % world
    if pad:
        def padded(p):
            return torch.cat([p, p[-1:].expand(pad, *p.shape[1:])])

        y0, t0a, params = padded(y0), padded(t0a), _tree_map(padded, params)
        # tf = t0 -> padded systems are inactive from the first cond
        tfa = torch.cat([tfa, t0a[-pad:]])
    shard = (nsys + pad) // world
    lo = mesh.get_local_rank() * shard

    def local(p):
        return p[lo:lo + shard].to(dev)

    y0_l, t0_l, tf_l = local(y0), local(t0a), local(tfa)
    if params is None:
        f_l, jac_l = f, jac
    else:
        params_l = _tree_map(local, params)
        f_l = lambda t, y: f(t, y, params_l)
        jac_l = lambda t, y: jac(t, y, params_l)
    y_l, st_l = ensemble_bdf_integrate(f_l, jac_l, y0_l, t0_l, tf_l, **kw)
    group = mesh.get_group()

    def gathered(v):
        return None if v is None else _all_gather_rows(v, group, world)

    y = gathered(y_l)
    st = EnsembleStats(*(gathered(v) for v in st_l))
    # each shard broadcast its own inner-solve total over its lanes; the
    # documented invariant is every entry == the GLOBAL total
    for name in ("nli", "npsolves"):
        v = getattr(st, name)
        if v is not None:
            total = v[::shard].sum().to(v.dtype)
            st = st._replace(**{name: total.expand(v.shape[0]).clone()})
    if pad:
        y = y[:nsys]
        st = EnsembleStats(*(None if v is None else v[:nsys] for v in st))
    return y, st
