"""Unified IVP front-end: one problem object, one ``integrate`` call.

Counterpart of ``repro.core.ivp`` (``ivp.py:59-73,77-205,250-440``) for
every family of the reference: the scalar ``"erk[:table]"``,
``"dirk[:table]"``, ``"imex[:table]"`` (``repro_torch.core.arkode``),
``"bdf"`` and ``"adams"`` (``repro_torch.core.cvode``), and the ensemble
``"ensemble_erk[:table]"``, ``"ensemble_dirk[:table]"`` and
``"ensemble_bdf"``.
``integrate`` runs on the card unless the call (or the context's
policy) names another device; without CUDA it raises instead of
falling back to the CPU.  It takes the reference's warm start
(``session=`` / ``return_session=``, ensemble_bdf), step telemetry
(``telemetry=K``; bdf, ensemble_dirk, ensemble_bdf), ``timed=True`` and
the serving tier's dead-lane mask (``live=``, the ensemble families),
and logs ``integrate.lane_failed`` / ``integrate.done`` through the
context's logger.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..kernels import _build
from ..observability.telemetry import StepTelemetry
from . import arkode, batched, butcher, cvode, status
from . import vector as nv
from .arkode import ODEOptions
from .context import Context
from .linsol import _is_precond_obj
from .policies import resolve_device

#: the reference's canonical method strings that the port runs
METHOD_STRINGS = (
    "erk:dopri5",
    "erk:bogacki_shampine",
    "dirk:sdirk2",
    "dirk:sdirk33",
    "imex:ark324",
    "bdf",
    "adams",
    "ensemble_erk:bogacki_shampine",
    "ensemble_dirk:sdirk2",
    "ensemble_bdf",
)

_ERK_ALIASES = {"dopri5": "dormand_prince", "bs32": "bogacki_shampine",
                "heun": "heun_euler"}
_DIRK_ALIASES = {"esdirk3": "ark324_esdirk"}

_KNOWN_FAMILIES = ("erk", "dirk", "imex", "bdf", "adams",
                   "ensemble_erk", "ensemble_dirk", "ensemble_bdf")

#: families that take the step-telemetry ring, as in the reference
_TELEMETRY_FAMILIES = ("bdf", "ensemble_dirk", "ensemble_bdf")


def _erk_table(var):
    """The table of ``ensemble_erk[:var]``; a bare ``ensemble_erk`` is
    dormand_prince, as in the reference."""
    name = _ERK_ALIASES.get(var or "dopri5", var or "dopri5")
    return butcher.ERK_TABLES[name]


def _dirk_table(var):
    name = _DIRK_ALIASES.get(var or "sdirk2", var or "sdirk2")
    return butcher.DIRK_TABLES[name]


@dataclass(frozen=True)
class IVP:
    """An initial-value problem (see ``repro.core.ivp.IVP``).

    f   : full RHS ``f(t, y)`` — exclusive with ``fe``+``fi``
    fe, fi : explicit / implicit parts for IMEX methods
    jac : analytic Jacobian (batched ``(t, y) -> (nsys, n, n)``; the
          ensemble_dirk and ensemble_bdf families need it)
    f_soa, jac_soa : native SoA forms (system axis LAST)
    jac_sparsity : static per-system sparsity pattern
    y0  : initial state: a tensor or a tuple of tensors for the scalar
          families, ``(nsys, n)`` for the ensemble ones
    """

    f: Optional[Callable] = None
    fe: Optional[Callable] = None
    fi: Optional[Callable] = None
    jac: Optional[Callable] = None
    f_soa: Optional[Callable] = None
    jac_soa: Optional[Callable] = None
    jac_sparsity: Optional[Any] = None
    y0: Any = None

    def __post_init__(self):
        if (self.f is None) == (self.fe is None and self.fi is None):
            raise ValueError("IVP wants either f=... or fe=... and fi=...")
        if (self.fe is None) != (self.fi is None):
            raise ValueError("IMEX splittings need BOTH fe and fi")
        if self.y0 is None:
            raise ValueError("IVP needs y0")

    @property
    def full_rhs(self) -> Callable:
        """``f``, or ``fe + fi`` for split problems."""
        if self.f is not None:
            return self.f
        fe, fi = self.fe, self.fi
        return lambda t, y: nv.tmap(torch.add, fe(t, y), fi(t, y))


class Solution(NamedTuple):
    """One result type for every method (fields as in the reference;
    those of unported features stay None)."""

    y: Any
    t: torch.Tensor
    success: torch.Tensor
    stats: Any
    method: str
    lin_solver: str
    nonlin_solver: str
    nni: torch.Tensor
    nli: Optional[torch.Tensor]
    nsetups: Optional[torch.Tensor]
    workspace_bytes: int
    high_water_bytes: int
    npsolves: Optional[torch.Tensor] = None
    npsetups: Optional[torch.Tensor] = None
    session: Optional[Any] = None
    timings: Optional[dict] = None
    telemetry: Optional[Any] = None
    retcodes: Optional[torch.Tensor] = None
    ok: Optional[torch.Tensor] = None
    degraded: bool = False


def integrate(problem: IVP, t0, tf, method: str = "bdf", *,
              ctx: Optional[Context] = None,
              opts: Optional[ODEOptions] = None,
              lin_solver=None, nonlin_solver=None, order: int = 5,
              live=None, timed: Optional[bool] = None, device=None,
              **method_kw) -> Solution:
    """Integrate ``problem`` from t0 to tf with ``method``.

    ctx    : :class:`~repro_torch.core.context.Context`; a private one
             is created if omitted.
    opts   : ODEOptions; defaults to ``ctx.options()``.
    device : where the run happens; None takes ``opts.policy.device``,
             and if that is None too, the card.  ``problem.y0`` must
             already lie there.
    lin_solver : dirk, imex, bdf: a solver of
             :mod:`repro_torch.core.linsol` (``DenseGJ`` or a Krylov
             solver, with or without a preconditioner object; None is
             matrix-free ``SPGMR``, or ``DenseGJ`` for bdf with
             ``dense_jac=True``) or a callable ``(t, z, gamma, rhs) ->
             dz``;
             ensemble_bdf: ``BlockDiagGJ`` (None), ``EnsembleSparseGJ``,
             ``SPGMR``, ``SPFGMR``, ``SPBCGS``, ``SPTFQMR``, ``PCG``, with
             the problem's ``jac_sparsity`` bound to it.
    nonlin_solver : dirk, imex, bdf: a
             :class:`~repro_torch.core.nonlinsol.NewtonSolver`; adams: a
             :class:`~repro_torch.core.nonlinsol.FixedPointSolver`.
    order  : the largest BDF order (bdf, ensemble_bdf).
    live   : ensemble families: a ``(nsys,)`` boolean mask of the live
             lanes of a padded bundle (reference ``ivp.py:424-428``).
             Dead lanes are zeroed out of the stats, the aggregates
             (``success``, ``nni``, ``nsetups``), the context's counters
             and the telemetry, and report retcode 0.  Scalar methods
             raise ``ValueError``.
    timed  : True reports ``Solution.timings = {"build": s, "execute":
             s}``; None takes ``ctx.observability.profile``.  The
             reference splits a jitted call into ``lower`` / ``compile``
             / ``execute``; the port has no trace to lower, and its
             compile step is ``build``: the first-use ``nvcc`` build
             (every missing library at once) or the load of the kernel
             libraries (``kernels/_build.py`` ``load``), about 0.0 once
             they are loaded, and on the CPU or with
             ``backend="torch"``.  ``execute`` is the host clock around
             the solve, ending in a synchronise of the solve's device.
             Each stage runs in a ``ctx.profiler`` region,
             ``integrate.build`` and ``integrate.execute``.
    method_kw : passed to the integrator (``dense_jac`` for bdf,
             ``m_aa`` for adams, ``msbp``, ``dgmax``, ... for
             ensemble_bdf, ``newton_iters`` for ensemble_dirk; the
             other families take none).  ``telemetry=K`` (bdf,
             ensemble_dirk, ensemble_bdf; also switched on for them by
             ``ctx.observability.telemetry``) records the steps in a
             K-slot ring on the device, surfaced as
             ``Solution.telemetry`` (a
             :class:`~repro_torch.observability.telemetry.StepTelemetry`).
             ensemble_bdf also takes ``session=`` and
             ``return_session=`` (the exported
             :class:`~repro_torch.core.batched.SolverSession` lands in
             ``Solution.session``).

    For ensemble_bdf, ``nli`` and ``npsolves`` are the Krylov solver's
    inner iterations and psolves, and ``npsetups`` is the lsetup total
    whenever the solver carries a preconditioner object (psetup rides
    the lsetup triggers), as in the reference.  A scalar family's
    ``t`` is the time reached; bdf's ``retcodes`` is its 0-d CV_* code
    and ``ok`` whether it is 0; the other scalar families' are None, as
    in the reference.
    """
    fam, _, var = method.partition(":")
    if fam not in _KNOWN_FAMILIES:
        raise ValueError(f"unknown method {method!r}; families: "
                         f"{', '.join(_KNOWN_FAMILIES)}")
    if live is not None and not fam.startswith("ensemble"):
        raise ValueError(f"method {method!r} takes no live= mask (dead-"
                         "lane masking applies to ensemble bundles only)")
    tel_cap = method_kw.pop("telemetry", None)
    if tel_cap is not None and fam not in _TELEMETRY_FAMILIES:
        raise ValueError(
            f"method {method!r} takes no telemetry= (step telemetry "
            f"covers the implicit adaptive families: "
            f"{', '.join(_TELEMETRY_FAMILIES)})")
    # a solver object a family cannot consume is an error, not a silent
    # no-op (Solution must never report a swap that did not happen)
    if lin_solver is not None and fam not in ("dirk", "imex", "bdf",
                                              "ensemble_bdf"):
        raise ValueError(f"method {method!r} takes no lin_solver (the "
                         "pluggable families are dirk, imex, bdf, "
                         "ensemble_bdf)")
    if nonlin_solver is not None and fam not in ("dirk", "imex", "bdf",
                                                 "adams"):
        raise ValueError(f"method {method!r} takes no nonlin_solver (the "
                         "pluggable families are dirk, imex, bdf, adams)")
    if fam in ("erk", "dirk", "imex", "ensemble_erk") and method_kw:
        raise ValueError(f"method {method!r} takes no "
                         f"{', '.join(sorted(method_kw))}")
    ctx = ctx if ctx is not None else Context()
    opts = opts if opts is not None else ctx.options()
    obs = ctx.observability
    if tel_cap is None and obs.telemetry and fam in _TELEMETRY_FAMILIES:
        tel_cap = obs.telemetry_capacity
    return_session = fam == "ensemble_bdf" and bool(
        method_kw.pop("return_session", False))
    dev = resolve_device(device if device is not None else opts.policy.device)
    for leaf in nv.leaves(problem.y0):
        if leaf.device.type != dev.type:
            raise ValueError(f"IVP.y0 lies on {leaf.device} but the run is "
                             f"on {dev}: build the problem there "
                             "(device=...)")
    if fam in ("ensemble_dirk", "ensemble_bdf") and problem.jac is None:
        raise ValueError(f"method {method!r} needs IVP.jac")
    if fam == "imex" and problem.fe is None:
        raise ValueError(f"method {method!r} needs IVP.fe and IVP.fi")
    mem = ctx.memory
    live0 = mem.live_bytes
    labels0 = set(mem.workspaces)
    y0 = problem.y0
    f = problem.full_rhs

    def dispatch():
        """The family's integrator: ``(y, stats, session, ring)``."""
        session = ring = None
        if fam == "erk":
            y, st = arkode.erk_integrate(f, y0, t0, tf, _erk_table(var),
                                         opts, mem=mem)
        elif fam == "dirk":        # the full RHS, treated implicitly
            y, st = arkode.dirk_integrate(
                f, y0, t0, tf, _dirk_table(var), opts, lin_solver=lin_solver,
                nonlin_solver=nonlin_solver, mem=mem)
        elif fam == "imex":
            y, st = arkode.imex_integrate(
                problem.fe, problem.fi, y0, t0, tf,
                butcher.IMEX_TABLES[var or "ark324"], opts,
                lin_solver=lin_solver, nonlin_solver=nonlin_solver, mem=mem)
        elif fam == "bdf":         # the full RHS, treated implicitly
            y, st, *ring = cvode.bdf_integrate(
                f, y0, t0, tf, order=order, opts=opts, lin_solver=lin_solver,
                nonlin_solver=nonlin_solver, mem=mem, telemetry=tel_cap,
                **method_kw)
        elif fam == "adams":
            y, st = cvode.adams_integrate(f, y0, t0, tf, opts,
                                          nonlin_solver=nonlin_solver,
                                          mem=mem, **method_kw)
        elif fam == "ensemble_erk":
            y, st = batched.ensemble_erk_integrate(f, y0, t0, tf,
                                                   _erk_table(var), opts)
        elif fam == "ensemble_dirk":
            y, st, *ring = batched.ensemble_dirk_integrate(
                f, problem.jac, y0, t0, tf, _dirk_table(var), opts,
                policy=opts.policy, f_soa=problem.f_soa,
                jac_soa=problem.jac_soa, telemetry=tel_cap, **method_kw)
        else:
            y, st, *rest = batched.ensemble_bdf_integrate(
                f, problem.jac, y0, t0, tf, order=order, opts=opts,
                policy=opts.policy, linear_solver=lin_solver,
                jac_sparsity=problem.jac_sparsity, mem=mem,
                f_soa=problem.f_soa, jac_soa=problem.jac_soa,
                return_session=return_session, telemetry=tel_cap,
                **method_kw)
            if return_session:
                session, *rest = rest
            ring = rest
        return y, st, session, ring[0] if ring else None

    timings = None
    if obs.profile if timed is None else timed:
        prof = ctx.profiler
        t_a = time.perf_counter()
        with prof.region("integrate.build", method=method):
            if dev.type == "cuda" and opts.policy.backend != "torch":
                for lib in _build.SOURCES:
                    _build.load(lib)
        t_b = time.perf_counter()
        with prof.region("integrate.execute", method=method):
            y, st, session, ring = dispatch()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t_c = time.perf_counter()
        timings = {"build": t_b - t_a, "execute": t_c - t_b}
    else:
        y, st, session, ring = dispatch()

    if live is not None:
        # a padded bundle: dead lanes leave the stats before every
        # aggregate below (success, the nni sum, nsetups, the counters)
        live = torch.as_tensor(live, dtype=torch.bool, device=dev)
        st = st.masked(live)
    workspace = mem.live_bytes - live0
    # workspaces are per call: release only the labels this call added
    for label in set(mem.workspaces) - labels0:
        mem.release(label)
    bdf = fam == "ensemble_bdf"
    nli = st.nli[0] if bdf else None
    ctx.record(st, None if nli is None else int(nli))
    # psetup rides the lsetup triggers (the reference's accounting)
    npsetups = st.nsetups.sum() if bdf and _is_precond_obj(
        getattr(lin_solver, "precond", None)) else None
    if fam in ("erk", "adams", "ensemble_erk"):
        lname = "none"
    elif lin_solver is None:
        lname = "blockdiag_gj" if fam.startswith("ensemble") else \
            "dense_gj" if method_kw.get("dense_jac") else "spgmr"
    else:
        lname = getattr(lin_solver, "name", "custom")
    nlname = "none" if fam in ("erk", "ensemble_erk") else \
        "fixed_point" if fam == "adams" else "newton"
    ens = fam.startswith("ensemble")
    # CV_*-style status: per lane for the ensembles, one code for bdf
    retcodes = st.retcodes if ens else st.retcode
    success = st.success.all() if ens else st.success
    nni = st.nni.sum() if ens else st.nni
    _log(ctx.logger, method, lname, st, retcodes, nni, success)
    return Solution(
        y=y, t=st.t if not ens else torch.as_tensor(tf), success=success,
        stats=st, method=method, lin_solver=lname, nonlin_solver=nlname,
        nni=nni, nli=nli, nsetups=st.nsetups if ens else None,
        workspace_bytes=workspace, high_water_bytes=mem.high_water_bytes,
        npsolves=st.npsolves[0] if bdf else None, npsetups=npsetups,
        session=session, timings=timings,
        telemetry=None if ring is None else StepTelemetry(ring, live=live),
        retcodes=retcodes, ok=st.ok if ens else
        None if retcodes is None else retcodes == 0)


def _log(logger, method, lname, st, retcodes, nni, success) -> None:
    """The reference's ``integrate.lane_failed`` (WARNING: failed lanes
    by retcode name, the first 16 of them) and ``integrate.done`` (INFO)
    events; each reads the device only when its level is on."""
    if logger.enabled_for("WARNING") and retcodes is not None:
        codes = retcodes.reshape(-1)
        failed = codes != 0
        nfail = int(failed.sum())
        if nfail:
            vals, cnts = torch.unique(codes[failed], return_counts=True)
            logger.warning(
                "integrate.lane_failed", method=method, failed=nfail,
                nsys=codes.numel(),
                retcodes={status.retcode_name(c): n for c, n in
                          zip(vals.tolist(), cnts.tolist())},
                lanes=torch.nonzero(failed)[:16, 0].tolist())
    if logger.enabled_for("INFO"):
        steps, nni_total, ok = torch.stack([
            st.steps.sum(dtype=torch.int64), nni.sum(dtype=torch.int64),
            success.to(torch.int64)]).tolist()
        logger.info("integrate.done", method=method, lin_solver=lname,
                    steps=steps, nni=nni_total, success=ok)
