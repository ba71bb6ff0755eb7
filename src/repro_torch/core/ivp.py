"""Unified IVP front-end: one problem object, one ``integrate`` call.

Counterpart of ``repro.core.ivp`` (``ivp.py:59-73,77-205,250-440``) for
the scalar families ``"erk[:table]"``, ``"dirk[:table]"`` and
``"imex[:table]"`` (``repro_torch.core.arkode``) and the ensemble
families ``"ensemble_erk[:table]"``, ``"ensemble_dirk[:table]"`` and
``"ensemble_bdf"``; ``"bdf"`` and ``"adams"`` raise
``NotImplementedError`` naming the ROADMAP item they wait for.
``integrate`` runs on the card unless the call (or the context's
policy) names another device; without CUDA it raises instead of
falling back to the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import arkode, batched, butcher
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
    "ensemble_erk:bogacki_shampine",
    "ensemble_dirk:sdirk2",
    "ensemble_bdf",
)

_ERK_ALIASES = {"dopri5": "dormand_prince", "bs32": "bogacki_shampine",
                "heun": "heun_euler"}
_DIRK_ALIASES = {"esdirk3": "ark324_esdirk"}

_KNOWN_FAMILIES = ("erk", "dirk", "imex", "bdf", "adams",
                   "ensemble_erk", "ensemble_dirk", "ensemble_bdf")

#: family -> the ROADMAP queue A item its port waits for
_WAITING = {"bdf": 7, "adams": 7}


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
    lin_solver : dirk, imex: a solver of :mod:`repro_torch.core.linsol`
             (``DenseGJ`` or a Krylov solver; None is matrix-free
             ``SPGMR``) or a callable ``(t, z, gamma, rhs) -> dz``;
             ensemble_bdf: ``BlockDiagGJ`` (None), ``EnsembleSparseGJ``,
             ``SPGMR``, ``SPFGMR``, ``SPBCGS``, ``SPTFQMR``, ``PCG``, with
             the problem's ``jac_sparsity`` bound to it.
    nonlin_solver : dirk, imex: a
             :class:`~repro_torch.core.nonlinsol.NewtonSolver`.
    method_kw : passed to the integrator (``msbp``, ``dgmax``, ... for
             ensemble_bdf, ``newton_iters`` for ensemble_dirk; the
             other families take none).

    For ensemble_bdf, ``nli`` and ``npsolves`` are the Krylov solver's
    inner iterations and psolves, and ``npsetups`` is the lsetup total
    whenever the solver carries a preconditioner object (psetup rides
    the lsetup triggers), as in the reference.  A scalar family's
    ``t`` is the time reached and its ``retcodes``/``ok`` are None, as
    in the reference's ARKODE integrators.
    """
    fam, _, var = method.partition(":")
    if fam not in _KNOWN_FAMILIES:
        raise ValueError(f"unknown method {method!r}; families: "
                         f"{', '.join(_KNOWN_FAMILIES)}")
    if fam in _WAITING:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP queue A item "
            f"{_WAITING[fam]})")
    if timed:
        raise NotImplementedError("integrate(timed=True) waits for the "
                                  "observability slice, ROADMAP queue A item 10")
    if live is not None:
        if not fam.startswith("ensemble"):
            raise ValueError(f"method {method!r} takes no live= mask (dead-"
                             "lane masking applies to ensemble bundles only)")
        raise NotImplementedError("live= lane masking waits for the serving "
                                  "slice, ROADMAP queue A item 9")
    # a solver object a family cannot consume is an error, not a silent
    # no-op (Solution must never report a swap that did not happen)
    if lin_solver is not None and fam not in ("dirk", "imex",
                                              "ensemble_bdf"):
        raise ValueError(f"method {method!r} takes no lin_solver (of the "
                         "ported families dirk, imex and ensemble_bdf do)")
    if nonlin_solver is not None and fam not in ("dirk", "imex"):
        raise ValueError(f"method {method!r} takes no nonlin_solver (of "
                         "the ported families dirk and imex do)")
    if fam in ("erk", "dirk", "imex", "ensemble_erk") and method_kw:
        raise ValueError(f"method {method!r} takes no "
                         f"{', '.join(sorted(method_kw))}")
    ctx = ctx if ctx is not None else Context()
    opts = opts if opts is not None else ctx.options()
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
    if fam == "erk":
        y, st = arkode.erk_integrate(f, y0, t0, tf, _erk_table(var), opts,
                                     mem=mem)
    elif fam == "dirk":        # the full RHS, treated implicitly
        y, st = arkode.dirk_integrate(f, y0, t0, tf, _dirk_table(var), opts,
                                      lin_solver=lin_solver,
                                      nonlin_solver=nonlin_solver, mem=mem)
    elif fam == "imex":
        y, st = arkode.imex_integrate(
            problem.fe, problem.fi, y0, t0, tf,
            butcher.IMEX_TABLES[var or "ark324"], opts,
            lin_solver=lin_solver, nonlin_solver=nonlin_solver, mem=mem)
    elif fam == "ensemble_erk":
        y, st = batched.ensemble_erk_integrate(f, y0, t0, tf, _erk_table(var),
                                               opts)
    elif fam == "ensemble_dirk":
        y, st = batched.ensemble_dirk_integrate(
            f, problem.jac, y0, t0, tf, _dirk_table(var), opts,
            policy=opts.policy, f_soa=problem.f_soa, jac_soa=problem.jac_soa,
            **method_kw)
    else:
        y, st = batched.ensemble_bdf_integrate(
            f, problem.jac, y0, t0, tf, order=order, opts=opts,
            policy=opts.policy, linear_solver=lin_solver,
            jac_sparsity=problem.jac_sparsity, mem=mem, f_soa=problem.f_soa,
            jac_soa=problem.jac_soa, **method_kw)

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
    if fam in ("erk", "ensemble_erk"):
        lname = "none"
    elif lin_solver is None:
        lname = "spgmr" if fam in ("dirk", "imex") else "blockdiag_gj"
    else:
        lname = getattr(lin_solver, "name", "custom")
    ens = fam.startswith("ensemble")
    return Solution(
        y=y, t=st.t if not ens else torch.as_tensor(tf),
        success=st.success.all() if ens else st.success, stats=st,
        method=method, lin_solver=lname,
        nonlin_solver="none" if fam in ("erk", "ensemble_erk") else "newton",
        nni=st.nni.sum() if ens else st.nni, nli=nli,
        nsetups=st.nsetups if ens else None,
        workspace_bytes=workspace, high_water_bytes=mem.high_water_bytes,
        npsolves=st.npsolves[0] if bdf else None, npsetups=npsetups,
        retcodes=st.retcodes if ens else None, ok=st.ok if ens else None)
