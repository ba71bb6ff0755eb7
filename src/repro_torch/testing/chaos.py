"""Deterministic fault injection for the fault-containment contract.

Counterpart of ``repro.testing.chaos``.  The per-lane retcodes of the
ensemble integrators (:mod:`repro_torch.core.status`, the quarantine in
``ensemble_bdf`` / ``ensemble_dirk``) and the serving tier's graceful
degradation (typed ``SolverError`` futures, deadlines, the fallback to
the plain versions) are only trustworthy if faults can be injected on
demand and the blast radius measured.  This module provides seeded
injectors and the suite that asserts the contract end to end:

* **k faults => exactly k failures.**  Poisoning k lanes of an
  ``nsys``-lane ensemble gives exactly k non-success retcodes, at
  exactly the planned lanes, and through the serving tier exactly k
  failed Futures: never a hung Future, never a garbage result.
* **Healthy lanes are bitwise clean.**  The non-faulted lanes of a
  poisoned run reproduce the no-fault run bit for bit (trajectories and
  decision streams) on every backend, the kernels included: an injector
  is a ``torch.where`` whose clean branch is the untouched value, and
  every op of the ensemble path is lane-local (eager PyTorch fuses
  nothing across lanes), so a fault in lane i cannot reach lane j.  The
  reference checks bits only under its jnp oracle (XLA fuses the
  divergent injector's arithmetic into shared reductions).

The defaults run on the card with the kernels; pass ``policy=
ExecPolicy(device="cpu")`` (the core suite) or ``device="cpu"`` (the
serving suite) to run the plain versions on the CPU.  All randomness
flows from explicit seeds (:class:`ChaosPlan`), so a chaos failure
reproduces from its seed.

Run the acceptance suite (``--device cpu`` off the card)::

    python -m repro_torch.testing.chaos [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import random
import sys
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import status

__all__ = [
    "ChaosPlan", "poison_rhs", "chaotic_robertson_family",
    "failing_executions", "run_core_chaos", "run_serving_chaos", "main",
]


# ---------------------------------------------------------------------------
# seeded fault plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChaosPlan:
    """A seeded selection of fault lanes and onset times.

    ``lanes`` are the faulted lane indices (sorted, distinct);
    ``onsets`` are the per-faulted-lane fault onset times, aligned with
    ``lanes``.  Healthy lanes have onset ``+inf`` in
    :meth:`onset_vector`: the injected predicate ``t >= onset`` is never
    true for them, so the poison select always takes the clean branch.
    """

    nsys: int
    lanes: Tuple[int, ...]
    onsets: Tuple[float, ...]

    @classmethod
    def draw(cls, nsys: int, k: int, t0: float, tf: float, *,
             seed: int = 0,
             window: Tuple[float, float] = (0.3, 0.7)) -> "ChaosPlan":
        """Draw ``k`` distinct fault lanes with onsets uniform in the
        fractional ``window`` of ``[t0, tf]`` (the defaults keep faults
        away from the endpoints so the clean run has accepted steps both
        before and after the onset).  The draw is the reference's: the
        same seed gives the same lanes and onsets."""
        if not 0 <= k <= nsys:
            raise ValueError(f"need 0 <= k={k} <= nsys={nsys}")
        rng = random.Random(seed)
        lanes = tuple(sorted(rng.sample(range(nsys), k)))
        w0, w1 = window
        onsets = tuple(t0 + (w0 + rng.random() * (w1 - w0)) * (tf - t0)
                       for _ in lanes)
        return cls(nsys=nsys, lanes=lanes, onsets=onsets)

    def mask(self) -> np.ndarray:
        """(nsys,) bool: True at faulted lanes."""
        m = np.zeros(self.nsys, dtype=bool)
        m[list(self.lanes)] = True
        return m

    def onset_vector(self, dtype=np.float64) -> np.ndarray:
        """(nsys,) fault onset times; ``+inf`` for healthy lanes."""
        v = np.full(self.nsys, np.inf, dtype=dtype)
        for lane, t in zip(self.lanes, self.onsets):
            v[lane] = t
        return v


# ---------------------------------------------------------------------------
# RHS injectors (closed-over batched problems)
# ---------------------------------------------------------------------------

def poison_rhs(f: Callable, plan: ChaosPlan, *, mode: str = "nan",
               soa: bool = False, scale: float = 1e12) -> Callable:
    """Wrap a batched RHS so the planned lanes fail after their onset.

    ``mode="nan"`` replaces the faulted lanes' RHS with NaN once
    ``t >= onset``: the Newton iteration never converges there, and the
    lane quarantines with CONV_FAILURE (a NaN step is never accepted, so
    its last accepted state stays finite).  ``mode="divergent"`` adds
    ``scale * y`` to the faulted lanes WITHOUT touching the Jacobian:
    the Newton matrix no longer matches the residual, the corrector
    diverges, and the lane escalates through MXNCF or step underflow
    (CONV_FAILURE / ERR_FAILURE) on finite arithmetic.

    ``soa=True`` wraps the SoA form (``y: (n, nsys)``, fault axis
    last); otherwise AoS (``y: (nsys, n)``, fault axis first).  Healthy
    lanes take the untouched clean RHS through a ``torch.where``.  The
    plan's mask and onsets are copied to each device once, on its first
    call there.
    """
    if mode not in ("nan", "divergent"):
        raise ValueError(f"unknown chaos mode {mode!r}")
    mask = torch.from_numpy(plan.mask())
    onset = torch.from_numpy(plan.onset_vector())
    on_device = {}

    def wrapped(t, y):
        clean = f(t, y)
        if y.device not in on_device:
            on_device[y.device] = (mask.to(y.device),
                                   onset.to(y.device, y.dtype))
        m, o = on_device[y.device]
        hot = m & (torch.as_tensor(t, dtype=y.dtype, device=y.device) >= o)
        hot = hot[None, :] if soa else hot[:, None]
        if mode == "nan":
            return torch.where(hot, torch.nan, clean)
        return torch.where(hot, clean + scale * y, clean)

    return wrapped


def chaotic_robertson_family():
    """:func:`~repro_torch.core.problems.robertson_family` plus a
    per-request ``t_fault`` parameter: a lane whose ``t >= t_fault``
    sees a NaN RHS (healthy requests pass ``t_fault = inf``).  Faultiness
    is data, so faulted and healthy requests share one bundle and one
    cache entry: the containment scenario worth testing."""
    from ..core.problems import robertson_family
    f, jac, f_soa, jac_soa = robertson_family()

    def f_c(t, y, p):
        return torch.where((t >= p["t_fault"])[:, None], torch.nan,
                           f(t, y, p))

    def f_soa_c(t, y, p):
        return torch.where((t >= p["t_fault"])[None, :], torch.nan,
                           f_soa(t, y, p))

    return f_c, jac, f_soa_c, jac_soa


# ---------------------------------------------------------------------------
# serving injectors
# ---------------------------------------------------------------------------

@contextmanager
def failing_executions(server, k: int = 1,
                       exc: Optional[Exception] = None):
    """Patch the server's runner seam (``_run_compiled``) so the next
    ``k`` invocations raise ``exc``, by default
    :class:`~repro_torch.serve.solver.server.BackendUnavailable` (a
    simulated runner that declares its backend unavailable).

    The one-shot fallback to the plain versions, which the server takes
    on that type only, re-enters the same seam, so ``k=1`` exercises
    graceful degradation end to end: the primary run raises, the
    fallback runs clean, and every Future in the bundle resolves with a
    ``degraded`` Solution.  ``k=2`` fails the fallback too: the bundle's
    Futures then fail with a typed ``SolverError`` (resolve, don't
    strand).  Any other ``exc`` (a kernel's error) fails the bundle's
    Futures at once.  Yields a mutable box with ``raised`` /
    ``remaining`` counters.
    """
    from ..serve.solver.server import BackendUnavailable
    orig = server._run_compiled
    box = {"remaining": int(k), "raised": 0}

    def chaotic(entry, sess, tfa, params):
        if box["remaining"] > 0:
            box["remaining"] -= 1
            box["raised"] += 1
            raise exc if exc is not None else BackendUnavailable(
                "chaos: injected executable failure")
        return orig(entry, sess, tfa, params)

    server._run_compiled = chaotic
    try:
        yield box
    finally:
        server._run_compiled = orig


# ---------------------------------------------------------------------------
# chaos suites
# ---------------------------------------------------------------------------

def run_core_chaos(nsys: int = 4096, k: int = 8, *, seed: int = 0,
                   tf: float = 0.4, policy=None, mode: str = "nan",
                   check_bitwise: bool = True, rates=None) -> dict:
    """Core containment: poison ``k`` of ``nsys`` Robertson lanes and
    assert exactly-k quarantine with healthy lanes unharmed.

    ``policy`` is an ExecPolicy (None: the kernels on the card);
    ``rates`` the per-lane Robertson rates (None:
    ``problems.robertson_rates(nsys, seed=0)``).  Asserts (raising
    ``AssertionError`` with a reproducing seed):

    * exactly the planned lanes carry non-success retcodes;
    * the ``ok`` mask mirrors ``retcodes == 0``;
    * healthy-lane states are finite and healthy lanes report success;
    * faulted lanes' reported states are finite (the last ACCEPTED
      state: a NaN attempt is never accepted);
    * ``check_bitwise``: healthy-lane trajectories and decision streams
      (steps, attempts, netf, nni) are bitwise those of a clean run,
      in both modes and on every backend.

    Returns a report dict for the CLI and logs.
    """
    from ..core.arkode import ODEOptions
    from ..core.batched import ensemble_bdf_integrate
    from ..core.policies import ExecPolicy
    from ..core.problems import (batched_robertson, batched_robertson_soa,
                                 robertson_rates)
    policy = ExecPolicy() if policy is None else policy
    opts = ODEOptions(policy=policy)
    if rates is None:
        rates = robertson_rates(nsys, seed=0)
    tag = f"[core seed={seed} nsys={nsys} k={k} mode={mode}]"

    f, jac, y0 = batched_robertson(nsys, rates=rates, device=policy.device)
    f_soa, jac_soa = batched_robertson_soa(nsys, rates=rates,
                                           device=policy.device)
    plan = ChaosPlan.draw(nsys, k, 0.0, tf, seed=seed)
    clean_y, clean_st = ensemble_bdf_integrate(
        f, jac, y0, 0.0, tf, opts=opts, f_soa=f_soa, jac_soa=jac_soa)
    fy, fst = ensemble_bdf_integrate(
        poison_rhs(f, plan, mode=mode), jac, y0, 0.0, tf, opts=opts,
        f_soa=poison_rhs(f_soa, plan, mode=mode, soa=True),
        jac_soa=jac_soa)

    rcs = fst.retcodes.cpu().numpy()
    ok = fst.ok.cpu().numpy()
    failed = np.flatnonzero(rcs != 0)
    assert set(failed.tolist()) == set(plan.lanes), (
        f"{tag} expected failures exactly at {plan.lanes}, got "
        f"{failed.tolist()}")
    assert np.array_equal(ok, rcs == 0), f"{tag} ok mask != retcodes==0"
    for lane in plan.lanes:
        assert rcs[lane] in status.RETCODE_NAMES, (
            f"{tag} lane {lane} carries unknown retcode {rcs[lane]}")

    healthy = torch.from_numpy(~plan.mask()).to(fy.device)
    assert bool(torch.isfinite(fy[healthy]).all()), (
        f"{tag} healthy lanes contaminated with non-finite state")
    assert bool(torch.isfinite(fy[~healthy]).all()), (
        f"{tag} faulted lanes reported non-finite state (quarantine "
        "must freeze the last ACCEPTED state)")
    assert bool(fst.success[healthy].all()), (
        f"{tag} a healthy lane reports no success")
    if check_bitwise:
        for name in ("steps", "attempts", "netf", "nni"):
            assert torch.equal(getattr(fst, name)[healthy],
                               getattr(clean_st, name)[healthy]), (
                f"{tag} healthy-lane decision stream {name!r} diverged")
        assert torch.equal(fy[healthy], clean_y[healthy]), (
            f"{tag} healthy-lane trajectories differ from the no-fault "
            "run (bitwise)")

    return {"suite": "core", "seed": seed, "nsys": nsys, "mode": mode,
            "backend": policy.backend, "device": str(fy.device),
            "faulted": len(plan.lanes),
            "failed": int((rcs != 0).sum()),
            "retcodes": {str(lane): status.retcode_name(int(rcs[lane]))
                         for lane in plan.lanes},
            "bitwise_checked": bool(check_bitwise)}


def run_serving_chaos(requests: int = 10000, k: int = 32,
                      shed: int = 16, *, seed: int = 0,
                      bucket: int = 256, tf: float = 0.25,
                      device=None) -> dict:
    """Serving containment: a ``requests``-request run with ``k`` lane
    faults, ``shed`` expired deadlines, and injected runner failures:
    zero hung Futures, failures exactly typed.

    Runs on ``device`` (None: the card).  Asserts:

    * every Future resolves (no hangs, no garbage);
    * the ``shed`` deadlined requests fail with ``DeadlineExceeded``
      (shed at flush, before any work);
    * the ``k`` faulted requests fail with ``SolverError`` carrying a
      known retcode and the lane's stats slice;
    * everyone else succeeds; one bundle whose runner declared its
      backend unavailable once (``failing_executions(k=1)``) is served
      by the plain versions and its Solutions are flagged ``degraded``,
      and it is the only bundle degraded;
    * one more bundle whose fallback raised too (``k=2``), and one whose
      runner raised a kernel's error (any other type), fail each of
      their Futures with a typed ``SolverError`` (``exec_error``);
    * ``metrics()`` / ``metrics_prometheus()`` reconcile the failure
      and degraded counters against the observed Futures.
    """
    from ..core.context import Context
    from ..core.policies import ExecPolicy
    from ..serve.solver import ProblemFamily, SolverServer
    from ..serve.solver.server import DeadlineExceeded, SolverError
    tag = f"[serving seed={seed} requests={requests} k={k} shed={shed}]"
    if k + shed > requests:
        raise ValueError("k + shed must not exceed requests")

    fam = chaotic_robertson_family()
    srv = SolverServer(
        [ProblemFamily("chaos_rob", 3, fam[0], fam[1], fam[2], fam[3])],
        ctx=Context(policy=ExecPolicy(device=device)),
        bucket_sizes=(bucket,), max_batch=bucket, max_wait=1e-3,
        max_depth=2 * bucket)
    rng = random.Random(seed)
    marked = rng.sample(range(requests), k + shed)
    faulted, deadlined = set(marked[:k]), set(marked[k:])
    y0 = np.array([1.0, 0.0, 0.0])

    def params(i):
        return {"k1": 0.04, "k2": 1.2e4, "k3": 3e7,
                "t_fault": (rng.uniform(0.3, 0.7) * tf
                            if i in faulted else math.inf)}

    futs = []
    try:
        for i in range(requests):
            futs.append(srv.submit(
                "chaos_rob", y0, 0.0, tf, params=params(i),
                deadline=1e-9 if i in deadlined else None))
            if len(futs) % bucket == 0:
                srv.drain()
        srv.drain()
        # one extra healthy bundle whose runner declares its backend
        # unavailable once: the plain-version fallback serves it
        with failing_executions(srv, k=1) as box:
            fallback_futs = [
                srv.submit("chaos_rob", y0, 0.0, tf, params=params(-1))
                for _ in range(4)]
            srv.drain()
        futs.extend(fallback_futs)
        # and one whose fallback fails too: typed errors, no hang
        with failing_executions(srv, k=2) as box2:
            lost_futs = [
                srv.submit("chaos_rob", y0, 0.0, tf, params=params(-1))
                for _ in range(4)]
            try:
                srv.drain()
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"{tag} a failed fallback did not "
                                     "raise out of the pump")
        # and one whose runner fails as a kernel would: typed errors,
        # and no re-run on the plain versions in its place
        with failing_executions(srv, k=1, exc=RuntimeError(
                "chaos: injected kernel failure")) as box3:
            kernel_futs = [
                srv.submit("chaos_rob", y0, 0.0, tf, params=params(-1))
                for _ in range(4)]
            try:
                srv.drain()
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"{tag} a kernel failure did not "
                                     "raise out of the pump")
        lost_futs += kernel_futs
    finally:
        srv.stop()

    hung = [i for i, fut in enumerate(futs + lost_futs) if not fut.done()]
    assert not hung, f"{tag} {len(hung)} hung futures: {hung[:16]}"
    got_deadline, got_retcode, oks, degraded_ok = set(), set(), [], 0
    for i, fut in enumerate(futs):
        exc = fut.exception()
        if exc is None:
            sol = fut.result()
            oks.append(sol.ok)
            degraded_ok += bool(sol.degraded)
        elif isinstance(exc, DeadlineExceeded):
            got_deadline.add(i)
        elif isinstance(exc, SolverError):
            assert exc.retcode in status.RETCODE_NAMES and \
                exc.retcode != status.SUCCESS, (
                    f"{tag} request {i} failed with untyped retcode "
                    f"{exc.retcode}")
            assert exc.stats is not None, (
                f"{tag} request {i} SolverError carries no lane stats")
            got_retcode.add(i)
        else:
            raise AssertionError(
                f"{tag} request {i} failed with non-solver exception "
                f"{type(exc).__name__}: {exc}")
    assert got_deadline == deadlined, (
        f"{tag} deadline sheds {sorted(got_deadline)[:8]}... != planned")
    assert got_retcode == faulted, (
        f"{tag} retcode failures != planned faults: "
        f"extra={sorted(got_retcode - faulted)[:8]} "
        f"missing={sorted(faulted - got_retcode)[:8]}")
    # the lanes' ok flags are device views: one read for all of them
    got_ok = len(oks)
    assert got_ok == requests - k - shed + len(fallback_futs)
    assert bool(torch.stack(oks).all()), (
        f"{tag} a request resolved with ok=False")
    assert degraded_ok == len(fallback_futs), (
        f"{tag} fallback bundle not flagged degraded")
    assert box["raised"] == 1 and box2["raised"] == 2 and \
        box3["raised"] == 1
    for fut in lost_futs:
        exc = fut.exception()
        assert isinstance(exc, SolverError) and \
            not isinstance(exc, DeadlineExceeded), (
                f"{tag} a failed bundle's future holds {exc!r}")

    m = srv.metrics()
    assert m["failures"].get("deadline", 0) == shed, (
        f"{tag} metrics deadline count {m['failures']} != {shed}")
    assert m["failures"].get("exec_error", 0) == len(lost_futs), (
        f"{tag} metrics exec_error count {m['failures']}")
    retcode_failures = sum(v for r, v in m["failures"].items()
                           if r not in ("deadline", "exec_error"))
    assert retcode_failures == k, (
        f"{tag} metrics retcode failures {m['failures']} != {k}")
    assert m["degraded"] == 1
    prom = srv.metrics_prometheus()
    assert 'repro_serve_failures_total{reason="deadline"}' in prom
    assert "repro_serve_degraded_total 1" in prom

    return {"suite": "serving", "seed": seed, "requests": len(futs),
            "device": str(srv.device),
            "failed_retcode": len(got_retcode),
            "failed_deadline": len(got_deadline),
            "failed_exec": len(lost_futs),
            "succeeded": got_ok, "degraded_bundles": m["degraded"],
            "failures_by_reason": m["failures"]}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.chaos",
        description="Deterministic fault-injection acceptance suite "
                    "(core quarantine containment + serving graceful "
                    "degradation).")
    ap.add_argument("--nsys", type=int, default=4096,
                    help="ensemble width of the core pass")
    ap.add_argument("--faults", type=int, default=8,
                    help="faulted lanes in the core pass")
    ap.add_argument("--requests", type=int, default=10000,
                    help="serving-pass request count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    from ..core.policies import ExecPolicy

    dev = args.device
    reports = []
    try:
        print(f"[chaos] core: nsys={args.nsys} k={args.faults} "
              f"seed={args.seed}", flush=True)
        reports.append(run_core_chaos(args.nsys, args.faults,
                                      seed=args.seed,
                                      policy=ExecPolicy(device=dev)))
        print("[chaos] core (divergent mode): nsys=64 k=4", flush=True)
        reports.append(run_core_chaos(64, 4, seed=args.seed + 1,
                                      mode="divergent",
                                      policy=ExecPolicy(device=dev)))
        print("[chaos] core, plain versions: nsys=64 k=3", flush=True)
        reports.append(run_core_chaos(
            64, 3, seed=args.seed + 2,
            policy=ExecPolicy(backend="torch", device=dev)))
        print(f"[chaos] serving: requests={args.requests} k=32 shed=16 "
              f"seed={args.seed}", flush=True)
        reports.append(run_serving_chaos(args.requests, 32, 16,
                                         seed=args.seed, device=dev))
    except AssertionError as exc:
        print(f"[chaos] FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "reports": reports}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
