"""The solver server: a synchronous core with an async facade.

Counterpart of ``repro.serve.solver.server``.  ``SolverServer`` composes
the serving layers over the solver stack: the
:class:`~repro_torch.serve.solver.queue.AdmissionQueue` groups requests
into shape buckets, the
:class:`~repro_torch.serve.solver.trace_cache.TraceCache` maps each
padded bundle shape to a prepared runner, and every bundle goes through
``integrate(..., "ensemble_bdf")`` with a
:class:`~repro_torch.core.batched.SolverSession` carry, so cold requests
and warm-start continuations mix freely in one bundle.  On the card the
bundle's hot ops are the port's CUDA kernels.

The **synchronous core** is :meth:`pump`: flush due bundles, execute
each, resolve its per-request futures.  Tests and benchmarks drive it
directly (deterministic, no threads); the **async facade**
(:meth:`start`/:meth:`stop`, the context manager) runs the same pump on
a background thread, so :meth:`submit` is a non-blocking enqueue
returning a ``concurrent.futures.Future``.

Every response is a :class:`~repro_torch.core.ivp.Solution` restricted
to the request's lane (padded dead lanes never reach a client), with
the serving wall-clock split ``timings = {"queue_wait", "compile",
"execute"}`` (``compile`` is the bundle runner's build time, nonzero
only for the bundle that missed the cache) and the warm-start
``session`` handle.  Its tensors are views of the bundle's outputs on
the bundle's device.

Where the JAX code does not carry over:

* a bundle's runner is built, not traced and compiled (``_compile``);
* ``_run_compiled`` ends in ``torch.cuda.synchronize`` on the card;
* the one-shot fallback (``_degrade``) runs the plain PyTorch
  versions, ``ExecPolicy(backend="torch")``, on the same device under
  their own ``TraceKey``: counted in ``degraded``, logged at WARNING as
  ``serve.bundle.degraded``, each ``Solution`` marked
  ``degraded=True``.  Unlike the reference, which re-runs a bundle
  after ANY error of its run or an all-non-finite state, it runs only
  when the runner raised :class:`BackendUnavailable`, which no kernel
  or wrapper of the port raises: a kernel that fails or refuses its
  inputs, and an all-non-finite state under the kernels, fail the
  bundle's futures (``exec_error``), so no bundle is served by the
  plain versions in their place;
* a failed bundle fails only its own futures: :meth:`pump` runs the
  rest of the poll's bundles before it re-raises, and the async
  facade's pump thread outlives it (the reference stops at the first
  failure);
* ``_assemble`` builds a bundle's cold lanes with one
  ``SolverSession.cold`` over their stacked y0 (copied to the device
  once) and its warm lanes with one gather a leaf from each earlier
  bundle's session (which the server records in every handle it hands
  out, :class:`_ServedLane`), instead of one session a request joined
  by ``concat``; the lanes are independent, so the bits are those of
  the reference's construction;
* ``_execute`` reads the retcodes to the host once a bundle (not once a
  lane), and each lane's tensors are views made by one ``unbind`` or
  ``split`` a leaf, which launch nothing.  The server's own device reads
  (that one, and the fallback check) go through
  :func:`repro_torch.core.loops.read`, so ``loop_counts["host_syncs"]``
  counts them with the integrator's.
"""
from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from itertools import repeat
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core import status as _status
from ...core.batched import EnsembleStats, SolverSession
from ...core.context import Context
from ...core.ivp import IVP, Solution, integrate
from ...core.loops import read as _read
from ...core.policies import ExecPolicy, resolve_device
from ...kernels import _build
from .queue import (DEFAULT_BUCKET_SIZES, AdmissionQueue, Bundle,
                    IVPRequest, RetryAfter)
from .trace_cache import TraceCache, TraceKey

__all__ = ["ProblemFamily", "SolverServer", "RetryAfter",
           "SolverError", "DeadlineExceeded", "BackendUnavailable"]


class SolverError(RuntimeError):
    """A request's lane ended with a non-success CV_*-style retcode.

    Only the OFFENDING lane's Future fails with this; bundle-mates
    resolve normally (fault containment).  Carries the structured
    status so clients can dispatch on it:

    ``retcode``      — the integer flag (:mod:`repro_torch.core.status`)
    ``retcode_name`` — its symbolic name (``"CONV_FAILURE"``, ...)
    ``stats``        — the lane's :class:`~repro_torch.core.batched.
                       EnsembleStats` slice (steps, attempts, netf,
                       ncfn, ... for THIS lane)
    """

    def __init__(self, message: str, *, retcode: int = 0,
                 stats: Any = None):
        super().__init__(message)
        self.retcode = int(retcode)
        self.retcode_name = _status.retcode_name(retcode)
        self.stats = stats


class DeadlineExceeded(SolverError):
    """The request's deadline passed before its bundle executed; it was
    shed at flush time, and no solver work was spent on it."""


class BackendUnavailable(RuntimeError):
    """A bundle runner's way to say that its backend cannot serve the
    bundle: the one failure the server answers with the one-shot re-run
    on the plain versions (``SolverServer._degrade``).  The port's
    kernels and wrappers never raise it (their errors fail the bundle);
    the fault-injection harness does
    (:func:`repro_torch.testing.chaos.failing_executions`)."""


@dataclass(frozen=True)
class ProblemFamily:
    """A served problem class: a parametric batched RHS and Jacobian.

    The callables take the bundle's stacked per-request ``params`` (one
    tensor per key, system axis first) as a third argument:
    ``f(t:(nsys,), y:(nsys,n), params) -> (nsys,n)``, ``jac ->
    (nsys,n,n)``; the optional SoA forms follow the hot loop's layout
    (``f_soa(t, y:(n,nsys), params) -> (n,nsys)``, ``jac_soa ->
    (n,n,nsys)``).  ``params=None`` families close over everything.
    """

    name: str
    n: int
    f: Callable
    jac: Callable
    f_soa: Optional[Callable] = None
    jac_soa: Optional[Callable] = None


@dataclass
class _CompiledBundle:
    fn: Any            # (session, tf, params) -> (y, stats, session)
    build_s: float     # wall clock of building the runner
    meta: dict         # Solution fields (method, solver names, workspace
    #                    bytes) of the entry's first run, reused after it


#: request-latency histogram bucket upper bounds (seconds); the
#: Prometheus exposition adds the implicit +Inf bucket
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0)


class _LatencyRing:
    """Fixed-size latency sample window + lifetime histogram totals.

    Observations land in a preallocated ring (O(1) per sample) and
    percentile reads copy out at most ``size`` samples.  The Prometheus
    accumulators (per-bucket counts / sum / count) are LIFETIME totals
    and survive :meth:`clear`, so scrapes stay monotone even when a
    benchmark drains the percentile window per load point.
    """

    def __init__(self, size: int = 8192,
                 buckets: Tuple[float, ...] = _LATENCY_BUCKETS):
        self.size = int(size)
        if self.size < 1:
            raise ValueError("latency window must hold >= 1 sample")
        self.buckets = tuple(buckets)
        self._slots = [0.0] * self.size
        self._pos = 0
        self._n = 0
        self.total = 0                  # lifetime observation count
        self.sum_s = 0.0                # lifetime latency sum
        # non-cumulative per-bucket counts, last slot = +Inf overflow
        self.bucket_counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        self._slots[self._pos] = v
        self._pos = (self._pos + 1) % self.size
        self._n = min(self._n + 1, self.size)
        self.total += 1
        self.sum_s += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1
                break
        else:
            self.bucket_counts[-1] += 1

    @property
    def count(self) -> int:
        """Samples currently in the percentile window."""
        return self._n

    def window(self) -> List[float]:
        """The window's samples, oldest first."""
        if self._n < self.size:
            return self._slots[:self._n]
        return self._slots[self._pos:] + self._slots[:self._pos]

    def clear(self) -> List[float]:
        """Return the window and reset it (lifetime totals persist)."""
        out = self.window()
        self._pos = 0
        self._n = 0
        return out


def _as_state(y0):
    """A request's y0 as float64: a tensor stays where it lies (a warm
    client's y is a view on the card), anything else becomes a numpy
    array on the host."""
    if isinstance(y0, torch.Tensor):
        return y0 if y0.dtype == torch.float64 else y0.to(torch.float64)
    return np.asarray(y0, dtype=np.float64)


def _stack(values, npad: int, dev: torch.device) -> torch.Tensor:
    """One tensor of the per-request ``values`` (scalars or arrays)
    stacked along a new first axis, the last one repeated ``npad`` more
    times, on ``dev``: built on the host and copied once, unless a value
    is already a tensor."""
    if any(isinstance(v, torch.Tensor) for v in values):
        out = torch.stack([torch.as_tensor(v, dtype=torch.float64,
                                           device=dev) for v in values])
        return torch.cat([out, out[-1:].expand(npad, *out.shape[1:])]) \
            if npad else out
    arr = np.asarray(values, dtype=np.float64)
    if npad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], npad, axis=0)])
    return torch.from_numpy(arr).to(dev)


def _stack_params(values, npad: int, dev: torch.device):
    """The bundle's params: a dict (or a tuple or list) of per-request
    leaves becomes the same structure of stacked tensors."""
    p0 = values[0]
    if isinstance(p0, dict):
        return {k: _stack_params([v[k] for v in values], npad, dev)
                for k in p0}
    if isinstance(p0, (tuple, list)):
        return tuple(_stack_params([v[i] for v in values], npad, dev)
                     for i in range(len(p0)))
    return _stack(values, npad, dev)


class _ServedLane(SolverSession):
    """The warm-start handle the server hands out: a one-lane
    ``SolverSession`` of views of the bundle session ``origin`` at lane
    ``lane``, both recorded as the handle is made (the subclass has a
    ``__dict__``), so a later bundle gathers the handles of one origin
    with one ``index_select`` a leaf (:func:`_join_warm`)."""


def _served_lane(leaves, origin: SolverSession, lane: int) -> _ServedLane:
    h = _ServedLane._make(leaves)
    h.origin, h.lane = origin, lane
    return h


def _join_warm(sessions, dev: torch.device):
    """The warm lanes' sessions joined along the system axis, and the
    order of ``sessions`` they come out in.  Handles the server made
    from one bundle session are gathered from it with one
    ``index_select`` a leaf; any other handle is joined by ``concat``."""
    groups: Dict[int, tuple] = {}
    loose: List[int] = []
    for j, s in enumerate(sessions):
        origin = getattr(s, "origin", None)
        if origin is None:
            loose.append(j)
            continue
        g = groups.get(id(origin))
        if g is None:
            g = groups[id(origin)] = (origin, [], [])
        g[1].append(j)
        g[2].append(s.lane)
    parts, order = [], []
    for origin, js, lanes in groups.values():
        idx = torch.tensor(lanes, dtype=torch.long).to(origin.t.device)
        parts.append(SolverSession(*(x.index_select(-1, idx).to(dev)
                                     for x in origin)))
        order += js
    if loose:
        parts.append(SolverSession.concat(
            [SolverSession(*(x.to(dev) for x in sessions[j]))
             for j in loose]))
        order += loose
    return (parts[0] if len(parts) == 1 else SolverSession.concat(parts),
            order)


class SolverServer:
    """Dynamic-batching IVP server over the ensemble solver stack.

    ``device`` is where bundles run; None takes ``ctx.policy.device``,
    and if that is None too, the card.  Without ``ctx`` the server makes
    a ``Context`` on ``device``.  ``bucket_sizes=None`` means
    :data:`~repro_torch.serve.solver.queue.DEFAULT_BUCKET_SIZES` (see
    the queue module for why not a benchmark file).  Bundles are
    float64.
    """

    def __init__(self, families, ctx: Optional[Context] = None, *,
                 device=None, method: str = "ensemble_bdf", order: int = 5,
                 lin_solver=None,
                 bucket_sizes: Optional[Tuple[int, ...]] = None,
                 max_batch: Optional[int] = None,
                 max_wait: float = 2e-3, max_depth: int = 4096,
                 cache_size: int = 32, max_steps: int = 100_000,
                 warmup_bundles: int = 16,
                 clock: Callable[[], float] = time.monotonic,
                 latency_window: int = 8192):
        if isinstance(families, ProblemFamily):
            families = [families]
        self.families: Dict[str, ProblemFamily] = {
            fam.name: fam for fam in families}
        if not self.families:
            raise ValueError("SolverServer needs at least one ProblemFamily")
        self.ctx = ctx if ctx is not None else \
            Context(policy=ExecPolicy(device=device))
        self.device = resolve_device(
            device if device is not None else self.ctx.policy.device)
        self.method = method
        self.order = order
        self.lin_solver = lin_solver
        self.max_steps = max_steps
        self.clock = clock
        self.dtype = "float64"
        self.queue = AdmissionQueue(
            bucket_sizes=DEFAULT_BUCKET_SIZES if bucket_sizes is None
            else bucket_sizes,
            max_batch=max_batch, max_wait=max_wait, max_depth=max_depth,
            dtype=self.dtype, clock=clock, on_event=self._queue_event)
        self.cache = TraceCache(maxsize=cache_size)
        # context_metrics exports the cache counters from here
        self.ctx.trace_cache = self.cache
        self.warmup_bundles = int(warmup_bundles)
        self._lock = threading.Lock()       # queue admission/flush
        self._mlock = threading.Lock()      # metrics accumulators
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lat = _LatencyRing(latency_window)
        self._requests = 0
        self._bundles = 0
        self._live_lanes = 0
        self._padded_lanes = 0
        self._steady_misses = 0
        # fault-containment accumulators: failed requests by reason
        # (retcode name / "deadline" / "exec_error") and bundles re-run
        # on the plain versions (backend fallback)
        self._failures: Dict[str, int] = {}
        self._degraded = 0
        # per-bucket throughput: (family, n, nsys) -> accumulators
        self._bucket_stats: Dict[Tuple[str, int, int], dict] = {}

    def _queue_event(self, event: str, fields: dict) -> None:
        """AdmissionQueue observability hook -> the context logger
        (rejects are WARNING: they shed client load; the rest DEBUG)."""
        log = self.ctx.logger
        if not log.enabled:
            return
        if event == "queue.reject":
            log.warning(event, **fields)
        else:
            log.debug(event, **fields)

    # ------------------------------------------------------------------
    # submission (async facade surface)
    # ------------------------------------------------------------------

    def submit(self, family: str, y0, t0: float, tf: float, *,
               rtol: float = 1e-6, atol: float = 1e-9,
               params: Any = None, session: Any = None,
               method: Optional[str] = None,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one IVP; returns a Future resolving to its
        :class:`~repro_torch.core.ivp.Solution` (with ``timings`` and a
        warm-start ``session``).  Raises :class:`RetryAfter` when the
        queue is at depth: resubmit after ``exc.retry_after`` seconds.

        ``deadline`` is a RELATIVE budget in seconds: if the request is
        still queued when its bundle flushes past ``now + deadline``,
        it is shed with :class:`DeadlineExceeded` before any work.  A
        lane that fails inside the solver resolves its Future with a
        typed :class:`SolverError` (retcode + per-lane stats) while its
        bundle-mates resolve normally.
        """
        fam = self.families.get(family)
        if fam is None:
            raise ValueError(f"unknown family {family!r}; registered: "
                             f"{sorted(self.families)}")
        y0 = _as_state(y0)
        if tuple(y0.shape) != (fam.n,):
            raise ValueError(f"family {family!r} serves n={fam.n} "
                             f"systems; got y0 shape {tuple(y0.shape)}")
        if session is not None and (session.n != fam.n or
                                    session.nsys != 1):
            raise ValueError(
                f"session must be a single-lane handle for n={fam.n} "
                f"(got n={session.n}, nsys={session.nsys})")
        abs_deadline = None
        if deadline is not None:
            if deadline <= 0:
                raise ValueError(f"deadline must be > 0 (relative "
                                 f"seconds); got {deadline!r}")
            abs_deadline = self.clock() + float(deadline)
        req = IVPRequest(family=family, y0=y0, t0=float(t0),
                         tf=float(tf), rtol=rtol, atol=atol,
                         method=method or self.method, params=params,
                         session=session, deadline=abs_deadline,
                         future=Future())
        with self._lock:
            self.queue.offer(req)      # may raise RetryAfter
        self._wake.set()
        return req.future

    def submit_with_retry(self, family: str, y0, t0: float, tf: float,
                          *, retries: int = 6, jitter: float = 0.5,
                          seed: Optional[int] = None,
                          sleep: Callable[[float], None] = time.sleep,
                          **kw) -> Future:
        """:meth:`submit` with jittered exponential backoff on
        :class:`RetryAfter`.

        The rejection's depth-proportional ``retry_after`` hint seeds
        the delay, doubled per consecutive reject and spread by up to
        ``jitter * delay`` of seeded uniform noise so a rejected cohort
        does not re-arrive in lockstep.  ``seed`` makes the jitter
        deterministic; ``sleep`` is injectable for synchronous callers
        that pump the server themselves between attempts.  Re-raises the
        final :class:`RetryAfter` once ``retries`` rejections have been
        consumed.
        """
        rng = random.Random(seed)
        for attempt in range(retries + 1):
            try:
                return self.submit(family, y0, t0, tf, **kw)
            except RetryAfter as exc:
                if attempt >= retries:
                    raise
                delay = exc.retry_after * (2.0 ** attempt)
                delay *= 1.0 + jitter * rng.random()
                sleep(delay)
        raise AssertionError("unreachable")

    # ------------------------------------------------------------------
    # the synchronous core
    # ------------------------------------------------------------------

    def pump(self, now: Optional[float] = None,
             flush_all: bool = False) -> int:
        """Flush due bundles and execute them; returns bundles run.
        The deterministic core: tests drive it directly.  A bundle that
        fails has failed its own futures; the poll's other bundles run
        all the same, and the first failure is re-raised after them."""
        with self._lock:
            bundles = self.queue.poll(now, flush_all=flush_all)
        if not bundles:
            return 0
        errors = []
        with self.ctx.profiler.region("serve.pump", cat="serve",
                                      sync=False, bundles=len(bundles)):
            for bundle in bundles:
                try:
                    self._execute(bundle)
                except Exception as exc:
                    errors.append(exc)
        if errors:
            raise errors[0]
        return len(bundles)

    def drain(self) -> int:
        """Pump (flushing partial buckets) until the queue is empty."""
        total = 0
        while self.queue.depth:
            total += self.pump(flush_all=True)
        return total

    # ------------------------------------------------------------------
    # async facade
    # ------------------------------------------------------------------

    def start(self) -> "SolverServer":
        """Run the pump loop on a daemon thread (idempotent)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def pump_once(flush_all=False):
            # a failed bundle's futures carry its error, and metrics()
            # counts it: the thread serves on
            try:
                self.pump(flush_all=flush_all)
            except Exception:
                pass

        def loop():
            while not self._stop.is_set():
                self._wake.wait(timeout=0.5 * self.queue.max_wait)
                self._wake.clear()
                pump_once()
            pump_once(flush_all=True)   # don't strand queued futures

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="solver-serve-pump")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "SolverServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # bundle execution
    # ------------------------------------------------------------------

    def _assemble(self, bundle: Bundle):
        """The bundle's session, tf and params on the server's device.

        Cold lanes come from ONE ``SolverSession.cold`` over their
        stacked y0 and t0 (built on the host, copied once), warm lanes
        from one gather a leaf (:func:`_join_warm`); one ``index_select``
        a leaf then puts them back in request order and pads the dead
        lanes by replicating the last live lane, whose ``tf`` is its
        current t (a masked no-op from step one).  The params are
        stacked into one tensor per key, the last request's repeated
        into the dead lanes.
        """
        reqs, dev = bundle.requests, self.device
        npad = bundle.nsys - bundle.live
        cold = [i for i, r in enumerate(reqs) if r.session is None]
        warm = [i for i, r in enumerate(reqs) if r.session is not None]
        parts, order = [], []
        if cold:
            parts.append(SolverSession.cold(
                _stack([reqs[i].y0 for i in cold], 0, dev),
                _stack([reqs[i].t0 for i in cold], 0, dev)))
            order += cold
        if warm:
            joined, worder = _join_warm([reqs[i].session for i in warm],
                                        dev)
            parts.append(joined)
            order += [warm[j] for j in worder]
        sess = parts[0] if len(parts) == 1 else SolverSession.concat(parts)
        if npad or order != list(range(len(reqs))):
            # combined lane pos[i] holds request i
            pos = np.empty(len(reqs), dtype=np.int64)
            pos[order] = np.arange(len(reqs))
            idx = np.concatenate([pos, np.full(npad, pos[-1])])
            idx = torch.from_numpy(idx).to(dev)
            sess = SolverSession(*(x.index_select(-1, idx) for x in sess))
        tfa = _stack([r.tf for r in reqs], 0, dev)
        if npad:
            tfa = torch.cat([tfa, sess.t[-1:].expand(npad)])
        p0 = reqs[0].params
        if p0 is None:
            if any(r.params is not None for r in reqs):
                raise ValueError("mixed params/None requests in one "
                                 "family bundle")
            params = None
        else:
            params = _stack_params([r.params for r in reqs], npad, dev)
        return sess, tfa, params

    def _compile(self, key: TraceKey, policy=None) -> _CompiledBundle:
        """Build one bundle runner (the cache-miss path): the family's
        callables bound to the bucket's tolerance class, options,
        method, order and linear solver; on the card the kernel
        libraries are loaded here (built first if missing).  The build's
        wall clock is ``build_s``; the entry's first run records the
        Solution metadata reused for every later hit.  ``policy``
        overrides the context's (the fallback's plain versions)."""
        fam = self.families[key.bucket.family]
        t0 = time.perf_counter()
        with self.ctx.profiler.region("serve.compile", cat="serve",
                                      family=key.bucket.family,
                                      nsys=key.nsys):
            pol = self.ctx.policy if policy is None else policy
            opts = self.ctx.options(rtol=10.0 ** key.bucket.tol_class[0],
                                    atol=10.0 ** key.bucket.tol_class[1],
                                    max_steps=self.max_steps, policy=pol)
            if self.device.type == "cuda" and pol.backend != "torch":
                for lib in _build.SOURCES:
                    _build.load(lib)
            method = key.bucket.method
            meta: dict = {}

            def run(sess, tfa, params):
                fs = (lambda t, z: fam.f_soa(t, z, params)) \
                    if fam.f_soa is not None else None
                js = (lambda t, z: fam.jac_soa(t, z, params)) \
                    if fam.jac_soa is not None else None
                prob = IVP(f=lambda t, y: fam.f(t, y, params),
                           jac=lambda t, y: fam.jac(t, y, params),
                           f_soa=fs, jac_soa=js, y0=sess.Z[0].T)
                sol = integrate(prob, sess.t, tfa, method, ctx=self.ctx,
                                opts=opts, order=self.order,
                                lin_solver=self.lin_solver,
                                device=self.device, session=sess,
                                return_session=True)
                if not meta:
                    meta.update(method=sol.method, lin_solver=sol.lin_solver,
                                nonlin_solver=sol.nonlin_solver,
                                workspace_bytes=sol.workspace_bytes)
                return sol.y, sol.stats, sol.session

        return _CompiledBundle(fn=run, build_s=time.perf_counter() - t0,
                               meta=meta)

    def _count_failures(self, reason: str, k: int = 1) -> None:
        with self._mlock:
            self._failures[reason] = self._failures.get(reason, 0) + k

    def _run_compiled(self, entry: _CompiledBundle, sess, tfa, params):
        """The runner's invocation, ending when the device is done;
        isolated so the chaos harness can wrap it (a simulated runner
        failure) and the fallback path can reuse it."""
        y, st, sess_out = entry.fn(sess, tfa, params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return y, st, sess_out

    def _all_non_finite(self, y) -> bool:
        """An all-non-finite bundle state under the kernels (the
        reference's ``_needs_fallback``): the kernel path itself is
        implicated (a single diverging system quarantines per lane
        instead), so the bundle fails; it is not re-run on the plain
        versions.  One device reduction, one read."""
        if self.ctx.policy.backend == "torch" or y.numel() == 0:
            return False
        return not _read(torch.isfinite(y).any())

    def _shed_expired(self, bundle: Bundle) -> Optional[Bundle]:
        """Fail expired requests' Futures at FLUSH time (no work is spent
        on them) and rebuild the bundle from the survivors; returns None
        when nothing is left to execute."""
        now = self.clock()
        if not any(r.deadline is not None and now >= r.deadline
                   for r in bundle.requests):
            return bundle
        live: List[IVPRequest] = []
        shed = 0
        for req in bundle.requests:
            if req.deadline is not None and now >= req.deadline:
                shed += 1
                exc = DeadlineExceeded(
                    f"deadline exceeded before execution "
                    f"(queued {now - req.arrival:.3f}s)")
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(exc)
            else:
                live.append(req)
        self._count_failures("deadline", shed)
        log = self.ctx.logger
        if log.enabled_for("WARNING"):
            log.warning("serve.deadline_shed", family=bundle.key.family,
                        shed=shed, live=len(live))
        if not live:
            return None
        return Bundle(key=bundle.key, requests=live,
                      nsys=self.queue.pad_to(len(live)),
                      flushed=bundle.flushed)

    def _degrade(self, bundle: Bundle, sess, tfa, params, exc):
        """One-shot backend fallback after :class:`BackendUnavailable`:
        re-run the bundle on the plain PyTorch versions on the same
        device (its own TraceKey, so the degraded runner is cached too).
        A failure HERE propagates: the fallback is not retried."""
        policy = ExecPolicy(backend="torch", device=str(self.device))
        fkey = TraceKey(bucket=bundle.key, nsys=bundle.nsys, policy=policy)
        entry, hit = self.cache.get(
            fkey, lambda: self._compile(fkey, policy=policy))
        y, st, sess_out = self._run_compiled(entry, sess, tfa, params)
        with self._mlock:
            self._degraded += 1
        log = self.ctx.logger
        if log.enabled_for("WARNING"):
            log.warning("serve.bundle.degraded",
                        family=bundle.key.family, nsys=bundle.nsys,
                        reason=f"{type(exc).__name__}: {exc}"[:200])
        return y, st, sess_out, entry, hit

    def _execute(self, bundle: Bundle) -> None:
        prof = self.ctx.profiler
        if prof.enabled:
            # the queue stamps arrival/flushed on the SERVER clock;
            # capture both clocks at one instant so queue events map
            # onto the profiler timebase
            p_anchor, s_anchor = prof.now(), self.clock()
        shed = self._shed_expired(bundle)
        if shed is None:
            return
        bundle = shed
        degraded = False
        try:
            with prof.region("serve.assemble", cat="serve", sync=False):
                sess, tfa, params = self._assemble(bundle)
            key = TraceKey(bucket=bundle.key, nsys=bundle.nsys,
                           policy=self.ctx.policy)
            entry, hit = self.cache.get(key, lambda: self._compile(key))
            if not hit and self._bundles >= self.warmup_bundles:
                with self._mlock:
                    self._steady_misses += 1
            t0 = time.perf_counter()
            try:
                y, st, sess_out = self._run_compiled(entry, sess, tfa,
                                                     params)
            except BackendUnavailable as unavailable:
                y, st, sess_out, entry, hit = self._degrade(
                    bundle, sess, tfa, params, unavailable)
                degraded = True
            else:
                if self._all_non_finite(y):
                    raise RuntimeError(
                        "bundle state is entirely non-finite under "
                        f"backend {self.ctx.policy.backend!r}")
            t1 = time.perf_counter()
            exec_s = t1 - t0
        except Exception as exc:       # resolve, don't strand, futures
            self._count_failures("exec_error", len(bundle.requests))
            log = self.ctx.logger
            if log.enabled_for("ERROR"):
                log.error("serve.bundle.failed", family=bundle.key.family,
                          nsys=bundle.nsys,
                          reason=f"{type(exc).__name__}: {exc}"[:200])
            for req in bundle.requests:
                if not req.future.set_running_or_notify_cancel():
                    continue
                req.future.set_exception(
                    exc if isinstance(exc, SolverError) else
                    SolverError(f"bundle execution failed: {exc}"))
            raise
        done = self.clock()
        bkey = (bundle.key.family, bundle.key.n, bundle.nsys)
        with self._mlock:
            self._bundles += 1
            self._requests += bundle.live
            self._live_lanes += bundle.live
            self._padded_lanes += bundle.nsys
            for req in bundle.requests:
                self._lat.observe(done - req.arrival)
            row = self._bucket_stats.setdefault(
                bkey, {"requests": 0, "bundles": 0, "exec_s": 0.0})
            row["requests"] += bundle.live
            row["bundles"] += 1
            row["exec_s"] += exec_s
        if prof.enabled:
            # per-bundle serving timeline (arrival -> flush -> compile ->
            # execute), mapped onto the profiler timebase
            pmap = lambda ts: p_anchor + (ts - s_anchor)
            wait0 = pmap(min(r.arrival for r in bundle.requests))
            flush = pmap(bundle.flushed)
            args = {"family": bundle.key.family, "live": bundle.live,
                    "nsys": bundle.nsys}
            prof.add_span("serve.bundle.queue_wait", wait0, flush,
                          cat="serve", args=args)
            prof.add_span("serve.bundle.compile", flush,
                          flush + (0.0 if hit else entry.build_s),
                          cat="serve", args={**args, "cached": hit})
            prof.add_span("serve.bundle.execute", t0, t1,
                          cat="serve", args=args)
        log = self.ctx.logger
        if log.enabled_for("INFO"):
            log.info("serve.bundle", family=bundle.key.family,
                     live=bundle.live, nsys=bundle.nsys, cached=hit,
                     compile_s=0.0 if hit else entry.build_s,
                     exec_s=exec_s)
        # per-lane retcodes, read once a bundle: only OFFENDING lanes
        # fail (typed SolverError with retcode + per-lane stats);
        # bundle-mates resolve normally
        retcodes = _read(st.retcodes[:bundle.live]) \
            if st.retcodes is not None else [0] * bundle.live
        failed_lanes = []
        for i, (req, rc, lane) in enumerate(zip(
                bundle.requests, retcodes,
                self._lane_views(y, st, sess_out, bundle.live))):
            if rc != 0:
                exc = SolverError(
                    f"lane failed with {_status.retcode_name(rc)} "
                    f"({rc}) [{_status.SUNDIALS_FLAGS.get(rc, '?')}]",
                    retcode=rc, stats=lane[2])
                self._count_failures(_status.retcode_name(rc))
                failed_lanes.append(i)
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(exc)
                continue
            sol = self._lane_solution(req, bundle, lane, entry, hit, exec_s,
                                      degraded)
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(sol)
        if failed_lanes and log.enabled_for("WARNING"):
            log.warning("serve.lane_failed", family=bundle.key.family,
                        failed=len(failed_lanes), live=bundle.live,
                        lanes=failed_lanes[:16])

    @staticmethod
    def _lane_views(y, st, sess_out, live: int):
        """``(y, t, stats, session)`` of each of the first ``live``
        lanes, as views: one ``unbind`` a leaf (for the session, one
        ``split``, which keeps the system axis, into a
        :class:`_ServedLane` that records its lane of ``sess_out``),
        then zipped lane by lane (the host's cost grows with the views a
        lane holds, about 20, not with the bundle's device work)."""
        cols = [repeat(None) if a is None else a[..., :live].unbind(-1)
                for a in st]
        leaves = [x[..., :live].split(1, dim=-1) for x in sess_out]
        return zip(y[:live].unbind(0), sess_out.t[:live].unbind(0),
                   map(EnsembleStats._make, zip(*cols)),
                   map(_served_lane, zip(*leaves), repeat(sess_out),
                       range(live)))

    def _lane_solution(self, req: IVPRequest, bundle: Bundle, lane,
                       entry: _CompiledBundle, hit: bool, exec_s: float,
                       degraded: bool = False) -> Solution:
        """One request's Solution: the bundle result restricted to its
        lane (dead padded lanes never reach a client), plus the serving
        wall-clock split and the warm-start session handle.

        ``degraded`` marks results recomputed on the plain versions
        after the configured backend failed (one-shot fallback)."""
        y, t, st, session = lane
        meta = entry.meta
        timings = {"queue_wait": bundle.flushed - req.arrival,
                   "compile": 0.0 if hit else entry.build_s,
                   "execute": exec_s}
        return Solution(
            y=y, t=t, success=st.success, stats=st,
            method=meta["method"], lin_solver=meta["lin_solver"],
            nonlin_solver=meta["nonlin_solver"], nni=st.nni, nli=st.nli,
            nsetups=st.nsetups, workspace_bytes=meta["workspace_bytes"],
            high_water_bytes=self.ctx.memory.high_water_bytes,
            npsolves=st.npsolves, npsetups=None, session=session,
            timings=timings, retcodes=st.retcodes, ok=st.ok,
            degraded=degraded)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @staticmethod
    def _quantile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1,
                  max(0, int(round(q * (len(sorted_vals) - 1)))))
        return sorted_vals[idx]

    def take_latencies(self) -> List[float]:
        """Return and clear the request-latency window (seconds), so a
        benchmark can attribute percentiles to one load point.  The
        lifetime histogram behind ``metrics_prometheus()`` is
        unaffected (scrapes stay monotone)."""
        with self._mlock:
            return self._lat.clear()

    def metrics(self) -> dict:
        """Serving health: queue depth, occupancy (live vs padded
        lanes), latency percentiles over the bounded sample window
        (``latency_samples`` of ``latency_observed`` lifetime
        observations), the bundle cache's counters, and the audit of
        cache misses after the warm-up (``steady_misses``)."""
        with self._mlock:
            lat = sorted(self._lat.window())
            live, padded = self._live_lanes, self._padded_lanes
            out = {
                "queue_depth": self.queue.depth,
                "rejected": self.queue.rejected,
                "requests": self._requests,
                "bundles": self._bundles,
                "live_lanes": live,
                "padded_lanes": padded,
                "occupancy": (live / padded) if padded else 0.0,
                "latency_p50_s": self._quantile(lat, 0.50),
                "latency_p99_s": self._quantile(lat, 0.99),
                "latency_samples": self._lat.count,
                "latency_observed": self._lat.total,
                "steady_misses": self._steady_misses,
                "warmup_bundles": self.warmup_bundles,
                "trace_cache": self.cache.stats(),
                "failures": dict(self._failures),
                "degraded": self._degraded,
            }
        return out

    def metrics_prometheus(self) -> str:
        """The same serving health as :meth:`metrics`, in Prometheus text
        exposition format, plus the context's counters and the bundle
        cache's (one scrape covers the serving tier AND the solver
        core).  Names: ``repro_serve_*`` for the serving tier (per-bucket
        throughput labelled ``{family, n, nsys}``), ``repro_context_*``
        and ``repro_trace_cache_*`` from :func:`repro_torch.
        observability.metrics.context_metrics`."""
        from ...observability.metrics import MetricsRegistry, context_metrics
        reg = MetricsRegistry()
        m = self.metrics()
        reg.counter("repro_serve_requests",
                    "Requests served").set_cumulative(m["requests"])
        reg.counter("repro_serve_bundles",
                    "Bundles executed").set_cumulative(m["bundles"])
        reg.counter("repro_serve_rejected",
                    "Requests rejected at max queue depth"
                    ).set_cumulative(m["rejected"])
        reg.counter("repro_serve_steady_misses",
                    "Bundle-cache misses after warmup"
                    ).set_cumulative(m["steady_misses"])
        fail = reg.counter(
            "repro_serve_failures",
            "Requests failed, labeled by reason (retcode name, "
            "deadline, exec_error)")
        for reason, count in sorted(m["failures"].items()):
            fail.set_cumulative(count, reason=reason)
        reg.counter("repro_serve_degraded",
                    "Bundles recomputed on the plain versions after a "
                    "backend failure").set_cumulative(m["degraded"])
        reg.counter("repro_serve_live_lanes",
                    "Live lanes executed").set_cumulative(m["live_lanes"])
        reg.counter("repro_serve_padded_lanes",
                    "Total lanes executed incl. padding"
                    ).set_cumulative(m["padded_lanes"])
        reg.gauge("repro_serve_queue_depth",
                  "Queued, unflushed requests").set(m["queue_depth"])
        reg.gauge("repro_serve_occupancy",
                  "Live / padded lane ratio").set(m["occupancy"])
        reg.gauge("repro_serve_latency_p50_seconds",
                  "Window median request latency"
                  ).set(m["latency_p50_s"])
        reg.gauge("repro_serve_latency_p99_seconds",
                  "Window p99 request latency").set(m["latency_p99_s"])
        reg.gauge("repro_serve_latency_samples",
                  "Samples in the percentile window"
                  ).set(m["latency_samples"])
        with self._mlock:
            hist = reg.histogram("repro_serve_latency_seconds",
                                 "Request latency (admission to result)",
                                 buckets=self._lat.buckets)
            hist.set_counts(list(self._lat.bucket_counts),
                            self._lat.sum_s, self._lat.total)
            bucket_rows = {k: dict(v)
                           for k, v in self._bucket_stats.items()}
        breq = reg.counter("repro_serve_bucket_requests",
                           "Requests served per shape bucket")
        bbun = reg.counter("repro_serve_bucket_bundles",
                           "Bundles executed per shape bucket")
        bexe = reg.counter("repro_serve_bucket_exec_seconds",
                           "Execute wall-clock per shape bucket")
        for (family, n, nsys), row in sorted(bucket_rows.items()):
            labels = {"family": family, "n": str(n), "nsys": str(nsys)}
            breq.set_cumulative(row["requests"], **labels)
            bbun.set_cumulative(row["bundles"], **labels)
            bexe.set_cumulative(row["exec_s"], **labels)
        context_metrics(reg, self.ctx)
        return reg.render()
