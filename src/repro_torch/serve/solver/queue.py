"""Admission queue: shape-bucketed dynamic batching for IVP requests.

Counterpart of ``repro.serve.solver.queue``, class for class.
Independent systems only share the per-step cost of the batched
integrator when they ride one bundle, so only requests that agree on
everything a bundle is specialised on may share one.  The bucket key is
that set:

* ``family`` + ``n`` — the RHS/Jacobian callables and the state size;
* ``method`` — the integrator the bundle runs;
* ``tol_class`` — the tolerance decade ``(floor(log10 rtol),
  floor(log10 atol))``: requests are served at their class
  representative ``10**class`` (at least as tight as asked);
* ``dtype`` — the bundle's dtype (``"float64"``).

A bucket flushes when it holds ``max_batch`` requests (a full bundle) or
when its oldest request has waited ``max_wait`` seconds (the latency
bound).  Flushed groups are padded up to the nearest *bucket size*, so
the bundle cache (:mod:`repro_torch.serve.solver.trace_cache`) sees a
small, fixed set of shapes whatever sizes traffic arrives in.

Backpressure is bounded-depth admission: at ``max_depth`` queued
requests :meth:`AdmissionQueue.offer` raises :class:`RetryAfter` with a
retry hint taken from the measured drain rate, instead of growing
without bound.

**One deliberate difference.**  The reference's server reads its bucket
sizes from ``BENCH_ensemble.json`` by default; those rows are the JAX
package's interpret-mode CPU runs, not the card's.  Here the server's
``bucket_sizes=None`` means :data:`DEFAULT_BUCKET_SIZES`, and
:func:`bucket_sizes_from_bench` reads only a file its caller names, with
rows ``{nsys, plain_systems_per_sec, kernel_systems_per_sec}`` measured
on the card, under the reference's rule.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


def tolerance_class(rtol: float, atol: float) -> Tuple[int, int]:
    """The tolerance decade a request is bucketed (and served) at:
    ``(floor(log10 rtol), floor(log10 atol))``.  Serving at
    ``10**class`` is at least as tight as the request asked for."""
    if not (0 < rtol < 1 and 0 < atol < 1):
        raise ValueError(f"tolerances must be in (0, 1); got "
                         f"rtol={rtol!r}, atol={atol!r}")
    return (int(math.floor(math.log10(rtol))),
            int(math.floor(math.log10(atol))))


class RetryAfter(RuntimeError):
    """Admission rejected: the queue is at ``max_depth``.  ``retry_after``
    (seconds) is the server's drain-rate hint; resubmit after it."""

    def __init__(self, retry_after: float, depth: int, max_depth: int):
        self.retry_after = float(retry_after)
        self.depth = depth
        self.max_depth = max_depth
        super().__init__(
            f"queue at max depth ({depth}/{max_depth}); "
            f"retry after {retry_after:.3f}s")


@dataclass
class IVPRequest:
    """One client request: integrate ``y0`` (n,) from t0 to tf.

    ``params`` is a dict (or a tuple) of per-system leaves (scalars or
    arrays WITHOUT a system axis) that the server stacks into one tensor
    per key and hands to the family's RHS/Jacobian as data, so requests
    with other physics share one bundle.
    ``session`` is an optional single-lane
    :class:`~repro_torch.core.batched.SolverSession` from a previous
    response: the warm-start continuation handle.
    ``deadline`` is an absolute timestamp on the server's clock; a
    request whose deadline has passed when its bundle flushes is shed
    (its Future fails with ``DeadlineExceeded``) BEFORE any compute is
    spent on it.
    """

    family: str
    y0: Any
    t0: float
    tf: float
    rtol: float = 1e-6
    atol: float = 1e-9
    method: str = "ensemble_bdf"
    params: Any = None
    session: Any = None
    deadline: Optional[float] = None
    # filled in by the queue / server:
    arrival: float = 0.0
    future: Any = None

    @property
    def n(self) -> int:
        return int(self.y0.shape[-1])


@dataclass(frozen=True)
class BucketKey:
    """Everything a bundle is specialised on (except nsys, which
    padding quantises separately)."""

    family: str
    n: int
    method: str
    tol_class: Tuple[int, int]
    dtype: str


def bucket_key(req: IVPRequest, dtype: str) -> BucketKey:
    return BucketKey(family=req.family, n=req.n, method=req.method,
                     tol_class=tolerance_class(req.rtol, req.atol),
                     dtype=dtype)


@dataclass
class Bundle:
    """A flushed group of same-bucket requests, to be padded to
    ``nsys`` lanes (``len(requests) <= nsys``) and executed as one
    batched integration."""

    key: BucketKey
    requests: List[IVPRequest]
    nsys: int                  # padded lane count (the bucket size)
    flushed: float             # queue-exit timestamp

    @property
    def live(self) -> int:
        return len(self.requests)

    @property
    def occupancy(self) -> float:
        return self.live / self.nsys


DEFAULT_BUCKET_SIZES = (64, 128, 256, 512)


def bucket_sizes_from_bench(path: str, max_size: int = 512,
                            fill: Tuple[int, ...] = (64, 128, 256)
                            ) -> Tuple[int, ...]:
    """Padded bundle sizes from a benchmark of the card that ``path``
    names: a JSON object whose ``"results"`` rows carry ``nsys``,
    ``plain_systems_per_sec`` and ``kernel_systems_per_sec``.

    Every ``nsys`` where the kernels beat the plain versions (ratio >=
    1) is a measured sweet spot; sizes above ``max_size`` are dropped (a
    flush should not wait for 32768 requests), and the small ``fill``
    sizes are merged in so light traffic pads to tens of lanes.  Falls
    back to :data:`DEFAULT_BUCKET_SIZES` when the file is missing or
    malformed: the queue must admit traffic on a fresh checkout too.
    """
    sizes = set(fill)
    try:
        with open(path) as fh:
            bench = json.load(fh)
        for row in bench.get("results", []):
            ratio = (row["kernel_systems_per_sec"]
                     / row["plain_systems_per_sec"])
            if ratio >= 1.0 and row["nsys"] <= max_size:
                sizes.add(int(row["nsys"]))
    except (OSError, ValueError, KeyError):
        return DEFAULT_BUCKET_SIZES
    return tuple(sorted(sizes))


@dataclass
class _Bucket:
    requests: List[IVPRequest] = field(default_factory=list)
    oldest: float = 0.0


class AdmissionQueue:
    """Bucketed admission with max-batch-or-max-wait flushing and
    bounded-depth backpressure.

    The queue is time-explicit: :meth:`offer` and :meth:`poll` take an
    optional ``now`` so servers (and tests) can drive it from their own
    clock; the default is ``time.monotonic``.  Thread safety is the
    owner's job (:class:`~repro_torch.serve.solver.server.SolverServer` holds
    one lock around both).
    """

    def __init__(self, bucket_sizes: Tuple[int, ...] = DEFAULT_BUCKET_SIZES,
                 max_batch: Optional[int] = None,
                 max_wait: float = 2e-3,
                 max_depth: int = 4096,
                 dtype: str = "float64",
                 clock: Callable[[], float] = time.monotonic,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        if not bucket_sizes:
            raise ValueError("need at least one bucket size")
        self.bucket_sizes = tuple(sorted(set(int(s) for s in bucket_sizes)))
        self.max_batch = int(max_batch or self.bucket_sizes[-1])
        if self.max_batch > self.bucket_sizes[-1]:
            raise ValueError(
                f"max_batch={self.max_batch} exceeds the largest bucket "
                f"size {self.bucket_sizes[-1]} — a full flush could not "
                "be padded")
        self.max_wait = float(max_wait)
        self.max_depth = int(max_depth)
        self.dtype = dtype
        self.clock = clock
        self._buckets: Dict[BucketKey, _Bucket] = {}
        self._depth = 0
        self.rejected = 0
        # drain-rate EMA (requests/sec over flushes) backing the
        # depth-proportional RetryAfter hint
        self._drain_rate = 0.0
        self._last_flush: Optional[float] = None
        #: observability hook — called as ``on_event(name, fields)`` for
        #: ``queue.admit`` / ``queue.reject`` / ``queue.flush`` (the
        #: server forwards these into its EventLogger)
        self.on_event = on_event

    def _emit(self, event: str, **fields) -> None:
        if self.on_event is not None:
            self.on_event(event, fields)

    @property
    def depth(self) -> int:
        """Total queued (not yet flushed) requests."""
        return self._depth

    def retry_hint(self, now: Optional[float] = None) -> float:
        """Backoff hint for a rejected request: the time the CURRENT
        backlog needs to drain at the measured flush rate.

        The old flat ``2.0 * max_wait`` hint was load-blind — every
        rejected client came back after the same tiny delay no matter
        how deep the queue was, so under sustained overload the whole
        rejected cohort thundering-herded back into another reject.
        Depth-proportional hints make the
        :meth:`~repro_torch.serve.solver.server.SolverServer.submit_with_retry`
        jittered-exponential backoff converge: the deeper the backlog
        (or the slower the drain), the longer the hint.  Before any
        flush has been observed the hint falls back to backlog-in-
        flush-windows (``max_wait * depth / max_batch``).  Clamped to
        ``[max_wait, 30s]``.
        """
        del now  # reserved for an age-aware hint; EMA is time-free
        if self._drain_rate > 0.0:
            hint = self._depth / self._drain_rate
        else:
            hint = self.max_wait * (self._depth / max(self.max_batch, 1))
        return float(min(max(hint, self.max_wait), 30.0))

    def pad_to(self, count: int) -> int:
        """The bucket size a ``count``-request group is padded to: the
        smallest size that fits (groups are capped at ``max_batch``,
        which is itself capped at the largest size)."""
        for s in self.bucket_sizes:
            if count <= s:
                return s
        return self.bucket_sizes[-1]

    def offer(self, req: IVPRequest, now: Optional[float] = None) -> None:
        """Admit one request, or raise :class:`RetryAfter` when the
        queue is at ``max_depth`` (bounded backpressure)."""
        now = self.clock() if now is None else now
        if self._depth >= self.max_depth:
            self.rejected += 1
            hint = self.retry_hint(now)
            self._emit("queue.reject", depth=self._depth,
                       retry_after=hint)
            raise RetryAfter(hint, self._depth, self.max_depth)
        req.arrival = now
        key = bucket_key(req, self.dtype)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket()
        if not bucket.requests:
            bucket.oldest = now
        bucket.requests.append(req)
        self._depth += 1
        self._emit("queue.admit", family=req.family, depth=self._depth)

    def poll(self, now: Optional[float] = None,
             flush_all: bool = False) -> List[Bundle]:
        """Flush every due bucket: full (``>= max_batch``) or stale
        (oldest waited ``>= max_wait``).  ``flush_all=True`` drains
        everything regardless of age (shutdown / synchronous drive)."""
        now = self.clock() if now is None else now
        bundles: List[Bundle] = []
        for key, bucket in self._buckets.items():
            while len(bucket.requests) >= self.max_batch:
                take = bucket.requests[:self.max_batch]
                bucket.requests = bucket.requests[self.max_batch:]
                self._depth -= len(take)
                bundles.append(Bundle(key=key, requests=take,
                                      nsys=self.pad_to(len(take)),
                                      flushed=now))
            if bucket.requests and (flush_all or
                                    now - bucket.oldest >= self.max_wait):
                take, bucket.requests = bucket.requests, []
                self._depth -= len(take)
                bundles.append(Bundle(key=key, requests=take,
                                      nsys=self.pad_to(len(take)),
                                      flushed=now))
            if bucket.requests:
                # remaining requests are in arrival order; the clock
                # for the next stale-flush starts at the new head
                bucket.oldest = bucket.requests[0].arrival
        if bundles:
            flushed = sum(b.live for b in bundles)
            if self._last_flush is not None and now > self._last_flush:
                inst = flushed / (now - self._last_flush)
                self._drain_rate = inst if self._drain_rate == 0.0 else \
                    0.2 * inst + 0.8 * self._drain_rate
            self._last_flush = now
        if self.on_event is not None:
            for b in bundles:
                self._emit("queue.flush", family=b.key.family,
                           live=b.live, nsys=b.nsys,
                           wait_s=now - min(r.arrival for r in b.requests))
        return bundles
