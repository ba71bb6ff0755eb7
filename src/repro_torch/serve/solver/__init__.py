"""Dynamic-batching IVP serving front-end: admission queue -> shape
bucket -> bundle cache -> warm-start continuation.

Counterpart of ``repro.serve.solver``, with the same exports.  Layers
(one module each, composed by :class:`SolverServer`):

* :mod:`repro_torch.serve.solver.queue` — admission and dynamic
  batching: requests are bucketed by (problem family, shape n, method,
  tolerance class, dtype) and flushed on a max-batch-or-max-wait
  policy, padded to fixed bucket sizes, with bounded-depth backpressure
  (:class:`RetryAfter` instead of unbounded queue growth).
* :mod:`repro_torch.serve.solver.trace_cache` — the shape-bucketed cache
  of bundle runners keyed on (bucket, padded nsys, ExecPolicy):
  steady-state traffic builds nothing; its hit/miss/evict counters
  reach the Prometheus scrape through ``Context.trace_cache``.
* :mod:`repro_torch.serve.solver.server` — the synchronous core with an
  async facade: pumps bundles through ``integrate`` on the card,
  resolves per-request futures, reports queue depth, batch occupancy
  and p50/p99 latency.

Warm-start continuation rides
:class:`repro_torch.core.batched.SolverSession`: responses carry a
session handle, and resubmitting with it re-enters the BDF loop at the
last order and step instead of the cold order-1 start.
"""
from repro_torch.core.batched import SolverSession  # the warm-start handle

from .queue import (AdmissionQueue, Bundle, BucketKey, IVPRequest,
                    RetryAfter, bucket_key, bucket_sizes_from_bench,
                    tolerance_class)
from .server import ProblemFamily, SolverServer
from .trace_cache import TraceCache, TraceKey

__all__ = [
    "AdmissionQueue", "Bundle", "BucketKey", "IVPRequest", "RetryAfter",
    "bucket_key", "bucket_sizes_from_bench", "tolerance_class",
    "ProblemFamily", "SolverServer", "SolverSession",
    "TraceCache", "TraceKey",
]
