"""The SUNLogger / SUNProfiler analogs of the port: region profiling,
structured event logging, step telemetry on the device and Prometheus
metrics.

Counterpart of ``repro.observability``, with the same exports.
Everything is opt-in through :class:`ObservabilityConfig` on
``Context``; with it off, ``integrate`` records nothing.
"""
from .config import ObservabilityConfig
from .logger import LEVELS, EventLogger
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      context_metrics)
from .profiler import Profiler, Span
from .telemetry import (RECORD_FIELDS, StepTelemetry, TelemetryRing,
                        ring_init, ring_record)

__all__ = [
    "ObservabilityConfig",
    "EventLogger", "LEVELS",
    "Profiler", "Span",
    "TelemetryRing", "ring_init", "ring_record", "StepTelemetry",
    "RECORD_FIELDS",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "context_metrics",
]
