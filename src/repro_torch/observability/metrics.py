"""Prometheus-style metrics: counters, gauges and histograms with
labels, rendered in the text exposition format.

Counterpart of ``repro.observability.metrics``, line for line: ``# HELP``
/ ``# TYPE`` lines, ``_total`` counter names, cumulative
``_bucket{le=...}`` histogram rows.  :func:`context_metrics` folds a
``Context``'s run-wide counters (and a serving trace cache's, where one
is attached) into a registry.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Optional[dict]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: Optional[List[Tuple[str, str]]] = None
                ) -> str:
    pairs = list(key) + list(extra or [])
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotone counter; exposed as ``<name>_total``."""

    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labelkey(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def set_cumulative(self, value: float, **labels) -> None:
        """Set the running total directly (for counters whose source of
        truth lives elsewhere, e.g. ``Context.counters``)."""
        self._values[_labelkey(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._values.get(_labelkey(labels), 0.0)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name}_total {self.help}",
                 f"# TYPE {self.name}_total counter"]
        for key in sorted(self._values):
            lines.append(f"{self.name}_total{_fmt_labels(key)} "
                         f"{_fmt_value(self._values[key])}")
        return lines


class Gauge:
    """Point-in-time value."""

    kind = "gauge"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[_labelkey(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelkey(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_labelkey(labels), 0.0)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for key in sorted(self._values):
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_value(self._values[key])}")
        return lines


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative exposition."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float]):
        self.name = name
        self.help = help
        ub = sorted(float(b) for b in buckets)
        if not ub:
            raise ValueError("histogram needs at least one bucket")
        self.uppers = ub + [math.inf]
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _labelkey(labels)
        counts = self._counts.setdefault(key, [0] * len(self.uppers))
        for i, ub in enumerate(self.uppers):
            if value <= ub:
                counts[i] += 1
                break
        self._sum[key] = self._sum.get(key, 0.0) + float(value)
        self._n[key] = self._n.get(key, 0) + 1

    def set_counts(self, bucket_counts: Sequence[int], total_sum: float,
                   total_n: int, **labels) -> None:
        """Load pre-aggregated (non-cumulative) per-bucket counts, e.g.
        from the server's latency ring."""
        key = _labelkey(labels)
        counts = list(int(c) for c in bucket_counts)
        if len(counts) != len(self.uppers):
            raise ValueError(
                f"expected {len(self.uppers)} bucket counts "
                f"(incl. +Inf), got {len(counts)}")
        self._counts[key] = counts
        self._sum[key] = float(total_sum)
        self._n[key] = int(total_n)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key in sorted(self._counts):
            cum = 0
            for ub, c in zip(self.uppers, self._counts[key]):
                cum += c
                le = _fmt_value(ub)
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, [('le', le)])} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(self._sum.get(key, 0.0))}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{self._n.get(key, 0)}")
        return lines


class MetricsRegistry:
    """Named metric store + text-format renderer.

    Re-registering an existing name returns the existing metric (so
    exporters can be written idempotently); a kind clash raises.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind: str, factory):
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, "counter", lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, "gauge", lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = (0.005, 0.05, 0.5, 5.0)
                  ) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(name, help, buckets))

    def render(self) -> str:
        """The full Prometheus text exposition (``text/plain``)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"


def context_metrics(reg: MetricsRegistry, ctx) -> None:
    """Export ``Context.counters`` (and the trace cache's and the
    dispatch report's numbers, where the context has them) into ``reg``
    under the ``repro_context_*`` / ``repro_trace_cache_*`` /
    ``repro_autotune_*`` names of the reference."""
    for k, v in ctx.counters.items():
        c = reg.counter(f"repro_context_{k}",
                        f"Context lifetime counter: {k}")
        c.set_cumulative(float(v))
    tc = getattr(ctx, "trace_cache", None)
    if tc is not None:
        stats = tc.stats() if callable(getattr(tc, "stats", None)) else {}
        for k in ("hits", "misses", "evictions"):
            if k in stats:
                reg.counter(f"repro_trace_cache_{k}",
                            f"Context trace-cache {k}"
                            ).set_cumulative(float(stats[k]))
        if "size" in stats:
            reg.gauge("repro_trace_cache_size",
                      "Context trace-cache entries").set(float(stats["size"]))
        if "hit_rate" in stats and stats["hit_rate"] is not None:
            reg.gauge("repro_trace_cache_hit_rate",
                      "Context trace-cache hit rate"
                      ).set(float(stats["hit_rate"]))
    rep = ctx.dispatch_report()
    if rep:
        reg.gauge("repro_autotune_cache_entries",
                  "Persisted autotune cache entries"
                  ).set(float(rep.get("cache_entries", 0)))
        reg.counter("repro_autotune_decisions",
                    "Autotune dispatch decisions made"
                    ).set_cumulative(float(len(rep.get("decisions", []))))
        agree = rep.get("model_agreement")
        if agree is not None:
            reg.gauge("repro_autotune_model_agreement",
                      "Cost-model vs measured dispatch agreement"
                      ).set(float(agree))
