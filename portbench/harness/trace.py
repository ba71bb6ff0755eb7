"""What the traced run reads from ``torch.profiler``: device time by
layer, the kernels' roofline share, the device's idle share and the
breakdown of device operations and idle gaps.

The device stage's profile records the card's activity alone over whole
calls, whose start and end the session takes on the host's clock; the
host stage's span of one call gives that clock's offset from the
profiler's (a run whose device time still falls outside its calls
fails).  The host stage's profile adds the host's operations over one
call inside the benchmark's own span ``portbench.call``; it only labels
the idle gaps.  Everything here works on plain event tuples
``(name, start_us, end_us, thread)``, so it can be tried on synthetic
intervals without a card.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple, Optional

CALL_SPAN = "portbench.call"
#: a kernel declaration in the port's CUDA sources
_GLOBAL_RE = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")
#: how far back the innermost host op is looked for
_LOOKBACK = 64


class Event(NamedTuple):
    name: str
    start: float    # microseconds on the profiler's clock
    end: float
    thread: int = 0


class Summary(NamedTuple):
    calls: int                  # calls of the device stage
    window_s: float             # their first start to their last end
    busy_s: float               # union of device intervals in the window
    plain_s: float              # device time of kernels not the port's
    kernel_s: float             # device time of the port's kernels
    roofline_share: Optional[float]   # percent, None without op files
    unmatched: tuple            # port kernels with no op file
    by_op: dict                 # {op: [launches, device s, least s]}
    device_ops: list            # [[name, seconds], ...], longest first
    idle_gaps: list             # [[label, seconds], ...], longest first,
                                # from the host stage


def port_symbols(csrc: Path) -> frozenset:
    """Names of every ``__global__`` function in the port's sources."""
    names = set()
    for path in sorted(Path(csrc).glob("*.cu")):
        names.update(_GLOBAL_RE.findall(path.read_text()))
    return frozenset(names)


def symbol_pattern(symbols) -> re.Pattern:
    """A regex that finds any of ``symbols`` as a whole identifier in a
    demangled kernel name, or as one mangled name's part (its length in
    digits, then the name).  ``match.group(match.lastindex)`` is the
    symbol found."""
    alts = []
    for sym in sorted(symbols, key=len, reverse=True):
        s = re.escape(sym)
        alts.append(rf"(?<![0-9]){len(sym)}({s})")
        alts.append(rf"(?<![A-Za-z0-9_])({s})(?![A-Za-z0-9_])")
    return re.compile("|".join(alts) or "(?!)")


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void `` and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _HostOps:
    """The innermost host op at a time, from the main thread's events
    (which nest)."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.events]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - _LOOKBACK, -1), -1):
            e = self.events[j]
            if e.end > t:
                return e.name
        return None


def clock_offset(cpu, host_span) -> float:
    """The profiler's clock less the host's, in us: the host stage's call
    span as the profiler recorded it against the same call's start on the
    host's clock (0 without a host stage)."""
    starts = [e.start for e in cpu if e.name == CALL_SPAN]
    if not starts or host_span is None:
        return 0.0
    return min(starts) - host_span[0]


def summarize(dev, spans, port_syms, ops, shape, peak, host=None) -> Summary:
    """Reduce a traced run.

    dev : the device stage's device :class:`Event` list;
    spans : that stage's calls, ``(start, end)`` in microseconds on the
            profiler's clock (the host's, moved by :func:`clock_offset`);
    port_syms : the port's kernel names (:func:`port_symbols`);
    ops : ``{op: module}`` with ``SYMBOLS`` and ``cost(n, nsys,
          itemsize)``; shape : ``(n, nsys, itemsize)`` of the cell;
    peak : ``{"bytes_per_s", "flops_per_s"}`` of the card, or None;
    host : ``(cpu, dev)`` event lists of the host stage, whose idle gaps
           are labelled (:func:`idle_gaps`), or None.
    """
    if not spans:
        raise RuntimeError("the profile holds no call")
    w0, w1 = spans[0][0], spans[-1][1]
    total = sum(e.end - e.start for e in dev)
    dev = [e for e in dev if e.end > w0 and e.start < w1]
    inside = sum(min(e.end, w1) - max(e.start, w0) for e in dev)
    if not dev or inside <= 0:
        raise RuntimeError("the profile shows no device time")
    if inside < 0.99 * total:
        raise RuntimeError(
            f"only {inside / total:.1%} of the profile's device time lies "
            f"inside its calls: the profiler's clock is not the host's")
    port_re = symbol_pattern(port_syms)
    op_res = [(name, symbol_pattern(mod.SYMBOLS), mod)
              for name, mod in ops.items()]
    plain = kern = need = took = 0.0
    unmatched = set()
    by_name = defaultdict(float)
    by_op = {}
    costs = {}
    for e in dev:
        dur = e.end - e.start
        by_name[short_name(e.name)] += dur
        m = port_re.search(e.name)
        if m is None:
            plain += dur
            continue
        kern += dur
        op = next((o for o in op_res if o[1].search(e.name)), None)
        if op is None:
            unmatched.add(m.group(m.lastindex))
            continue
        if peak is None:
            continue
        if op[0] not in costs:
            flops, nbytes = op[2].cost(*shape)
            costs[op[0]] = 1e6 * max(nbytes / peak["bytes_per_s"],
                                     flops / peak["flops_per_s"])
        need += costs[op[0]]
        took += dur
        row = by_op.setdefault(op[0], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dur / 1e6
        row[2] += costs[op[0]] / 1e6
    busy = merge((max(e.start, w0), min(e.end, w1)) for e in dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        calls=len(spans), window_s=(w1 - w0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        plain_s=plain / 1e6, kernel_s=kern / 1e6,
        roofline_share=100.0 * need / took if took > 0 else None,
        unmatched=tuple(sorted(unmatched)), by_op=by_op,
        device_ops=[[n, v / 1e6] for n, v in top],
        idle_gaps=[] if host is None else idle_gaps(*host))


def idle_gaps(cpu, dev) -> list:
    """``[[label, seconds], ...]``, the ten largest: the device's idle
    time inside the host stage's call spans (and between them), each gap
    labelled by the innermost host op running at its midpoint, "host
    python" where none runs, or "between calls"."""
    spans = sorted((e for e in cpu if e.name == CALL_SPAN),
                   key=lambda e: e.start)
    if not spans:
        return []
    w0, w1 = spans[0].start, spans[-1].end
    main = spans[0].thread
    dev = [e for e in dev if not e.name.startswith("portbench.")
           and e.end > w0 and e.start < w1]
    busy = merge((e.start, e.end) for e in dev)
    host = _HostOps([e for e in cpu if e.thread == main
                     and e.name != CALL_SPAN])
    span_starts = [x.start for x in spans]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        g0, g1 = max(g0, w0), min(g1, w1)
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        k = bisect.bisect_right(span_starts, mid) - 1
        if k < 0 or spans[k].end <= mid:
            gaps["between calls"] += g1 - g0
            continue
        gaps[host.at(mid) or "host python"] += g1 - g0
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return [[n, v / 1e6] for n, v in top]


def profiler_events(prof):
    """``(cpu, dev)`` :class:`Event` lists of a stopped
    ``torch.profiler.profile``, read from its Kineto events (no
    function-event tree is built)."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        ev = Event(e.name(), start, start + e.duration_ns() / 1e3,
                   e.start_thread_id())
        (dev if e.device_type() == DeviceType.CUDA else cpu).append(ev)
    return cpu, dev
