"""``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell, one JSON line at the end.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones, read from the profile.  The last
lines on standard error, and the line's last key ``checks``, give each
number compared with the reference beside its limit.  The run exits
nonzero and prints no result when no card is visible, when a module of
JAX or of the JAX package is loaded, or when the traced run's profile
holds no device time.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

from . import check, device, manifest, session, trace

#: top-level modules the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.partition(".")[0] in FORBIDDEN})


def _finite(obj):
    """``obj`` with every non-finite float replaced by +-1e308 (a
    failed comparison's infinite error), so the line is strict JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return -1e308 if obj < 0 else 1e308
    return obj


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(man, run, kind) -> dict:
    """Every metric of ``kind`` the cell reports, by its reader; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in man.metrics(run.cell["name"], kind):
        value = man.reader(m["name"]).read(run)
        if value is None:
            print(f"portbench: {m['name']}: nothing to read",
                  file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv, root: Path, t_proc: float) -> int:
    args = parse(argv)
    man = manifest.Manifest(root)
    try:
        cell = man.cell(args.workload)
    except KeyError as e:
        return _fail(str(e))
    try:
        import torch
        device.require(cell["chips"])
    except (ImportError, RuntimeError) as e:
        return _fail(str(e))
    try:
        run = session.run(man, cell["name"], args.seed, args.seconds,
                          bool(args.trace), t_proc)
    except ImportError as e:
        return _fail(f"the program cannot be imported: {e}")
    family = man.family(run.cfg["family"])
    dev = device.describe(run.device, cell["chips"], run.peak_bytes)
    result = {"correct": False, "attempted": run.calls, "failed": 0,
              "metrics": {}, "device": dev}
    if args.trace:
        t0 = time.perf_counter()
        _, devs = trace.profiler_events(run.trace["device"])
        host = trace.profiler_events(run.trace["host"])
        run.trace = None
        rates = device.peak_rates(manifest.peaks(), dev["kind"],
                                  str(run.dtype).rpartition(".")[2])
        shift = trace.clock_offset(host[0], run.host_span)
        spans = [(a + shift, b + shift) for a, b in run.traced_spans]
        try:
            run.trace = trace.summarize(
                devs, spans, trace.port_symbols(
                    root / "src" / "repro_torch" / "kernels" / "csrc"),
                manifest.ops(), (run.n, run.nsys, run.dtype.itemsize),
                rates, host=host)
        except RuntimeError as e:
            return _fail(f"traced run: {e}")
        print(f"portbench: {len(devs)} device events of {run.traced_calls} "
              f"calls and {len(host[0])} host events of one call reduced "
              f"in {time.perf_counter() - t0:.1f} s; the profiler's clock "
              f"is the host's {shift:+.0f} us", file=sys.stderr)
        del devs, host
        for sym in run.trace.unmatched:
            print(f"portbench: port kernel {sym} has no ops/ file: left out "
                  f"of kernel_roofline_share", file=sys.stderr)
        for op, (count, took, least) in sorted(run.trace.by_op.items()):
            print(f"portbench: op {op}: {count} launches, {took:.6f} s on "
                  f"the device, {least:.6f} s at the roofline "
                  f"({100 * least / took:.2f} %)", file=sys.stderr)
        if rates is not None:
            print(f"portbench: roofline peaks {rates['source']}; this card "
                  f"{dev['kind']}, power limit {dev['power_limit']}",
                  file=sys.stderr)
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["metrics"] = read_metrics(
        man, run, "per_layer" if args.trace else "end_to_end")
    torch.cuda.empty_cache()
    values = check.numbers(run, family)
    correct, checks = check.verdict(values, run.limits)
    result["correct"] = correct
    result["failed"] = values["calls_failed"]
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        return _fail(f"modules of JAX or the JAX package are loaded: {bad}")
    print(f"portbench: {cell['name']} seed {args.seed}: {run.calls} calls "
          f"({run.solves} solves) in {run.window_s:.3f} s on {dev['kind']} x{dev['count']}, "
          f"power limit {dev['power_limit']}; reference "
          f"{values['reference_s']:.1f} s", file=sys.stderr)
    print("portbench: set-up: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in run.setup_parts.items()),
        file=sys.stderr)
    print("portbench: call seconds " + " ".join(f"{v:.4f}" for v in
                                                run.call_s), file=sys.stderr)
    print("portbench: a call: " + ", ".join(
        f"{k} {v / max(run.calls, 1):.6g}" for k, v in
        sorted(run.counters.items())), file=sys.stderr)
    for k, v in values.items():
        if k not in checks:
            print(f"reading {k}: {v:.6g}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    print(f"correct: {json.dumps(correct)}", file=sys.stderr, flush=True)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0
