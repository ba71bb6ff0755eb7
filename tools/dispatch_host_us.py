#!/usr/bin/env python3
"""Host microseconds a dispatched op call costs under each backend.

    PYTHONPATH=src python3 tools/dispatch_host_us.py [--calls N] [--rounds R]

Times ``dispatch.newton_residual_soa`` (the main path's most frequent
op) on (3, 1024) float64 tensors, ``--calls`` calls a round, the median
of ``--rounds`` rounds: on the CPU under ``"torch"`` and ``"auto"``
(whose memo hit then runs the kernel wrapper's plain version), and, on
a card, under ``"cuda"`` and ``"auto"`` (both launch the same kernel; a
round ends in a synchronize).  The difference of ``"auto"`` and its
counterpart is the host cost of resolving a call: its key and one
dictionary read.  Prints one line a device and writes
``chip_smoke_out/dispatch_host_us.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def per_call_us(call, sync, calls: int, rounds: int) -> float:
    for _ in range(100):
        call()
    sync()
    out = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(calls):
            call()
        sync()
        out.append((time.perf_counter() - t) / calls * 1e6)
    return statistics.median(out)


def main(argv=None) -> int:
    import torch
    from repro_torch.core import autotune
    from repro_torch.core import dispatch as dv
    from repro_torch.core.policies import ExecPolicy
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    rec = {}
    for dev in devices:
        z = torch.rand(3, 1024, dtype=torch.float64, device=dev)
        g = torch.rand(1024, dtype=torch.float64, device=dev)
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        base = "cuda" if dev == "cuda" else "torch"
        autotune.reset_resolver()
        times = {}
        for backend in (base, "auto", base, "auto"):
            pol = ExecPolicy(backend=backend)
            t = per_call_us(lambda: dv.newton_residual_soa(
                z, z, z, g, pol, negate=True), sync, args.calls, args.rounds)
            times.setdefault(backend, []).append(t)
        name = torch.cuda.get_device_name(0) if dev == "cuda" else "CPU"
        rec[dev] = {"device": name, "us_per_call": times}
        print(f"{name}: newton_residual_soa, us a call: {base} "
              f"{times[base]}, auto {times['auto']}", flush=True)
    out = ROOT / "chip_smoke_out"
    out.mkdir(exist_ok=True)
    (out / "dispatch_host_us.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
