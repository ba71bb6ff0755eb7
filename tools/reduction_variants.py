#!/usr/bin/env python3
"""Time the one-launch reductions' candidate bodies side by side on one
NVIDIA GPU, float64.

    python3 tools/reduction_variants.py [--parent DIR] [--reps N]

Run from the repository root.  ``--parent DIR`` is an unpacked copy of
an earlier commit of the repository (``git archive``): its
``kernels/csrc/vecops.cu`` is built too, and its two-launch ``dot_f64``
and ``wrms_ss_f64`` are timed beside the rest.

Builds ``tools/reduction_variants.cu`` (candidate bodies, see its note)
into ``build/tools/`` and, for the dot at 2**21 and 3*2**20 elements and
the weighted sums of squares at 3*2**20 (the paths' shapes), times
with CUDA events (median of ``--reps``, a spin kernel before each):

* each candidate, the port's wrapper (``repro_torch.kernels.vecops``),
  its plain version, one library call and the parent's kernels, with the
  L2 emptied before each run in two ways: by writing 256 MB
  (``write``: L2 then holds dirty lines the timed kernel's reads must
  evict) and by reading 256 MB (``read``);
* one restart cycle of GMRES's Arnoldi process at 3*2**20 elements (16
  steps: a matvec, modified Gram-Schmidt with the dot under test, the
  plain ``w - h*V[i]`` that reads V[i] and w again straight after each
  dot, the norm, the scaling), queued behind a spin kernel so that the
  events bracket device time only: the cost or gain of a body's L2
  treatment for the plain kernels around it.

It also launches every candidate (and the wrapper) ``--reps`` times on
aligned inputs and on inputs 8 bytes past a 16-byte boundary, and
counts the results whose bits differ from the wrapper's first: every
candidate sums in the port's order, so the count must be 0.  Prints a
table and the card line, writes ``chip_smoke_out/reduction_variants.json``,
and exits 1 if a bit differed or a launch failed.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chip_smoke_out"
BUILD = ROOT / "build" / "tools"
SPIN_CYCLES = 1_000_000
# (name, body, hint) of tools/reduction_variants.cu
CANDIDATES = (("ring", 0, 0), ("ring_evict_first", 0, 1),
              ("reg", 1, 0), ("reg_cs", 1, 2), ("reg_evict_first", 1, 1))
OPS = {"dot": 0, "wrms_ss": 1, "wrms_mask_ss": 2}
NIN = {"dot": 2, "wrms_ss": 2, "wrms_mask_ss": 3}
N_MESH = 3 << 20
CASES = (("dot", 1 << 21), ("dot", N_MESH), ("wrms_ss", N_MESH),
         ("wrms_mask_ss", N_MESH))
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build(sources: dict) -> dict:
    """{name: .cu path} -> {name: loaded library}, all nvcc at once;
    prints ptxas's registers and shared memory for each."""
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = BUILD / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(ROOT / "src/repro_torch/kernels/csrc"),
               "-I", str(Path(src).parent), "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry and "reduce" in entry:
                print(f"ptxas {name} {entry[:60]}: {line.split(':', 1)[1]}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def time_ms(fn, flush_fn, reps):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush_fn()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("reduction_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import vecops
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 25
    card = card_line()
    print(card, flush=True)
    sources = {"variants": ROOT / "tools" / "reduction_variants.cu"}
    if parent:
        sources["parent_vecops"] = (Path(parent) / "src/repro_torch/kernels"
                                    / "csrc" / "vecops.cu")
    libs = build(sources)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    partial = torch.empty(1024, dtype=torch.float64, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    vlib = libs["variants"]
    vlib.variant_reduce_f64.argtypes = [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p]
    failures = []

    def candidate(body, hint, op):
        def fn(*args):
            out = torch.empty((), dtype=torch.float64, device=dev)
            n = args[0].numel()
            blocks, chunk = vecops.reduction_plan(n, torch.float64)
            ptrs = [a.data_ptr() for a in args] + [None] * (3 - len(args))
            rc = vlib.variant_reduce_f64(body, hint, OPS[op], *ptrs,
                                         partial.data_ptr(),
                                         ticket.data_ptr(), out.data_ptr(),
                                         n, blocks, chunk, stream)
            if rc != 0:
                failures.append(f"{op} body {body} hint {hint}: rc {rc}")
            return out
        return fn

    def parent_fn(op):
        plib = libs["parent_vecops"]
        sym = plib.dot_f64 if op == "dot" else plib.wrms_ss_f64
        sym.argtypes = ([ctypes.c_void_p] * 4 if op == "dot" else
                        [ctypes.c_void_p] * 5) + [ctypes.c_longlong,
                                                   ctypes.c_void_p]

        def fn(*args):
            out = torch.empty((), dtype=torch.float64, device=dev)
            ptrs = [a.data_ptr() for a in args]
            if op == "wrms_ss":
                ptrs.append(None)
            rc = sym(*ptrs, partial.data_ptr(), out.data_ptr(),
                     args[0].numel(), stream)
            if rc != 0:
                failures.append(f"parent {op}: rc {rc}")
            return out
        return fn

    library = {
        "dot": lambda x, y: torch.dot(x, y),
        "wrms_ss": lambda x, w: torch.einsum("i,i,i,i->", x, w, x, w),
        "wrms_mask_ss": None}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flushes = {"write": flush.zero_, "read": lambda: flush.sum()}
    rows, bits = [], []
    for op, n in CASES:
        buf = [torch.randn(n + 2, generator=gen, device=dev,
                           dtype=torch.float64) for _ in range(NIN[op])]
        if op != "dot":
            buf[1] = buf[1].abs() + 0.1
        if op == "wrms_mask_ss":
            buf[2] = (buf[2] > -0.5).to(torch.float64)
        aligned = [b[:n] for b in buf]
        # the same values, 8 bytes past a 16-byte boundary
        shifted = [torch.empty_like(b)[1:n + 1].copy_(a)
                   for b, a in zip(buf, aligned)]
        wrapper = getattr(vecops, op)
        fns = {"wrapper": wrapper}
        fns.update({name: candidate(body, hint, op)
                    for name, body, hint in CANDIDATES})
        if parent and op != "wrms_mask_ss":
            fns["parent"] = parent_fn(op)
        want = wrapper(*aligned)
        # bits: every candidate in the port's order, aligned and at an
        # 8-byte offset, launch after launch
        for name, fn in fns.items():
            if name == "parent":
                continue
            got = [fn(*(aligned if r % 2 == 0 else shifted))
                   for r in range(2 * reps)]
            torch.cuda.synchronize()
            bad = sum(not torch.equal(g, want) for g in got)
            bits.append({"op": op, "n": n, "fn": name,
                         "launches": len(got), "bits_differ": bad})
            if bad:
                failures.append(f"{op} n={n} {name}: {bad} of {len(got)} "
                                f"launches differ in their bits")
        plain = getattr(vecops, op + "_plain")
        bound_ms = NIN[op] * n * 8 / HBM_BYTES_PER_S * 1e3
        row = {"op": op, "n": n, "bound_ms": bound_ms}
        for mode, flush_fn in flushes.items():
            for name, fn in fns.items():
                row[f"{mode}_{name}_ms"] = time_ms(lambda: fn(*aligned),
                                                   flush_fn, reps)
            row[f"{mode}_wrapper_shifted_ms"] = time_ms(
                lambda: wrapper(*shifted), flush_fn, reps)
            row[f"{mode}_plain_ms"] = time_ms(lambda: plain(*aligned),
                                              flush_fn, reps)
            if library[op] is not None:
                row[f"{mode}_library_ms"] = time_ms(
                    lambda: library[op](*aligned), flush_fn, reps)
        rows.append(row)
        print(f"{op} n={n} bound {bound_ms:.5f} ms: " + " ".join(
            f"{k[:-3]}={v:.5f}" for k, v in row.items()
            if k.endswith("_ms") and k != "bound_ms"), flush=True)
        del buf, aligned, shifted

    # GMRES's Arnoldi cycle at the mesh's size, device time
    m = 16
    V = torch.empty((m + 1, N_MESH), dtype=torch.float64, device=dev)
    V[0] = torch.randn(N_MESH, generator=gen, device=dev,
                       dtype=torch.float64)
    V[0] /= torch.linalg.vector_norm(V[0])
    diag = 1.0 + torch.rand(N_MESH, generator=gen, device=dev,
                            dtype=torch.float64)
    dots = {"wrapper": vecops.dot, "library": torch.dot}
    dots.update({name: candidate(body, hint, "dot")
                 for name, body, hint in CANDIDATES})
    if parent:
        dots["parent"] = parent_fn("dot")

    def cycle(dot):
        for j in range(m):
            w = V[j] * diag
            for i in range(j + 1):
                h = dot(V[i], w)
                w = w - h * V[i]
            V[j + 1] = w / torch.sqrt(dot(w, w))

    arnoldi = {}
    for name, dot in dots.items():
        cycle(dot)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            torch.cuda._sleep(40 * SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cycle(dot)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        arnoldi[name] = statistics.median(times)
    ndots = m * (m + 1) // 2 + m
    print(f"Arnoldi cycle (16 steps, {ndots} dots, n = {N_MESH}), device "
          "ms: " + " ".join(f"{k}={v:.4f}" for k, v in arnoldi.items()),
          flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "reduction_variants.json").write_text(json.dumps(
        {"card": card, "reps": reps, "rows": rows, "bits": bits,
         "arnoldi_ms": arnoldi, "arnoldi_dots": ndots,
         "failures": failures}, indent=1))
    for f in failures:
        print("FAILED:", f, flush=True)
    print(card, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
