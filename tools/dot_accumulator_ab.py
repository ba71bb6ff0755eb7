#!/usr/bin/env python3
"""Row 16 (``vecops.dot``) on float32 inputs, this tree's kernel against
an earlier commit's, on one NVIDIA GPU.

    python3 tools/dot_accumulator_ab.py --parent DIR [--reps N]

Run from the repository root.  ``DIR`` is an unpacked copy of the
earlier commit (``git archive``); its ``kernels/csrc/vecops.cu`` is
built into ``build/tools/`` and its ``dot_f32`` launched over the same
plan as this tree's wrapper.  For <x, x> over float32 vectors of
2**21, 3*2**20, 47 382 528 (path R.3's embedding shard) and 189 530 112
(path Q.1's embedding gradient) elements (standard normal, seed 0):
each kernel's time (CUDA events, median of ``--reps``, a 256 MB write
before each run and a spin kernel, parent, change, change, parent), the
plain version's and ``torch.dot``'s, and each result's relative error
against a float64 dot of the same values.  Prints a table and the card
line, writes ``chip_smoke_out/dot_accumulator_ab.json``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from reduction_variants import ROOT, SPIN_CYCLES, build, card_line  # noqa: E402

SIZES = (1 << 21, 3 << 20, 47_382_528, 189_530_112)
HBM_BYTES_PER_S = 3.35e12


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("dot_accumulator_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, vecops
    parent = Path(argv[argv.index("--parent") + 1])
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 25
    card = card_line()
    print(card, flush=True)
    plib = build({"parent_vecops": parent / "src/repro_torch/kernels/csrc"
                  / "vecops.cu"})["parent_vecops"]
    sym = plib.dot_f32
    sym.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p]
    dev = torch.device("cuda")
    stream = _build.stream(dev)
    p_partial = torch.empty(vecops.RED_MAX_BLOCKS, dtype=torch.float32,
                            device=dev)
    p_ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def parent_dot(x):
        out = torch.empty((), dtype=torch.float32, device=dev)
        blocks, chunk = vecops.reduction_plan(x.numel(), torch.float32)
        rc = sym(x.data_ptr(), x.data_ptr(), p_partial.data_ptr(),
                 p_ticket.data_ptr(), out.data_ptr(), x.numel(), blocks,
                 chunk, stream)
        if rc != 0:
            raise RuntimeError(f"parent dot_f32: rc {rc}")
        return out

    def timed(fn):
        scratch.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    rows = []
    for n in SIZES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x = torch.randn(n, generator=gen, device=dev)
        d = x.double()
        exact = float(torch.dot(d, d))
        del d
        fns = {"parent": lambda: parent_dot(x),
               "change": lambda: vecops.dot(x, x),
               "plain": lambda: vecops.dot_plain(x, x),
               "library": lambda: torch.dot(x, x)}
        errs = {k: abs(float(f()) - exact) / exact for k, f in fns.items()}
        events = {k: [] for k in fns}
        for _ in range(reps):
            for k in ("parent", "change", "change", "parent", "plain",
                      "library"):
                events[k].append(timed(fns[k]))
        torch.cuda.synchronize()
        ms = {k: statistics.median(s.elapsed_time(e) for s, e in v)
              for k, v in events.items()}
        row = {"n": n, "ms": ms, "rel_err_vs_float64": errs,
               "bound_ms": 1e3 * 4 * n / HBM_BYTES_PER_S}
        rows.append(row)
        print(f"n={n}: ms " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        ms.items())
              + f" (bound {row['bound_ms']:.4f}); rel error against float64 "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()),
              flush=True)
        del x
    out = ROOT / "chip_smoke_out"
    out.mkdir(exist_ok=True)
    (out / "dot_accumulator_ab.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
