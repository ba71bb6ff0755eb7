#!/usr/bin/env python3
"""Time the block-diagonal SpMV's candidate bodies side by side on one
NVIDIA GPU, alone and in path K's profiled device time.

    python3 tools/spmv_variants.py [--parent DIR] [--reps N] [--rounds N]

Run from the repository root.  The candidates are the port's
``kernels/csrc/blockdiag_spmv.cu`` as it stands (``port``) and copies of
it with one line changed (``CANDIDATES``): streaming loads of A
(``__ldcs``), and chunks of 4 columns instead of 8.  ``--parent DIR``,
an unpacked copy of an earlier commit (``git archive``), adds that
commit's source (``parent``).  Each is built into ``build/tools/`` with
``-Xptxas -v`` (registers and spills of the row form are printed), then:

* checked against the plain version bit for bit at b = 9, 16, 24, 32
  over 130 and 2**16 systems, float64 and float32;
* timed in float64 at b = 16, 24, 32 over 2**16 systems with CUDA events
  (median of ``--reps``, a spin kernel before each), the L2 emptied
  before each run by writing 256 MB and by reading 256 MB, beside the
  plain version and ``einsum``;
* run in path K of ``chip_smoke.py`` (``ensemble_bdf`` with
  ``BlockDiagGJ()`` on 2**16 Brusselator systems, row 2 at b = 32 once
  a Newton iteration) under ``torch.profiler``, its library loaded in
  place of the port's, in turns (the candidates forward, then backward,
  ``--rounds`` times): the device time of the SpMV and of the whole
  solve, and whether the final state has the first run's bits.

Prints a table and the card line, writes
``chip_smoke_out/spmv_variants.json``, exits 1 if a bit differed or a
launch failed.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from variants import build, candidate_sources, time_ms

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/blockdiag_spmv.cu"
#: name -> [(text that occurs once in the port's source, its
#: replacement)]
CANDIDATES = {"port": [],
              "ldcs": [("__ldg(", "__ldcs(")],
              "chunk4": [("#define SPMV_CHUNK 8", "#define SPMV_CHUNK 4")]}
NB = 1 << 16
TIMED_B = (32, 24, 16)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("spmv_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.linsol import BlockDiagGJ
    from repro_torch.kernels import _build, blockdiag_spmv

    def arg(flag, default):
        return type(default)(argv[argv.index(flag) + 1]) if flag in argv \
            else default

    parent, reps, rounds = arg("--parent", ""), arg("--reps", 25), \
        arg("--rounds", 1)
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    libs = build(candidate_sources(SOURCE, CANDIDATES, parent), "spmv",
                 lambda entry: "spmv" in entry)
    for lib in libs.values():
        for sym in (lib.blockdiag_spmv_f32, lib.blockdiag_spmv_f64):
            sym.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                    ctypes.c_longlong,
                                                    ctypes.c_void_p]
    dev = torch.device("cuda")
    failures = []

    def call(name):
        def fn(A, x):
            y = torch.empty_like(x)
            sym = getattr(libs[name], "blockdiag_spmv_"
                          + _build.SUFFIX[A.dtype])
            rc = sym(A.data_ptr(), x.data_ptr(), y.data_ptr(), A.shape[0],
                     A.shape[2], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                failures.append(f"{name} b={A.shape[0]}: rc {rc}")
            return y
        return fn

    fns = {name: call(name) for name in libs}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bits = []
    for dtype in (torch.float64, torch.float32):
        for b in (9, 16, 24, 32):
            for nb in (130, NB):
                d = cs.make_inputs(nb, dtype, gen, dev, b=b)
                want = blockdiag_spmv.blockdiag_spmv_soa_plain(d["A"], d["r"])
                for name, fn in fns.items():
                    same = torch.equal(fn(d["A"], d["r"]), want)
                    bits.append({"fn": name, "b": b, "nb": nb,
                                 "dtype": str(dtype), "equal": same})
                    if not same:
                        failures.append(f"{name} b={b} nb={nb} {dtype}: "
                                        "other bits than the plain version")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flushes = {"write": flush.zero_, "read": lambda: flush.sum()}
    rows = []
    for b in TIMED_B:
        d = cs.make_inputs(NB, torch.float64, gen, dev, b=b)
        A, x = d["A"], d["r"]
        timed = dict(fns, plain=blockdiag_spmv.blockdiag_spmv_soa_plain,
                     einsum=lambda A, x: torch.einsum("ijs,js->is", A, x))
        row = {"b": b, "nb": NB, "bound_ms": cs.nbytes(A, x, x)
               / cs.HBM_BYTES_PER_S * 1e3}
        for mode, flush_fn in flushes.items():
            for name, fn in timed.items():
                row[f"{mode}_{name}_ms"] = time_ms(
                    lambda: fn(A, x), flush_fn, reps, cs.SPIN_CYCLES)
        rows.append(row)
        print(f"b={b} nb={NB} bound {row['bound_ms']:.4f} ms: " + " ".join(
            f"{k[:-3]}={v:.4f}" for k, v in row.items()
            if k.endswith("_ms") and k != "bound_ms"), flush=True)
        del d, A, x
    del flush

    # path K, each candidate's library in place of the port's
    f, jac, _, y0 = problems.ensemble_brusselator(cs.NBRUSS, nx=cs.NX)
    f_soa, jac_soa = problems.ensemble_brusselator_soa(cs.NBRUSS, nx=cs.NX)
    prob = ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa)
    opts = ODEOptions(rtol=cs.RTOL, atol=cs.ATOL, max_steps=100_000)
    solve = cs.integrate_call(prob, "ensemble_bdf", 2.0, opts,
                              {"lin_solver": BlockDiagGJ()})
    held = {}

    def run():
        held["y"] = solve().y

    run()
    torch.cuda.synchronize()
    first = held.pop("y")
    order = list(libs)
    path = []
    for name in (order + order[::-1]) * rounds:
        _build._LIBS["blockdiag_spmv"] = libs[name]
        for key in [k for k in _build._FNS if k[0] == "blockdiag_spmv"]:
            del _build._FNS[key]
        prof = cs.profile_run(f"K [{name}]", run, float("nan"))
        spmv_ms = sum(ms for sym, ms in prof["top_ms"].items()
                      if "spmv_" in sym)
        same = torch.equal(held.pop("y"), first)
        path.append({"fn": name, "device_busy_s": prof["device_busy_s"],
                     "spmv_ms": spmv_ms, "wall_s": prof["wall_s"],
                     "y_bits_as_first_run": same})
        print(f"K [{name}]: device busy {prof['device_busy_s']:.4f} s, "
              f"SpMV {spmv_ms:.3f} ms, y bits as the first run: {same}",
              flush=True)
    _build._LIBS.pop("blockdiag_spmv")
    _build._FNS.clear()
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "spmv_variants.json").write_text(json.dumps(
        {"card": card, "reps": reps, "rows": rows, "bits": bits,
         "path_k": path, "failures": failures}, indent=1))
    for msg in failures:
        print("FAILED:", msg, flush=True)
    print(card, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
