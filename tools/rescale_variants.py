#!/usr/bin/env python3
"""Time the history rescale's and the per-system WRMS's candidate bodies
side by side on one NVIDIA GPU, alone and in path K's profiled device
time.

    python3 tools/rescale_variants.py [--parent DIR] [--paths K,main]
                                      [--reps N] [--rounds N]

Run from the repository root.  The candidates are the port's
``kernels/csrc/newton.cu`` as it stands (``port``) and copies of it
edited as ``CANDIDATES`` says, some with a section of
``tools/rescale_candidates.cu`` pasted in:

* ``b256``: the n <= 4 rescale in blocks of 256 threads, not 128;
* ``loop_all``: the n > 4 rescale (W in registers, components in
  chunks) at every n, the n <= 4 form dropped;
* ``chunk4``: the n > 4 rescale loading 4 components together, not 2;
* ``block``: the n > 4 rescale as 8 warps over 32 systems, W in shared
  memory;
* ``wrms_rows``: the WRMS at n > 4 as 8 warps over 32 systems (another
  sum order: its path runs are not held to the port's bits);
* ``fma``: the quotients by 3 and 5 of W by an exact fma sequence.

``--parent DIR``, an unpacked copy of an earlier commit (``git
archive``), adds that commit's source (``parent``; it has no fused
entry).  Each is built into ``build/tools/`` with ``-Xptxas -v``
(registers and spills of the rescale and WRMS kernels are printed),
then:

* both rescale entries (W read, ``history_rescale``; W formed from eta
  and q, ``lagrange_rescale``) checked against their plain versions bit
  for bit, and ``wrms_soa`` within ``chip_smoke.TOL``, at n = 3 and 32
  over 130 and 2**16 systems, float64 and float32;
* timed in float64 with CUDA events (median of ``--reps``, a spin
  kernel before each, the L2 emptied before each run by writing 256 MB
  and by reading 256 MB): both entries at n = 3 over 2**20 systems and
  n = 32 over 2**16 with 60 %, none and all of the systems active, and
  ``wrms_soa`` at both shapes, beside the bytes' bound;
* run in the paths of ``chip_smoke.py`` that ``--paths`` names (K,
  the default: ``ensemble_bdf`` with ``BlockDiagGJ()`` on 2**16
  Brusselator systems, n = 32; main: ``ensemble_bdf`` on 2**20
  Robertson systems, n = 3) under ``torch.profiler``, each candidate
  whose change the path runs, its library loaded in place of the
  port's, in turns (forward, then backward, ``--rounds`` times): the
  device time of the rescale and of the whole solve, and whether the
  final state has the port's bits.

Prints a table and the card line, writes
``chip_smoke_out/rescale_variants.json``, exits 1 if a bit differed or a
launch failed.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from variants import build, candidate_sources, time_ms

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/newton.cu"
CANDIDATE_SOURCE = ROOT / "tools/rescale_candidates.cu"


def section(name: str) -> str:
    """The lines of ``CANDIDATE_SOURCE`` after ``//@ name`` up to the
    next ``//@`` line."""
    parts = CANDIDATE_SOURCE.read_text().split("\n//@ ")
    for part in parts[1:]:
        head, _, body = part.partition("\n")
        if head.strip() == name:
            return body
    raise KeyError(name)


def paste(name: str, before: str) -> tuple:
    """An edit that pastes section ``name`` in front of ``before``."""
    return before, section(name) + "\n" + before


LAUNCH = "template <typename T, int Q1, int SRC>\nstatic void launch_rescale"
#: name -> ([(text that occurs once in the port's source, its
#: replacement), ...], the paths that run the change)
CANDIDATES = {
    "port": ([], ("K", "main")),
    "b256": ([("#define SMALL_THREADS 128", "#define SMALL_THREADS 256")],
             ("main",)),
    "loop_all": ([("  if (n <= SMALL_N)\n    history_rescale_kernel",
                   "  if (false)\n    history_rescale_kernel")], ("main",)),
    "chunk4": ([("#define LOOP_CHUNK 2", "#define LOOP_CHUNK 4")], ("K",)),
    "block": ([paste("kernels", LAUNCH),
               ("history_rescale_loop_kernel<T, Q1, SRC><<<system_grid(nb)",
                "history_rescale_block_kernel<T, Q1, SRC><<<block_grid(nb)")],
              ("K",)),
    "wrms_rows": ([paste("kernels", LAUNCH),
                   ("    wrms_soa_kernel<T><<<system_grid(nb), REPRO_THREADS, 0,",
                    "    if (n > SMALL_N) wrms_rows_launch<T>(v, w, out, n, nb, "
                    "stream); else wrms_soa_kernel<T><<<system_grid(nb), "
                    "REPRO_THREADS, 0,")], ("K",)),
    "fma": ([paste("quotient", "// p / d for d = k - i in [-5, 5]"),
             ("    default: return p / T(d);",
              "    default: return fma_quotient(p, d);")], ("K", "main")),
}
#: candidates that sum in another order than the port: their path runs
#: are not held to the port's bits
REORDERED = ("wrms_rows",)
#: (n, nb) timed: the main path's state, and paths B, K, D, E, F's
SHAPES = ((3, 1 << 20), (32, 1 << 16))
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("rescale_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.linsol import BlockDiagGJ
    from repro_torch.kernels import _build, newton

    def arg(flag, default):
        return type(default)(argv[argv.index(flag) + 1]) if flag in argv \
            else default

    parent, reps, rounds = arg("--parent", ""), arg("--reps", 25), \
        arg("--rounds", 1)
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    edits = {name: cand[0] for name, cand in CANDIDATES.items()}
    libs = build(candidate_sources(SOURCE, edits, parent), "newton",
                 lambda entry: "Id" in entry and ("Li6E" in entry
                                                  or "wrms" in entry))
    for lib in libs.values():
        for suf in ("f32", "f64"):
            getattr(lib, "history_rescale_" + suf).argtypes = \
                [P, P, P, P, I, I, L, P]
            getattr(lib, "wrms_soa_" + suf).argtypes = [P, P, P, I, L, P]
            if hasattr(lib, "lagrange_rescale_" + suf):
                getattr(lib, "lagrange_rescale_" + suf).argtypes = \
                    [P, P, P, P, P, I, L, P]
    dev = torch.device("cuda")
    failures = []

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def rescale(name):
        def fn(W, Z, a):
            out = torch.empty_like(Z)
            rc = getattr(libs[name], "history_rescale_"
                         + _build.SUFFIX[Z.dtype])(
                W.data_ptr(), Z.data_ptr(), a.data_ptr(), out.data_ptr(),
                Z.shape[0], Z.shape[1], Z.shape[2], stream())
            if rc != 0:
                failures.append(f"{name} history_rescale: rc {rc}")
            return out
        return fn

    def fused(name):
        def fn(eta, q, Z, a):
            out = torch.empty_like(Z)
            rc = getattr(libs[name], "lagrange_rescale_"
                         + _build.SUFFIX[Z.dtype])(
                eta.data_ptr(), q.data_ptr(), Z.data_ptr(), a.data_ptr(),
                out.data_ptr(), Z.shape[1], Z.shape[2], stream())
            if rc != 0:
                failures.append(f"{name} lagrange_rescale: rc {rc}")
            return out
        return fn

    def wrms(name):
        def fn(v, w):
            out = torch.empty(v.shape[1], dtype=v.dtype, device=v.device)
            rc = getattr(libs[name], "wrms_soa_" + _build.SUFFIX[v.dtype])(
                v.data_ptr(), w.data_ptr(), out.data_ptr(), v.shape[0],
                v.shape[1], stream())
            if rc != 0:
                failures.append(f"{name} wrms_soa: rc {rc}")
            return out
        return fn

    has_fused = {n: hasattr(lib, "lagrange_rescale_f64")
                 for n, lib in libs.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bits = []
    for dtype in (torch.float64, torch.float32):
        for n in (3, 32):
            for nb in (130, 1 << 16):
                d = cs.make_inputs(nb, dtype, gen, dev, b=n)
                want_w = newton.history_rescale_plain(d["W"], d["Z"],
                                                      d["mask"])
                want_f = newton.lagrange_rescale_plain(d["eta"], d["q"],
                                                       d["Z"], d["mask"])
                for name in libs:
                    got = [("history_rescale", rescale(name)(
                        d["W"], d["Z"], d["mask"]), want_w)]
                    if has_fused[name]:
                        got.append(("lagrange_rescale", fused(name)(
                            d["eta"], d["q"], d["Z"], d["mask"]), want_f))
                    for what, g, w in got:
                        same = torch.equal(g, w)
                        bits.append({"fn": name, "entry": what, "n": n,
                                     "nb": nb, "dtype": str(dtype),
                                     "equal": same})
                        if not same:
                            failures.append(f"{name} {what} n={n} nb={nb} "
                                            f"{dtype}: other bits than the "
                                            "plain version")
                    # the WRMS within TOL (a candidate may sum in
                    # another order); its bits are recorded
                    g = wrms(name)(d["z"], d["w"])
                    w = newton.wrms_soa_plain(d["z"], d["w"])
                    err = (g - w).abs().max().item()
                    bits.append({"fn": name, "entry": "wrms_soa", "n": n,
                                 "nb": nb, "dtype": str(dtype),
                                 "equal": torch.equal(g, w),
                                 "max_abs_err": err})
                    if not err <= cs.TOL[str(dtype)] * max(
                            1.0, w.abs().max().item()):
                        failures.append(f"{name} wrms_soa n={n} nb={nb} "
                                        f"{dtype}: off the plain version "
                                        f"by {err:.3g}")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flushes = {"write": flush.zero_, "read": lambda: flush.sum()}
    rows = []
    for n, nb in SHAPES:
        d = cs.make_inputs(nb, torch.float64, gen, dev, b=n)
        Z, W, eta, q = d["Z"], d["W"], d["eta"], d["q"]
        masks = {"60%": d["mask"], "none": torch.zeros_like(d["mask"]),
                 "all": torch.ones_like(d["mask"])}
        for mname, m in masks.items():
            act = int(m.sum())
            # bytes: Z read and written, the mask; W of the active
            # systems (W entry) or eta and q of every system (fused)
            base = cs.nbytes(Z, Z, m)
            bound = {"history_rescale": (base + 36 * 8 * act)
                     / cs.HBM_BYTES_PER_S * 1e3,
                     "lagrange_rescale": cs.nbytes(Z, Z, m, eta, q)
                     / cs.HBM_BYTES_PER_S * 1e3}
            for entry in ("history_rescale", "lagrange_rescale"):
                row = {"entry": entry, "n": n, "nb": nb, "active": mname,
                       "bound_ms": bound[entry]}
                for name in libs:
                    if entry == "lagrange_rescale" and not has_fused[name]:
                        continue
                    fn = (lambda f=rescale(name): f(W, Z, m)) \
                        if entry == "history_rescale" else \
                        (lambda f=fused(name): f(eta, q, Z, m))
                    for mode, flush_fn in flushes.items():
                        row[f"{mode}_{name}_ms"] = time_ms(
                            fn, flush_fn, reps, cs.SPIN_CYCLES)
                rows.append(row)
                print(f"{entry} n={n} nb={nb} active {mname} bound "
                      f"{row['bound_ms']:.4f} ms: " + " ".join(
                          f"{k[:-3]}={v:.4f}" for k, v in row.items()
                          if k.endswith("_ms") and k != "bound_ms"),
                      flush=True)
        v, w = d["z"], d["w"]
        row = {"entry": "wrms_soa", "n": n, "nb": nb, "active": "-",
               "bound_ms": cs.nbytes(v, w) / cs.HBM_BYTES_PER_S * 1e3
               + nb * 8 / cs.HBM_BYTES_PER_S * 1e3}
        for name in libs:
            for mode, flush_fn in flushes.items():
                row[f"{mode}_{name}_ms"] = time_ms(
                    lambda f=wrms(name): f(v, w), flush_fn, reps,
                    cs.SPIN_CYCLES)
        rows.append(row)
        print(f"wrms_soa n={n} nb={nb} bound {row['bound_ms']:.4f} ms: "
              + " ".join(f"{k[:-3]}={v:.4f}" for k, v in row.items()
                         if k.endswith("_ms") and k != "bound_ms"),
              flush=True)
        del d, Z, W, eta, q, masks, v, w
    del flush

    # the paths, each candidate's library in place of the port's
    def path_call(path):
        if path == "main":
            prob = cs.robertson_problem(
                cs.NSYS, problems.robertson_rates(cs.NSYS, seed=0))
            return cs.integrate_call(prob, "ensemble_bdf", 10.0, ODEOptions(
                rtol=cs.RTOL, atol=cs.ATOL, max_steps=100_000))
        f, jac, _, y0 = problems.ensemble_brusselator(cs.NBRUSS, nx=cs.NX)
        f_soa, jac_soa = problems.ensemble_brusselator_soa(cs.NBRUSS,
                                                           nx=cs.NX)
        prob = ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa)
        return cs.integrate_call(prob, "ensemble_bdf", 2.0, ODEOptions(
            rtol=cs.RTOL, atol=cs.ATOL, max_steps=100_000),
            {"lin_solver": BlockDiagGJ()})

    def load(name):
        _build._LIBS["newton"] = libs[name]
        for key in [k for k in _build._FNS if k[0] == "newton"]:
            del _build._FNS[key]

    path_rows = []
    for path in arg("--paths", "K").split(","):
        solve = path_call(path)
        held = {}

        def run():
            held["y"] = solve().y

        load("port")
        run()
        torch.cuda.synchronize()
        first = held.pop("y")
        order = [name for name in libs
                 if has_fused[name] and path in CANDIDATES.get(
                     name, ((), ()))[1]]
        for name in (order + order[::-1]) * rounds:
            load(name)
            prof = cs.profile_run(f"{path} [{name}]", run, float("nan"), True)
            top = prof["top_ms"].items()
            rescale_ms = sum(ms for sym, ms in top if "rescale" in sym)
            same = torch.equal(held.pop("y"), first)
            path_rows.append({"path": path, "fn": name,
                              "device_busy_s": prof["device_busy_s"],
                              "rescale_ms": rescale_ms,
                              "wall_s": prof["wall_s"],
                              "y_bits_as_port": same})
            print(f"{path} [{name}]: device busy "
                  f"{prof['device_busy_s']:.4f} s, rescale {rescale_ms:.3f} "
                  f"ms, y bits as the port's: {same}",
                  flush=True)
            if not same and name not in REORDERED:
                failures.append(f"{path} [{name}]: other final bits")
        del solve, first
    _build._LIBS.pop("newton")
    _build._FNS.clear()
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "rescale_variants.json").write_text(json.dumps(
        {"card": card, "reps": reps, "rows": rows, "bits": bits,
         "paths": path_rows, "failures": failures}, indent=1))
    for msg in failures:
        print("FAILED:", msg, flush=True)
    print(card, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
