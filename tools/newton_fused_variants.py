#!/usr/bin/env python3
"""Time launch shapes of the fused Newton iteration (``newton_update``,
row 1+2+3f) and the fused lsetup (``newton_block_inverse``, row 6f) side
by side on one NVIDIA GPU.

    python3 tools/newton_fused_variants.py [--reps N]

Run from the repository root.  The candidates are the port's
``kernels/csrc/newton.cu`` and ``block_solve.cu`` as they stand
(``port``: the iteration a group of 8 lanes a system over at most
``GROUP_MAX_NB`` systems and one thread a system over more, in blocks of
256; the lsetup one thread a system in blocks of 64) and copies of one of them edited as
``CANDIDATES`` says:

* ``update_thread``: the iteration one thread a system at every nb,
  blocks of 256 (the shape of the kernels it replaces);
* ``update_group``: the iteration a group of 8 lanes a system at every
  nb, blocks of 256;
* ``update_thread64``, ``update_group64``: the same in blocks of 64;
* ``inverse_256``: the lsetup in blocks of 256.

Each is built into ``build/tools/`` with ``-Xptxas -v`` (registers and
spills of the float64 b = 3, 6 and 8 entries printed), checked in
float64 at b = 1..8 over 130 and 16384 systems (z' and the inverse bit
for bit the plain versions', the norm bit for bit the port's), then
timed in float64 with CUDA events (median of ``--reps``, the L2 emptied
and a spin kernel before each run), beside the bytes' bound: the
iteration at b = 1..8 over 2**12 to 2**20 systems (the main path's
b = 3 over 2**20, path M's bundles of 4096 to 65536 at b = 3 and 6),
the lsetup at b = 3 over 2**20 and b = 3, 6, 8 over 16384.  Prints a
table and the card line, writes
``chip_smoke_out/newton_fused_variants.json``, exits 1 if a bit differed
or a launch failed.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from variants import build, candidate_sources, time_ms

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
#: the iteration's forms forced at every nb: one thread a system, groups
THREAD_FORM = ("const bool grouped = nb <= GROUP_MAX_NB;",
               "const bool grouped = false;")
GROUP_FORM = ("const bool grouped = nb <= GROUP_MAX_NB;",
              "const bool grouped = true;")
UPDATE_GRID = "const dim3 g = GROUPED ? group_grid(nb) : system_grid(nb);"
UPDATE_LAUNCH = "newton_update_kernel<T, B, GROUPED><<<g, REPRO_THREADS"


def update_launch(grid: str, threads: str) -> list:
    """Edits of the iteration's launch: the grid ``grid``, ``threads`` a
    block."""
    return [(UPDATE_GRID, f"const dim3 g = {grid};"),
            (UPDATE_LAUNCH,
             f"newton_update_kernel<T, B, GROUPED><<<g, {threads}")]


#: name -> (the source it edits, [(text that occurs once in it, its
#: replacement), ...])
CANDIDATES = {
    "update_thread": ("newton", [THREAD_FORM]),
    "update_group": ("newton", [GROUP_FORM]),
    "update_thread64": ("newton", [THREAD_FORM] + update_launch(
        "dim3((unsigned)((nb + 63) / 64))", "64")),
    "update_group64": ("newton", [GROUP_FORM] + update_launch(
        "dim3((unsigned)((nb * GROUP_LANES + 63) / 64))", "64")),
    "inverse_256": ("block_solve", [("#define INVERSE_THREADS 64",
                                     "#define INVERSE_THREADS 256")]),
}
#: (b, nb) at which the iteration is timed: every b over 2**12 to 2**20
#: systems (where its two forms cross)
UPDATE_SHAPES = tuple((b, 1 << e) for b in range(1, 9)
                      for e in (12, 14, 15, 16, 17, 18, 20))
#: (b, nb) at which the lsetup is timed: the main path's and path M's
INVERSE_SHAPES = ((3, 1 << 20), (3, 1 << 14), (6, 1 << 14), (8, 1 << 14))
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("newton_fused_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, block_solve, newton

    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 25
    card = cs.card_line()
    print(card, flush=True)

    def shown(entry):
        return "Id" in entry and ("newton_update" in entry or
                                  "newton_block_inverse" in entry) and \
            any(f"Li{b}E" in entry for b in (3, 6, 8))

    libs = {}
    for src in ("newton", "block_solve"):
        edits = {"port": []}
        edits.update({name: changes for name, (where, changes)
                      in CANDIDATES.items() if where == src})
        libs[src] = build(candidate_sources(CSRC / f"{src}.cu", edits, ""),
                          f"fused_{src}", shown)
    for suf in ("f32", "f64"):
        for lib in libs["newton"].values():
            getattr(lib, "newton_update_" + suf).argtypes = \
                [P] * 10 + [I, L, P]
        for lib in libs["block_solve"].values():
            getattr(lib, "newton_block_inverse_" + suf).argtypes = \
                [P, P, P, I, L, P]
    dev = torch.device("cuda")
    failures = []

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def update(name):
        def fn(z, f, psi, gam, gamrat, Minv, w, mask):
            b, nb = z.shape
            z_new = torch.empty_like(z)
            dn = torch.empty(nb, dtype=z.dtype, device=z.device)
            rc = getattr(libs["newton"][name], "newton_update_"
                         + _build.SUFFIX[z.dtype])(
                *(t.data_ptr() for t in (z, f, psi, gam, gamrat, Minv, w,
                                         mask, z_new, dn)), b, nb, stream())
            if rc != 0:
                failures.append(f"{name} newton_update: rc {rc}")
            return z_new, dn
        return fn

    def inverse(name):
        def fn(J, gam):
            X = torch.empty_like(J)
            rc = getattr(libs["block_solve"][name], "newton_block_inverse_"
                         + _build.SUFFIX[J.dtype])(
                J.data_ptr(), gam.data_ptr(), X.data_ptr(), J.shape[0],
                J.shape[2], stream())
            if rc != 0:
                failures.append(f"{name} newton_block_inverse: rc {rc}")
            return X
        return fn

    def args_of(d):
        return (d["z"], d["f"], d["psi"], d["gam"], d["gamrat"], d["A"],
                d["w"], d["mask"])

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bits = []
    for b in range(1, 9):
        for nb in (130, 1 << 14):
            d = cs.make_inputs(nb, torch.float64, gen, dev, b=b)
            want_z = newton.newton_update_plain(*args_of(d))[0]
            dn_port = update("port")(*args_of(d))[1]
            want_inv = block_solve.newton_block_inverse_soa_plain(d["J"],
                                                                  d["gam"])
            for name in libs["newton"]:
                z_new, dn = update(name)(*args_of(d))
                if not (torch.equal(z_new, want_z) and
                        torch.equal(dn, dn_port)):
                    bits.append(f"{name} b={b} nb={nb}")
            for name in libs["block_solve"]:
                if not torch.equal(inverse(name)(d["J"], d["gam"]), want_inv):
                    bits.append(f"{name} b={b} nb={nb}")
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows = []
    for b, nb in sorted(set(UPDATE_SHAPES) | set(INVERSE_SHAPES)):
        d = cs.make_inputs(nb, torch.float64, gen, dev, b=b)
        args = args_of(d)
        runs = [(name, "newton_update", lambda n=name: update(n)(*args))
                for name in libs["newton"] if (b, nb) in UPDATE_SHAPES] + \
            [(name, "newton_block_inverse",
              lambda n=name: inverse(n)(d["J"], d["gam"]))
             for name in libs["block_solve"] if (b, nb) in INVERSE_SHAPES]
        moved = {"newton_update": cs.nbytes(*args, *update("port")(*args)),
                 "newton_block_inverse": cs.nbytes(d["J"], d["gam"], d["J"])}
        for name, kernel, fn in runs:
            ms = time_ms(fn, flush.zero_, reps, cs.SPIN_CYCLES)
            bound = moved[kernel] / cs.HBM_BYTES_PER_S * 1e3
            rows.append({"candidate": name, "kernel": kernel, "b": b,
                         "nb": nb, "ms": ms, "bound_ms": bound})
            print(f"  {kernel:21s} {name:16s} b={b} nb={nb:<8d} {ms:.4f} ms"
                  f"  bound {bound:.4f} ms", flush=True)
    out = ROOT / "chip_smoke_out"
    out.mkdir(exist_ok=True)
    (out / "newton_fused_variants.json").write_text(json.dumps(
        {"card": card, "rows": rows, "bits_differ": bits,
         "failures": failures}, indent=1))
    for msg in bits:
        print(f"bits differ: {msg}", flush=True)
    for msg in failures:
        print(f"launch failed: {msg}", flush=True)
    print(card, flush=True)
    return 1 if bits or failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
