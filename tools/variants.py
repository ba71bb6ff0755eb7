"""Helpers of the kernel-candidate tools ``tools/spmv_variants.py``,
``tools/rescale_variants.py`` and ``tools/newton_fused_variants.py``:
candidate sources made by text edits of a port source, their build (all
``nvcc`` at once, with the compiler's register report), and the
CUDA-event time of one call."""
from __future__ import annotations

import ctypes
import statistics
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "tools"


def candidate_sources(source: Path, candidates: dict, parent: str) -> dict:
    """Write each candidate's source beside the build: ``{name: (path,
    include dir)}``.  ``candidates``: name -> [(text that occurs once in
    ``source``, its replacement), ...], [] for the source as it stands;
    ``parent``, an unpacked copy of an earlier commit (or ""), adds its
    source of the same name as ``parent``."""
    text = source.read_text()
    out = {}
    for name, changes in candidates.items():
        if not changes:
            out[name] = (source, source.parent)
            continue
        cand = text
        for old, new in changes:
            if cand.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} does not occur once in "
                                   f"{source.name}")
            cand = cand.replace(old, new)
        BUILD.mkdir(parents=True, exist_ok=True)
        path = BUILD / f"{source.stem}_{name}.cu"
        path.write_text(cand)
        out[name] = (path, source.parent)
    if parent:
        csrc = Path(parent) / "src/repro_torch/kernels/csrc"
        out["parent"] = (csrc / source.name, csrc)
    return out


def build(sources: dict, stem: str, shown) -> dict:
    """``{name: (.cu path, include dir)}`` -> ``{name: loaded library}``
    (``build/tools/lib<stem>_<name>.so``), all ``nvcc`` at once; prints
    ptxas's registers and spills of each entry function whose mangled
    name ``shown(name)`` accepts."""
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, inc) in sources.items():
        out = BUILD / f"lib{stem}_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(inc), "-o", str(out), str(src)]
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
            elif ("Used" in line or "spill" in line) and entry \
                    and shown(entry):
                print(f"ptxas {name} {entry[:56]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def time_ms(fn, flush_fn, reps, spin):
    """Median device time of one call of ``fn`` over ``reps`` runs, CUDA
    events, ``flush_fn()`` (emptying the L2) and a spin kernel of
    ``spin`` cycles before each, after three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush_fn()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
