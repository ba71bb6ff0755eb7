"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/repro_torch/``
at the repository root (listed in ``.gitignore``) the first time a
kernel of it is launched.  The file name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  All missing libraries are built together, one ``nvcc`` process
per source.  Nothing here includes PyTorch's headers, so a build takes
seconds.

``-fmad=false`` keeps ``a - b*c`` as a rounded product and a rounded
difference, as PyTorch's separate elementwise ops compute it, so a
kernel and its plain version round alike.  The kernels are bound by
memory traffic (see each source's note), not by their arithmetic.

Every kernel entry point takes device pointers (or a host array of
them), sizes and the stream,
launches on that stream, does not synchronise, and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("newton", "blockdiag_spmv", "block_solve", "sparse", "vecops")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

#: threads of a block of the one-thread-a-system kernels
#: (``REPRO_THREADS`` in csrc/common.cuh)
REPRO_THREADS = 256

#: dtype -> suffix of the exported C symbols
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
_LIBS: dict = {}
_FNS: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
            / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict:
    """Build every library that is missing, all ``nvcc`` runs at once.

    Returns ``{name: seconds}`` for the ones built (empty if none was
    missing).  ``verbose`` adds ``-Xptxas -v`` and prints what the
    compiler says (registers, spills).  Raises if a build fails."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def launch(lib: str, symbol: str, sig: str, *args) -> None:
    """Call ``symbol`` of library ``lib``; ``sig`` spells its argument
    types ('p' pointer or stream, 'i' int, 'l' 64-bit int).  Raises
    with CUDA's message when the launch reports an error."""
    fn = _FNS.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
        _FNS[(lib, symbol)] = fn
    rc = fn(*args)
    if rc != 0:
        err = load(lib).kernel_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{symbol}: CUDA error {rc} "
                           f"({err(rc).decode()})")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as an int for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def on_cpu(op: str, t: torch.Tensor) -> bool:
    """True if ``t`` lies on the CPU, or has no data (a ``meta`` tensor,
    or a fake one whatever device it names: the dry run's), where a
    wrapper runs its plain version; False on the card, where it launches
    its kernel.  Any other device, and a ``DTensor`` on any device,
    raises: no kernel takes a sharded tensor, and its plain version runs
    only when the caller asks for it (``ExecPolicy(backend="torch")``)."""
    if type(t) is not torch.Tensor:
        if _is_dtensor(t):
            raise TypeError(f"{op}: the CUDA kernel takes no DTensor; run "
                            f"DTensors under ExecPolicy(backend='torch')")
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(t):
            return True
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for tensors on {t.device}")
    return False


def check(op: str, device: torch.device, **named) -> None:
    """Raise unless each ``name=(tensor, shape, dtypes)`` is a contiguous
    tensor on ``device`` with that shape and one of ``dtypes``."""
    for nm, (t, shape, dtypes) in named.items():
        if t.device != device:
            raise ValueError(f"{op}: {nm} lies on {t.device}, want {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {nm} has shape {tuple(t.shape)}, "
                             f"want {tuple(shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{op}: {nm} has dtype {t.dtype}, want one of "
                            f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {nm} is not contiguous")
