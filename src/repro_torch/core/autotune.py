"""Persisted autotune cache, the ``"auto"`` resolver, and the tuner.

Counterpart of ``repro.core.autotune`` (and of the tuning half of the
reference's ``benchmarks/autotune_bench.py``).  The resolver decides
each signature (:class:`~repro_torch.analysis.opcost.OpSig`) of a
card's row in this order:

1. a per-op pin, recorded with source ``"override"`` when passed to
   :meth:`Resolver.decide`;
2. an exact entry of the card's autotune cache: the measured winner;
3. the nearest entry (same op, dtype, b, k and nnz; the long axis
   within :data:`NEAREST_MAX_FACTOR`): batch size extrapolates, block
   structure does not;
4. the analytical model (:func:`~repro_torch.analysis.opcost.predict`),
   which is evaluated for every decision anyway, so each records whether
   model and measurement agree.

``"auto"`` dispatch records a decision for every call
(:func:`resolve_call`) but does not follow it: on CUDA tensors it runs
the kernel wrapper whatever the resolver picked, and on CPU tensors the
kernel wrapper's plain version (decisions under the pseudo-device
``"cpu"``, source ``"cpu"``).  A decision that picks ``"torch"`` on the
card is advice, which a user follows by pinning the op
(``ExecPolicy().override(op="torch")``), the only way to the plain
version on the card under ``"auto"``.  A card with no roofline row
records its decisions under the pseudo-device ``"no-row"`` (source
``"no-row"``) and runs its kernels all the same.

The cache of a roofline row ``<row>`` is ``<dir>/<row>.json``, ``<dir>``
being ``$REPRO_TORCH_AUTOTUNE_DIR`` or ``<repo>/.autotune_torch``; the
reference's ``.autotune/`` is never read or written.  Files carry a
schema version and their row's name: a file of another schema or row is
dropped whole, an entry whose key disagrees with its signature is
dropped alone, both silently (a cold cache, never an error).

:func:`tune` times both implementations of every op over
:func:`tune_grid` (or the signatures a caller passes) on the card (CUDA
events, median after an L2 flush, as ``chip_smoke.py`` phase 3 times its
kernels) and writes the cache::

    python -m repro_torch.core.autotune --tune [--out DIR] [--reps N]

:func:`args_for` builds an op's inputs from a signature, so the tuner's
keys and the keys ``"auto"`` dispatch looks up agree by construction
(sunlint's ``kernel-contract`` rule checks it over its grid).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..analysis import opcost
from ..analysis.opcost import OpSig
from ..analysis.roofline import device_for, get_device

#: bump when the key derivation or the entry layout changes; a file of
#: another version is dropped whole
SCHEMA_VERSION = 1

#: nearest-entry fallback range along the long axis
NEAREST_MAX_FACTOR = 8.0

#: the pseudo-device of calls on CPU tensors (no roofline row, no cache)
CPU = "cpu"

#: the pseudo-device of calls on a card with no roofline row (no cache)
NO_ROW = "no-row"

#: the resolvers that stand for no row of the table
PSEUDO_DEVICES = (CPU, NO_ROW)

#: backends of a decision
BACKENDS = ("torch", "cuda")


def default_cache_dir() -> Path:
    """``$REPRO_TORCH_AUTOTUNE_DIR`` or ``<repo>/.autotune_torch``."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / ".autotune_torch"


@dataclasses.dataclass
class Entry:
    """One measured (op, signature) record: device seconds a call."""

    sig: OpSig
    t_torch: float
    t_cuda: float

    @property
    def winner(self) -> str:
        return "torch" if self.t_torch <= self.t_cuda else "cuda"

    @property
    def ratio(self) -> float:
        """Measured torch/cuda time ratio (> 1: the kernel wins)."""
        return self.t_torch / max(self.t_cuda, 1e-12)

    def to_json(self) -> dict:
        return {"sig": dataclasses.asdict(self.sig), "t_torch": self.t_torch,
                "t_cuda": self.t_cuda, "winner": self.winner}

    @classmethod
    def from_json(cls, d: dict) -> "Entry":
        return cls(sig=OpSig(**d["sig"]), t_torch=float(d["t_torch"]),
                   t_cuda=float(d["t_cuda"]))


class AutotuneCache:
    """Schema-versioned, per-row persisted measurements."""

    def __init__(self, device: str, path: Optional[Path] = None):
        self.device = device
        self.path = Path(path) if path is not None else \
            default_cache_dir() / f"{device}.json"
        self.entries: Dict[str, Entry] = {}
        self.stale = False        # a file existed but was (partly) dropped

    def load(self) -> "AutotuneCache":
        """Read the file; a schema or row mismatch drops it, a corrupt or
        mis-keyed entry drops that entry: silently, a cold cache."""
        self.entries = {}
        try:
            payload = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return self
        if payload.get("schema") != SCHEMA_VERSION or \
                payload.get("device") != self.device:
            self.stale = True
            return self
        for key, raw in payload.get("entries", {}).items():
            try:
                entry = Entry.from_json(raw)
            except (KeyError, TypeError, ValueError):
                self.stale = True
                continue
            if entry.sig.key() != key:
                self.stale = True
                continue
            self.entries[key] = entry
        return self

    def save(self) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"schema": SCHEMA_VERSION, "device": self.device,
                   "note": ("median device seconds of one call of each "
                            "implementation; regenerate with: "
                            "PYTHONPATH=src python -m "
                            "repro_torch.core.autotune --tune"),
                   "entries": {k: e.to_json()
                               for k, e in sorted(self.entries.items())}}
        self.path.write_text(json.dumps(payload, indent=2) + "\n")
        return self.path

    def put(self, entry: Entry) -> None:
        self.entries[entry.sig.key()] = entry

    def get(self, sig: OpSig) -> Optional[Entry]:
        return self.entries.get(sig.key())

    def nearest(self, sig: OpSig) -> Optional[Entry]:
        """The entry with sig's op, dtype, b, k and nnz closest along the
        long axis in log distance, within :data:`NEAREST_MAX_FACTOR`."""
        best, best_d = None, math.inf
        for e in self.entries.values():
            es = e.sig
            if (es.op, es.dtype, es.b, es.k, es.nnz) != \
                    (sig.op, sig.dtype, sig.b, sig.k, sig.nnz):
                continue
            a, c = max(1, es.axis_len), max(1, sig.axis_len)
            d = abs(math.log(a / c))
            if d < best_d:
                best, best_d = e, d
        if best is not None and best_d <= math.log(NEAREST_MAX_FACTOR):
            return best
        return None


@dataclasses.dataclass
class Decision:
    """One resolved signature; ``hits`` counts the calls it served."""

    sig: OpSig
    backend: str
    source: str       # 'override' | 'cache' | 'near' | 'model' | 'cpu'
    #                   | 'no-row'
    model_winner: Optional[str]      # None: no row to model
    cached_winner: Optional[str] = None
    hits: int = 1

    @property
    def agree(self) -> Optional[bool]:
        """Model against measurement (None without a measurement)."""
        if self.cached_winner is None:
            return None
        return self.model_winner == self.cached_winner

    def to_dict(self) -> dict:
        return {"op": self.sig.op, "sig": self.sig.key(),
                "backend": self.backend, "source": self.source,
                "model_winner": self.model_winner,
                "cached_winner": self.cached_winner, "agree": self.agree,
                "hits": self.hits}


class Resolver:
    """The decisions of ``"auto"`` dispatch for one roofline row, or for
    a pseudo-device: ``"cpu"``, whose decisions all take the plain
    version, and ``"no-row"``, whose decisions all take the kernel."""

    def __init__(self, device: str, cache: Optional[AutotuneCache] = None):
        self.device = device
        if cache is None:
            cache = AutotuneCache(device)
            if device not in PSEUDO_DEVICES:
                cache.load()
        self.cache = cache
        self.decisions: Dict[str, Decision] = {}

    def decide(self, sig: OpSig, override: Optional[str] = None
               ) -> Decision:
        """Resolve one signature; memoized per signature (a memo hit
        counts one more hit)."""
        key = sig.key()
        hit = self.decisions.get(key)
        if hit is not None and override is None:
            hit.hits += 1
            return hit
        if self.device == CPU:
            dec = Decision(sig=sig, backend="torch", source=CPU,
                           model_winner="torch")
            self.decisions[key] = dec
            return dec
        if self.device == NO_ROW:
            dec = Decision(sig=sig, backend="cuda", source=NO_ROW,
                           model_winner=None)
            self.decisions[key] = dec
            return dec
        model = opcost.predict(sig, self.device).winner
        entry = self.cache.get(sig)
        near = None if entry is not None else self.cache.nearest(sig)
        measured = entry or near
        if override:
            backend, source = override, "override"
        elif entry is not None:
            backend, source = entry.winner, "cache"
        elif near is not None:
            backend, source = near.winner, "near"
        else:
            backend, source = model, "model"
        dec = Decision(sig=sig, backend=backend, source=source,
                       model_winner=model,
                       cached_winner=measured.winner if measured else None)
        self.decisions[key] = dec
        return dec

    def report(self) -> dict:
        """The decisions so far and the model's audit over the whole
        cache (agreement, mispredictions listed)."""
        return {"device": self.device,
                "cache_path": str(self.cache.path),
                "cache_entries": len(self.cache.entries),
                "cache_stale": self.cache.stale,
                "decisions": [d.to_dict()
                              for d in self.decisions.values()],
                **model_audit(self.cache)}


def model_audit(cache: AutotuneCache) -> dict:
    """The model's predicted winner against every measured entry."""
    agree, mispredictions = 0, []
    for e in cache.entries.values():
        pred = opcost.predict(e.sig, cache.device)
        if pred.winner == e.winner:
            agree += 1
        else:
            mispredictions.append(
                {"sig": e.sig.key(), "measured": e.winner,
                 "predicted": pred.winner,
                 "measured_ratio": round(e.ratio, 3),
                 "predicted_ratio": round(pred.ratio, 3)})
    total = len(cache.entries)
    return {"model_agreement": (agree / total) if total else None,
            "model_agree": agree, "model_total": total,
            "mispredictions": mispredictions}


# ---------------------------------------------------------------------------
# The process-wide resolvers (the policy stays a hashable value; the
# mutable decisions live here and Context fronts them), and the memos of
# "auto" dispatch: per op, call key -> decision.
# ---------------------------------------------------------------------------

_RESOLVERS: Dict[str, Resolver] = {}
_MEMO: Dict[str, dict] = {}


def memo_for(op: str) -> dict:
    """The memo of the ``"auto"`` callable of ``op`` (emptied, never
    replaced, by :func:`reset_resolver`)."""
    return _MEMO.setdefault(op, {})


def row_of(device) -> str:
    """The resolver a ``torch.device`` reports to: ``"cpu"`` off the
    card, the card's roofline row (:func:`device_for`), or ``"no-row"``
    for a card the table has no row of."""
    if torch.device(device).type != "cuda":
        return CPU
    try:
        return device_for(device)
    except ValueError:
        return NO_ROW


def get_resolver(device: str) -> Resolver:
    """The resolver of a roofline row (loading its cache at first use),
    or of a pseudo-device (``"cpu"``, ``"no-row"``)."""
    if device not in PSEUDO_DEVICES:
        get_device(device)                  # validate the name early
    res = _RESOLVERS.get(device)
    if res is None:
        res = _RESOLVERS[device] = Resolver(device)
    return res


def reset_resolver(device: Optional[str] = None) -> None:
    """Drop the memoized resolvers (all, or one row's) and the dispatch
    memo: after a new cache, or between runs that must not share
    decisions."""
    for memo in _MEMO.values():
        memo.clear()
    if device is None:
        _RESOLVERS.clear()
    else:
        _RESOLVERS.pop(device, None)


def resolve_call(op: str, lead, args) -> Decision:
    """A call's decision: the dispatch memo's miss path.  ``lead`` is
    the call's first tensor (None: the CPU); the decision is that of
    the resolver :func:`row_of` its device names.  Dispatch records it
    and runs the kernel wrapper all the same."""
    row = CPU if lead is None else row_of(lead.device)
    return get_resolver(row).decide(opcost.signature(op, args))


# ---------------------------------------------------------------------------
# Inputs from a signature, and the tuning grid
# ---------------------------------------------------------------------------


def window_pattern(n: int, nnz: int) -> tuple:
    """A CSR ``(indptr, indices)`` of n rows and exactly nnz entries,
    each row's a window of columns around its diagonal: the band
    ``|i - j| <= w`` where nnz is a band's count (``3n - 2``, ``5n -
    6``, ...), else rows of ``nnz // n`` or one more entries."""
    for w in range(9):
        if 2 * w + 1 <= n and nnz == n * (2 * w + 1) - w * (w + 1):
            cols = np.arange(n)[:, None] + np.arange(-w, w + 1)
            keep = (cols >= 0) & (cols < n)
            return (np.concatenate([[0], np.cumsum(keep.sum(axis=1))]),
                    cols[keep])
    if not n <= nnz <= n * n:
        raise ValueError(f"window_pattern: {nnz} entries over {n} rows")
    base, extra = divmod(nnz, n)
    counts = np.where(np.arange(n) < extra, base + 1, base)
    parts = []
    for c, rows in ((base + 1, np.arange(extra)), (base, np.arange(extra, n))):
        start = np.clip(rows - (c - 1) // 2, 0, n - c)
        parts.append((start[:, None] + np.arange(c)).reshape(-1))
    return np.concatenate([[0], np.cumsum(counts)]), np.concatenate(parts)


def _block_pattern(nblk: int, nnzb: int) -> tuple:
    """The :func:`window_pattern` of the block rows as a BSR pattern
    ``(brows, bcols, nblk)`` of ints."""
    indptr, indices = window_pattern(nblk, nnzb)
    rows = np.repeat(np.arange(nblk), np.diff(indptr))
    return (tuple(int(r) for r in rows), tuple(int(c) for c in indices),
            nblk)


def args_for(sig: OpSig, device="cpu", generator=None) -> tuple:
    """The positional arguments of one call of ``sig.op`` (as
    :mod:`~repro_torch.core.dispatch` passes them) whose signature is
    ``sig``: random normal values from ``generator`` (None on the
    ``meta`` device), blocks diagonally dominant, weights positive."""
    dev = torch.device(device)
    dtype = getattr(torch, sig.dtype)
    gen = generator

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def mask(n):
        return torch.rand(n, generator=gen, device=dev) > 0.3

    def blocks(b, nb, lead=()):
        eye = torch.eye(b, device=dev, dtype=dtype)
        return eye.reshape((1,) * len(lead) + (b, b, 1)) - \
            0.05 * rnd(*lead, b, b, nb) / b

    op, n, nsys, b, k, nnz = sig.op, sig.n, sig.nsys, sig.b, sig.k, sig.nnz
    coeffs = [0.3 + 0.5 * i for i in range(k)]
    if op == "linear_sum":
        return (2.0, rnd(n), -0.5, rnd(n))
    if op == "axpy":
        return (1.7, rnd(n), rnd(n))
    if op == "linear_combination":
        return (coeffs, [rnd(n) for _ in range(k)])
    if op == "scale_add_multi":
        return (coeffs, rnd(n), [rnd(n) for _ in range(k)])
    if op in ("dot", "wrms_ss", "wrms_norm"):
        return (rnd(n), rnd(n).abs() + 0.1)
    if op == "wrms_norm_mask":
        return (rnd(n), rnd(n).abs() + 0.1, mask(n).to(dtype))
    if op == "dot_prod_multi":
        return (rnd(n), [rnd(n) for _ in range(k)])
    if op in ("block_solve_soa", "blockdiag_spmv_soa"):
        return (blocks(b, nsys), rnd(b, nsys))
    if op == "block_inverse_soa":
        return (blocks(b, nsys),)
    if op == "newton_residual_soa":
        return (rnd(n, nsys), rnd(n, nsys), rnd(n, nsys),
                rnd(nsys).abs() + 0.1, True)
    if op == "masked_update_wrms_soa":
        return (rnd(n, nsys), rnd(n, nsys), rnd(n, nsys).abs() + 0.1,
                mask(nsys))
    if op == "wrms_soa":
        return (rnd(n, nsys), rnd(n, nsys).abs() + 0.1)
    if op == "history_rescale_soa":
        return (rnd(k, k, nsys), rnd(k, n, nsys), mask(nsys))
    if op == "newton_residual_lsolve_soa":
        return (rnd(b, nsys), rnd(b, nsys), rnd(b, nsys),
                rnd(nsys).abs() + 0.1, 0.5 + rnd(nsys).abs(),
                blocks(b, nsys))
    if op == "newton_update_soa":
        return (rnd(b, nsys), rnd(b, nsys), rnd(b, nsys),
                rnd(nsys).abs() + 0.1, 0.5 + rnd(nsys).abs(),
                blocks(b, nsys), rnd(b, nsys).abs() + 0.1, mask(nsys))
    if op == "newton_block_inverse_soa":
        return (0.05 * rnd(b, b, nsys) / b, rnd(nsys).abs() + 0.1)
    if op == "lagrange_rescale_soa":
        eta = 10.0 ** (2 * torch.rand(nsys, generator=gen, device=dev,
                                      dtype=dtype) - 1)
        q = torch.randint(0, k, (nsys,), generator=gen, device=dev,
                          dtype=torch.int32)
        return (eta, q, rnd(k, n, nsys), mask(nsys))
    if op == "csr_spmv":
        from .sunmatrix import CSRPattern
        indptr, indices = window_pattern(n, nnz)
        return (rnd(nnz), rnd(n), CSRPattern(indptr, indices, n))
    if op in ("bsr_spmv_soa", "bsr_block_jacobi_inverse_soa"):
        nblk = n // b
        pattern = _block_pattern(nblk, nnz)
        diag = torch.as_tensor([r == c for r, c in zip(*pattern[:2])],
                               device=dev)
        values = torch.where(diag[:, None, None, None],
                             blocks(b, nsys, (nnz,)), 0.05 * rnd(nnz, b, b,
                                                                 nsys) / b)
        if op == "bsr_spmv_soa":
            return (values, rnd(nblk, b, nsys), pattern)
        return (values, pattern)
    raise ValueError(f"args_for: no inputs for dispatch op {op!r}")


def _sig(op, n=0, nsys=0, b=0, k=0, nnz=0) -> OpSig:
    return OpSig(op, "float64", n=n, nsys=nsys, b=b, k=k, nnz=nnz)


#: the reference tuner's signatures (``benchmarks/autotune_bench.py:
#: 82-150``): streaming ops at 4096 and 262144 elements, the block ops
#: at b = 3, 8, 16, 24 over 512, 4096 and 32768 systems, the Newton
#: loop's at n = 3, 8, banded CSR of 133 and 1024 rows, a 5-block
#: tridiagonal BSR ensemble at b = 3
REFERENCE_STREAM_OPS = ("linear_sum", "linear_combination", "scale_add_multi",
                        "axpy", "dot", "wrms_norm", "wrms_norm_mask",
                        "dot_prod_multi", "wrms_ss")


def reference_grid() -> List[OpSig]:
    out = []
    multi = ("linear_combination", "scale_add_multi", "dot_prod_multi")
    pair = ("linear_sum", "axpy")
    for n in (4096, 262144):
        for op in REFERENCE_STREAM_OPS:
            out.append(_sig(op, n=n, k=3 if op in multi else
                            2 if op in pair else 1))
    for b in (3, 8, 16, 24):
        for nsys in (512, 4096, 32768):
            out.append(_sig("block_solve_soa", n=b, nsys=nsys, b=b))
            if b <= 16 and nsys <= 4096:
                out.append(_sig("block_inverse_soa", n=b, nsys=nsys, b=b))
            if b <= 8 and nsys <= 4096:
                out.append(_sig("blockdiag_spmv_soa", n=b, nsys=nsys, b=b))
    for n in (3, 8):
        for nsys in (512, 4096, 32768):
            out.append(_sig("newton_residual_soa", n=n, nsys=nsys))
            if nsys >= 4096:
                out.append(_sig("masked_update_wrms_soa", n=n, nsys=nsys))
                out.append(_sig("wrms_soa", n=n, nsys=nsys))
            if nsys == 4096:
                out.append(_sig("history_rescale_soa", n=n, nsys=nsys, k=6))
    for n in (133, 1024):
        out.append(_sig("csr_spmv", n=n, nnz=5 * n - 6))
    for nsys in (512, 4096):
        out.append(_sig("bsr_spmv_soa", n=15, nsys=nsys, b=3, nnz=13))
        out.append(_sig("bsr_block_jacobi_inverse_soa", n=15, nsys=nsys,
                        b=3, nnz=13))
    return out


def port_grid() -> List[OpSig]:
    """The port's own ops where the reference's grid has the ops they
    fuse, at n = 3, 8 over 4096 systems: ``lagrange_rescale_soa`` (the
    history rebuild, six history rows), then
    ``newton_residual_lsolve_soa`` (the Newton residual and the b <= 8
    SpMV, n = b), ``newton_update_soa`` (those and the masked update)
    and ``newton_block_inverse_soa`` (the Newton blocks and their b <= 8
    inverse)."""
    return [_sig("lagrange_rescale_soa", n=n, nsys=4096, k=6)
            for n in (3, 8)] + \
        [_sig(op, n=b, nsys=4096, b=b)
         for op in ("newton_residual_lsolve_soa", "newton_update_soa",
                    "newton_block_inverse_soa") for b in (3, 8)]


def tune_grid() -> List[OpSig]:
    """Every signature :func:`tune` measures by default: the
    reference's grid, then the port's own ops' (a signature in both is
    measured once)."""
    seen, out = set(), []
    for sig in reference_grid() + port_grid():
        if sig.key() not in seen:
            seen.add(sig.key())
            out.append(sig)
    return out


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

#: clock cycles of the spin before each timed call (~0.5 ms on the card)
SPIN_CYCLES = 1_000_000


def device_ms(fn, flush: torch.Tensor, reps: int = 25) -> float:
    """Median device milliseconds of one call of ``fn``: CUDA events
    around it, the L2 flushed (``flush`` zeroed) before each run and a
    spin kernel after the flush, so the events bracket the device work
    and not the call's host time (``chip_smoke.py``'s ``time_ms``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def tune(cases: Optional[Iterable] = None, reps: int = 25,
         path: Optional[Path] = None, verbose: bool = True
         ) -> AutotuneCache:
    """Time both implementations of each case on the card and write the
    cache of the card's row to ``path`` (a file, or a directory to hold
    ``<row>.json``; default the row's file under
    :func:`default_cache_dir`).  ``cases`` are signatures or ``(op,
    args)`` pairs (default :func:`tune_grid`, inputs from
    :func:`args_for`); every time is the median device time of ``reps``
    calls.  Resets the row's resolver, so the next ``"auto"`` call reads
    the new cache.  Without CUDA it raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("tune: CUDA is not available; the autotuner "
                           "times the kernels on the card")
    from . import dispatch
    dev = torch.device("cuda", torch.cuda.current_device())
    row = device_for(dev)
    if path is not None and Path(path).suffix != ".json":
        path = Path(path) / f"{row}.json"
    cache = AutotuneCache(row, path=path)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for case in (tune_grid() if cases is None else cases):
        if isinstance(case, OpSig):
            op, args = case.op, args_for(case, dev, gen)
        else:
            op, args = case
        impls = dispatch.OP_TABLE[op]
        sig = opcost.signature(op, args)
        t = {be: device_ms(lambda: impls[be](*args), flush, reps) / 1e3
             for be in BACKENDS}
        entry = Entry(sig=sig, t_torch=t["torch"], t_cuda=t["cuda"])
        cache.put(entry)
        if verbose:
            print(f"tune {sig.key()} torch {entry.t_torch * 1e3:.4f} ms "
                  f"cuda {entry.t_cuda * 1e3:.4f} ms ratio "
                  f"{entry.ratio:.2f} -> {entry.winner}", flush=True)
        del args
    cache.save()
    reset_resolver(row)
    if verbose:
        audit = model_audit(cache)
        print(f"tune: {len(cache.entries)} entries -> {cache.path}; model "
              f"agrees on {audit['model_agree']}/{audit['model_total']}",
              flush=True)
    return cache


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.autotune",
        description="time both implementations of every dispatch op on "
                    "the card and write the autotune cache")
    ap.add_argument("--tune", action="store_true", required=True)
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="cache directory (default: "
                         "$REPRO_TORCH_AUTOTUNE_DIR or .autotune_torch)")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    tune(reps=args.reps, path=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
