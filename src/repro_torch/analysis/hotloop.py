"""The dispatch walker: the aten ops of the ensemble integrators' Newton
trips, as two of sunlint's rules read them.

The reference walks the jaxprs of its Newton ``while_loop`` bodies
(``repro/analysis/lint.py`` ``innermost_while_bodies``).  The port runs
those loops in Python, so its walker records what each trip dispatches:
a :class:`HotLoopTrace` (a ``TorchDispatchMode``) runs a target, a few
steps of an integrator, and keeps every aten call made while
``core.loops.regions`` is not empty, that is inside a
``core.loops.region`` (``core/batched.py`` marks the ensemble-BDF and
ensemble-DIRK Newton trips).  Kernel launches, which go through
``ctypes``, are not aten calls; their wrappers' own tensor work is.

Per call it notes what the two rules ask:

* ``hot-loop-layout`` — a permute or transpose (and any view taken of
  its result) whose result a copy then reads: ``clone`` (which
  ``.contiguous()`` and a copying ``reshape`` dispatch to), ``copy_``,
  ``_to_copy`` or a ``_unsafe_view`` of a non-contiguous input;
* ``dtype-drift`` — a call whose tensors mix floating dtypes of
  different widths: an explicit cast (``_to_copy``, ``copy_``) or an
  implicit promotion (a float32 tensor in a float64 product).

Each finding carries the source line that made the call (the innermost
frame outside PyTorch and this package) and its ``module.function``.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import loops

_HERE = Path(__file__).resolve().parent

#: aten packets whose result is a permuted view of their input (``.T``,
#: ``.mT``, ``movedim`` and the like dispatch to these)
PERMUTES = {"permute", "transpose", "t"}
#: aten packets that copy their source into new or other storage
#: (``.contiguous()`` and a copying ``reshape`` dispatch to ``clone``)
COPIES = {"clone", "copy_", "_to_copy"}
FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One call of a Newton trip that breaks a rule's invariant; a
    dtype finding's ``pair`` is its (source, destination) dtype names."""

    rule: str
    region: str
    op: str
    detail: str
    src: Optional[Tuple[str, int]]
    where_fn: str                   # module.function of the call
    pair: Optional[Tuple[str, str]] = None

    def key(self, target: str) -> str:
        return f"{target}:{self.region}:{self.where_fn}:{self.op}"


@dataclasses.dataclass(frozen=True)
class HotLoopTarget:
    """A few steps of an integrator, ``run()`` on the device it builds
    its inputs on; ``name`` prefixes its findings' keys."""

    name: str
    run: Callable[[], object]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


_TORCH = Path(torch.__file__).resolve().parent


def _caller() -> Tuple[Optional[Tuple[str, int]], str]:
    """(file, line) and ``module.function`` of the innermost frame that is
    neither PyTorch's nor this package's: the line that made the call."""
    f = sys._getframe(2)
    while f is not None:
        path = Path(f.f_code.co_filename).resolve()
        if _TORCH not in path.parents and _HERE not in path.parents \
                and path.name != "contextlib.py":
            mod = f.f_globals.get("__name__", "?")
            return (str(path), f.f_lineno), f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return None, "?"


class HotLoopTrace(TorchDispatchMode):
    """Records the rules' findings among the aten calls of the hot-loop
    regions, and counts those calls (``calls``) per region."""

    def __init__(self):
        super().__init__()
        self.findings: List[Finding] = []
        self.calls: dict = {}
        self._permuted: dict = {}          # id -> weakref of permuted views

    def _is_permuted(self, t) -> bool:
        ref = self._permuted.get(id(t))
        return ref is not None and ref() is t

    def _mark(self, out):
        for t in _tensors(out):
            self._permuted[id(t)] = weakref.ref(t)

    def _find(self, rule, func, detail, pair=None):
        src, where_fn = _caller()
        self.findings.append(Finding(rule, loops.regions[-1],
                                     func.overloadpacket.__name__, detail,
                                     src, where_fn, pair))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not loops.regions:
            return out
        region = loops.regions[-1]
        self.calls[region] = self.calls.get(region, 0) + 1
        packet = func.overloadpacket.__name__
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        # --- layout: a permute, a view of one, a copy reading one ---
        if packet in PERMUTES or (func.is_view and any(
                self._is_permuted(t) for t in ins)):
            self._mark(out)
        elif packet in COPIES or packet == "_unsafe_view":
            src = args[1] if packet == "copy_" else args[0]
            if isinstance(src, torch.Tensor) and self._is_permuted(src) \
                    and not src.is_contiguous():
                self._find("hot-loop-layout", func,
                           f"{packet} of a permuted view (shape "
                           f"{tuple(src.shape)}, strides {src.stride()})")
        # --- dtype: floating tensors of different widths in one call ---
        floats = sorted({t.dtype for t in ins + list(_tensors(out))
                         if t.dtype in FLOATS}, key=lambda d: d.itemsize)
        if len({d.itemsize for d in floats}) > 1:
            if packet == "_to_copy":
                pair = (args[0].dtype, out.dtype)
            elif packet == "copy_":
                pair = (args[1].dtype, args[0].dtype)
            else:                                   # implicit promotion
                pair = (floats[0], floats[-1])
            kind = "promotion" if pair[1].itemsize > pair[0].itemsize \
                else "truncation"
            names = (_name(pair[0]), _name(pair[1]))
            self._find("dtype-drift", func, f"float {kind} {names[0]} -> "
                       f"{names[1]} in {packet}", names)
        return out


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def trace(target: HotLoopTarget) -> HotLoopTrace:
    """Run ``target`` under a :class:`HotLoopTrace` and return it."""
    mode = HotLoopTrace()
    with mode:
        target.run()
    if not mode.calls:
        raise RuntimeError(f"hot-loop target {target.name!r} ran no op inside "
                           "a core.loops.region: the walker saw no trip")
    return mode


def robertson_targets(nsys: int = 8, device="cpu", steps: int = 4):
    """The main path's problem (batched Robertson with its SoA forms,
    float64, ``BlockDiagGJ()``) for ``steps`` steps of ``ensemble_bdf``
    and of ``ensemble_dirk``: the walker's default targets."""
    from ..core import ivp, problems
    from ..core.arkode import ODEOptions
    from ..core.policies import ExecPolicy

    def run(method):
        rates = problems.robertson_rates(nsys, seed=0)
        f, jac, y0 = problems.batched_robertson(nsys, rates=rates,
                                                device=device)
        fs, js = problems.batched_robertson_soa(nsys, rates=rates,
                                                device=device)
        prob = ivp.IVP(f=f, jac=jac, y0=y0, f_soa=fs, jac_soa=js)
        opts = ODEOptions(rtol=1e-5, atol=1e-10, max_steps=steps,
                          policy=ExecPolicy(device=device))
        return lambda: ivp.integrate(prob, 0.0, 10.0, method, opts=opts)

    return [HotLoopTarget("ensemble_bdf", run("ensemble_bdf")),
            HotLoopTarget("ensemble_dirk", run("ensemble_dirk"))]
