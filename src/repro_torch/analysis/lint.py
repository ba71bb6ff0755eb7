"""sunlint for the PyTorch port: static checks of the port's invariants.

Counterpart of ``repro.analysis.lint``.  The reference walks jaxprs; the
port has no trace, so its rules read what they check directly: the op
table and its registries, the kernels' launch sizes, and the step loops'
source (Python ``ast``), and the ops that the Newton trips dispatch
(:mod:`.hotloop`, a ``TorchDispatchMode`` walker).  Five rules
(:mod:`repro_torch.analysis.rules`):

* ``kernel-contract`` — every op's inputs built from a signature give
  back that signature; on a card, kernel and plain version return the
  same shapes and dtypes; the kernels' shared memory and block sizes fit
  the card's row;
* ``table-coherence`` — the op table, the cost model's registries, the
  op notes, the port's autotune caches and the two rendered op matrices
  name one op set;
* ``bounded-loops`` — every ``while`` of the step loops is bounded by an
  integer ceiling of the options;
* ``hot-loop-layout`` — no permuted view is copied inside a Newton trip
  of ``ensemble_bdf`` or ``ensemble_dirk``;
* ``dtype-drift`` — no floating dtype changes width inside those trips
  (``dtype_allowlist`` holds the deliberate (source, destination)
  pairs).

The reference's other jaxpr walkers (``donation``, ``purity``,
``telemetry-purity``) have no counterpart here (ROADMAP queue A.8
records why).

* **Rules** register with :func:`register`; each is ``rule(ctx) ->
  [Violation]``.
* A :class:`LintContext` supplies what rules read, each field with a
  lazy default from the real tree; the fixtures
  (:mod:`repro_torch.analysis.fixtures`) override single fields.
* **Suppression**: a ``# sunlint: disable=<rule>`` comment on the line
  a violation names, or a ``rule|where`` entry of the port's baseline
  file ``.sunlint-torch-baseline`` (a trailing ``*`` matches a prefix;
  ``#`` starts a comment; the file is optional and absent while the
  tree is clean).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint --check
    PYTHONPATH=src python -m repro_torch.analysis.lint --list
    PYTHONPATH=src python -m repro_torch.analysis.lint --rule bounded-loops
    PYTHONPATH=src python -m repro_torch.analysis.lint --fixture orphan_op

Exit status 0: no unsuppressed violation; 1: at least one, or an
unknown rule or fixture.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
PACKAGE = Path(__file__).resolve().parents[1]

#: the modules whose step loops bounded-loops walks
LOOP_MODULES = ("core/batched.py", "core/arkode.py", "core/cvode.py",
                "core/kinsol.py", "core/krylov.py", "core/events.py")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: the rule, a stable location string, the message, and
    where it can, the (file, line) a suppression comment may sit on."""

    rule: str
    where: str
    message: str
    src: Optional[Tuple[str, int]] = None

    def key(self) -> str:
        return f"{self.rule}|{self.where}"


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    fn: Callable


RULES: Dict[str, Rule] = {}


def register(name: str, doc: str):
    """Decorator: add ``fn(ctx) -> [Violation]`` to :data:`RULES`."""
    def deco(fn):
        RULES[name] = Rule(name, doc, fn)
        return fn
    return deco


def load_rules() -> Dict[str, Rule]:
    """Import the rules package (idempotent): each rule registers itself
    at import."""
    importlib.import_module("repro_torch.analysis.rules")
    return RULES


@dataclasses.dataclass
class LoopSource:
    """One module whose loops bounded-loops reads: ``name``, its
    ``path`` and, for a fixture, its ``text`` (None: read the path)."""

    name: str
    path: Path
    text: Optional[str] = None

    def read(self) -> str:
        return self.text if self.text is not None else self.path.read_text()


class LintContext:
    """What the rules read.  Every field has a lazy default built from
    the real tree; fixtures override single fields through the
    setters."""

    def __init__(self, repo_root: Optional[Path] = None):
        self.repo_root = Path(repo_root) if repo_root else REPO_ROOT
        self.baseline_path = self.repo_root / ".sunlint-torch-baseline"
        #: names an ordered loop guard may compare against (bounded-loops)
        self.loop_ceilings = {"max_steps", "maxiter", "max_iters",
                              "max_iter", "max_restarts", "newton_max",
                              "maxcor"}
        self._op_table = None
        self._contract_sigs = None
        self._loop_sources = None
        self._device = None
        self._cache_dir = None
        self._cuda = None
        self._hot_loop_targets = None
        self._traces: Dict[str, object] = {}
        #: (source, destination) float dtype names dtype-drift allows:
        #: the seam for a deliberate mixed-precision cast
        self.dtype_allowlist = set()

    @property
    def op_table(self) -> dict:
        if self._op_table is None:
            from ..core import dispatch
            self._op_table = dict(dispatch.OP_TABLE)
        return self._op_table

    @op_table.setter
    def op_table(self, table):
        self._op_table = dict(table)

    @property
    def contract_sigs(self) -> Dict[str, list]:
        if self._contract_sigs is None:
            self._contract_sigs = default_contract_sigs()
        return self._contract_sigs

    @contract_sigs.setter
    def contract_sigs(self, sigs):
        self._contract_sigs = dict(sigs)

    @property
    def loop_sources(self) -> List[LoopSource]:
        if self._loop_sources is None:
            self._loop_sources = [LoopSource(m, PACKAGE / m)
                                  for m in LOOP_MODULES]
        return self._loop_sources

    @loop_sources.setter
    def loop_sources(self, sources):
        self._loop_sources = list(sources)

    @property
    def device(self):
        """The roofline row kernel-contract checks the launch sizes
        against (default ``h100_sxm``)."""
        if self._device is None:
            from .roofline import get_device
            self._device = get_device("h100_sxm")
        return self._device

    @device.setter
    def device(self, row):
        self._device = row

    @property
    def cache_dir(self) -> Path:
        """Where the port's autotune caches lie (table-coherence)."""
        if self._cache_dir is None:
            from ..core.autotune import default_cache_dir
            self._cache_dir = default_cache_dir()
        return self._cache_dir

    @cache_dir.setter
    def cache_dir(self, path):
        self._cache_dir = Path(path)

    @property
    def cuda(self) -> bool:
        """Whether kernel-contract runs its card half (default: a card is
        present)."""
        if self._cuda is None:
            import torch
            self._cuda = torch.cuda.is_available()
        return self._cuda

    @cuda.setter
    def cuda(self, on: bool):
        self._cuda = bool(on)


    @property
    def hot_loop_targets(self) -> list:
        """What the hot-loop rules trace (default: four steps of
        ``ensemble_bdf`` and of ``ensemble_dirk`` on the main path's
        problem, 8 systems on the CPU)."""
        if self._hot_loop_targets is None:
            from .hotloop import robertson_targets
            self._hot_loop_targets = robertson_targets()
        return self._hot_loop_targets

    @hot_loop_targets.setter
    def hot_loop_targets(self, targets):
        self._hot_loop_targets = list(targets)
        self._traces = {}

    def hot_loop_trace(self, target):
        """The target's :class:`~.hotloop.HotLoopTrace`, run once and
        shared by the rules that read it."""
        if target.name not in self._traces:
            from .hotloop import trace
            self._traces[target.name] = trace(target)
        return self._traces[target.name]


def default_contract_sigs() -> Dict[str, list]:
    """The signatures kernel-contract checks per op: the reference's grid
    (``repro/analysis/lint.py:274-310``; block sizes on both sides of
    the b <= 8 and b > 8 bodies) and the port's own ops,
    ``lagrange_rescale_soa``, ``newton_residual_lsolve_soa``,
    ``newton_update_soa`` and ``newton_block_inverse_soa`` (the last two
    at block sizes on both sides of their one-thread and group forms)."""
    from .opcost import OpSig
    sigs: Dict[str, list] = {}

    def add(op, **kw):
        sigs.setdefault(op, []).append(OpSig(op, "float64", **kw))

    for n in (6, 300):
        for op in ("linear_sum", "axpy"):
            add(op, n=n, k=2)
        for op in ("linear_combination", "scale_add_multi",
                   "dot_prod_multi"):
            add(op, n=n, k=3)
        for op in ("dot", "wrms_norm", "wrms_ss"):
            add(op, n=n, k=1)
        add("wrms_norm_mask", n=n, k=1)
    for b, nsys in ((3, 8), (16, 40)):
        for op in ("block_solve_soa", "block_inverse_soa",
                   "blockdiag_spmv_soa"):
            add(op, n=b, nsys=nsys, b=b)
    for n, nsys in ((3, 8), (12, 40)):
        for op in ("newton_residual_soa", "masked_update_wrms_soa",
                   "wrms_soa"):
            add(op, n=n, nsys=nsys)
    add("history_rescale_soa", n=3, nsys=8, k=6)
    add("lagrange_rescale_soa", n=3, nsys=8, k=6)
    for b, nsys in ((3, 8), (8, 40)):
        add("newton_residual_lsolve_soa", n=b, nsys=nsys, b=b)
    for b, nsys in ((3, 8), (6, 40), (8, 40)):
        add("newton_update_soa", n=b, nsys=nsys, b=b)
        add("newton_block_inverse_soa", n=b, nsys=nsys, b=b)
    for n in (4, 8):
        add("csr_spmv", n=n, nnz=3 * n - 2)
    for nblk, b, nsys in ((4, 3, 8),):
        add("bsr_spmv_soa", n=nblk * b, nsys=nsys, b=b, nnz=3 * nblk - 2)
        add("bsr_block_jacobi_inverse_soa", n=nblk * b, nsys=nsys, b=b,
            nnz=3 * nblk - 2)
    return sigs


# ---------------------------------------------------------------------------
# Suppression
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> List[str]:
    """``rule|where`` entries (a trailing ``*`` matches a prefix); a
    missing file is an empty baseline."""
    if not path.is_file():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            out.append(line)
    return out


_SRC_CACHE: Dict[str, List[str]] = {}


def _source_line(fname: str, lineno: int) -> str:
    lines = _SRC_CACHE.get(fname)
    if lines is None:
        try:
            lines = Path(fname).read_text().splitlines()
        except OSError:
            lines = []
        _SRC_CACHE[fname] = lines
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1]
    return ""


def is_suppressed(v: Violation, baseline: Sequence[str]) -> bool:
    for entry in baseline:
        if entry.endswith("*"):
            if v.key().startswith(entry[:-1]):
                return True
        elif entry == v.key():
            return True
    if v.src is not None:
        line = _source_line(*v.src)
        if "# sunlint: disable=" in line:
            disabled = line.split("# sunlint: disable=", 1)[1]
            names = {s.strip().split()[0] for s in disabled.split(",")
                     if s.strip()}
            if v.rule in names or "all" in names:
                return True
    return False


# ---------------------------------------------------------------------------
# Running the rules
# ---------------------------------------------------------------------------


def run_rules(ctx: LintContext,
              names: Optional[Sequence[str]] = None) -> List[Violation]:
    """Run the named rules (default all); raw violations, suppression
    not applied (the caller filters)."""
    load_rules()
    if names:
        unknown = sorted(set(names) - set(RULES))
        if unknown:
            raise KeyError(f"unknown rule(s) {unknown}; registered: "
                           f"{', '.join(sorted(RULES))}")
    out: List[Violation] = []
    for name in sorted(RULES):
        if names and name not in names:
            continue
        out.extend(RULES[name].fn(ctx))
    return out


def load_fixtures() -> dict:
    """``{name: (expected_rule, setup)}`` of
    :mod:`repro_torch.analysis.fixtures`."""
    from . import fixtures
    return fixtures.FIXTURES


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="sunlint: static checks of the PyTorch port")
    ap.add_argument("--check", action="store_true",
                    help="run every rule over the tree (the default)")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="NAME", help="run only this rule (repeatable)")
    ap.add_argument("--fixture", default=None, metavar="NAME",
                    help="seed a deliberately bad input from "
                    "repro_torch.analysis.fixtures (expected exit: 1)")
    ap.add_argument("--list", action="store_true",
                    help="list the registered rules and exit")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file's suppressions")
    args = ap.parse_args(argv)

    load_rules()
    if args.list:
        for name in sorted(RULES):
            print(f"{name:20s} {RULES[name].doc}")
        return 0

    ctx = LintContext()
    if args.fixture:
        fixtures = load_fixtures()
        if args.fixture not in fixtures:
            print(f"unknown fixture {args.fixture!r}; available: "
                  f"{', '.join(sorted(fixtures))}", file=sys.stderr)
            return 1
        expected_rule, setup = fixtures[args.fixture]
        setup(ctx)
        print(f"fixture {args.fixture!r} seeded (expects rule "
              f"{expected_rule!r} to fire)")

    try:
        violations = run_rules(ctx, args.rule)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 1
    baseline = [] if args.no_baseline else load_baseline(ctx.baseline_path)
    kept = [v for v in violations if not is_suppressed(v, baseline)]
    muted = len(violations) - len(kept)

    n_rules = len(args.rule) if args.rule else len(RULES)
    for v in kept:
        loc = f"  [{v.src[0]}:{v.src[1]}]" if v.src else ""
        print(f"{v.rule}: {v.where}: {v.message}{loc}")
    print(f"sunlint: {len(kept)} violation{'' if len(kept) == 1 else 's'} "
          f"({n_rules} rules, {muted} suppressed)")
    return 1 if kept else 0


if __name__ == "__main__":
    # under ``python -m`` this file is ``__main__``: run the package's
    # module, so the rules register into its RULES
    from repro_torch.analysis import lint as _lint
    sys.exit(_lint.main())
