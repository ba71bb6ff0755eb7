"""Shared pieces of the benchmark's own tests.

Run from the checkout's root:

    python -m pytest portbench/tests

Most tests run on the CPU: the harness's discovery, its arithmetic and
whole runs of a cell at a few dozen systems through the port's plain
versions.  Tests marked ``cuda`` decide inside a fixture whether a card
is present and skip without one.
"""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import check, manifest, session  # noqa: E402

CELLS = [c["name"] for c in manifest.Manifest(ROOT).data["workloads"]]


@pytest.fixture(scope="session")
def man():
    return manifest.Manifest(ROOT)


@pytest.fixture
def card():
    """The card, or a skip."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def run_cell(man, cell, *, nsys=48, seconds=0.5, seed=2 ** 33 + 7,
             device="cpu", dtype=None, fault=None):
    """Set up and run ``cell`` at ``nsys`` systems, then compare with the
    reference: ``(run, values, correct)``.  The harness's look for a
    card is skipped; everything after it runs as in a benchmark run."""
    run = session.run(man, cell, seed, seconds, False, time.perf_counter(),
                      device=device, dtype=dtype, nsys=nsys, fault=fault)
    values = check.numbers(run, man.family(run.cfg["family"]))
    correct, _ = check.verdict(values, run.limits)
    return run, values, correct
