"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level names, since the port's name ``repro_torch``
begins with the JAX package's; and a run without a card, or without the
program beside the benchmark, prints no result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import cli

#: one CPU run of a cell through the harness, its trace reduced, then
#: the loaded modules the rule forbids, as JSON
PROBE = """
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
from portbench.harness import check, cli, manifest, session, trace
man = manifest.Manifest(root)
for cell in [c["name"] for c in man.data["workloads"]]:
    run = session.run(man, cell, 3, 0.01, True, time.perf_counter(),
                      device="cpu", nsys=8)
    for prof in run.trace.values():
        trace.profiler_events(prof)
    check.numbers(run, man.family(run.cfg["family"]))
print(json.dumps(cli.forbidden_modules()))
"""


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = dict.fromkeys(["repro_torch", "repro_torch.core", "jaxtyping",
                          "reprox", "flax_like"])
    for name in fake:
        monkeypatch.setitem(sys.modules, name, None)
    assert cli.forbidden_modules() == []
    for name in ("repro", "repro.core.ivp", "jax.numpy", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, None)
    assert cli.forbidden_modules() == ["flax", "jax.numpy", "jaxlib",
                                       "repro", "repro.core.ivp"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run(root, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "rober3-bdf.solve-2m", "--seed", str(2 ** 31 + 11), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root, env=env)


def test_a_run_without_a_card_prints_no_result():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """Only ``BENCHMARK.json`` and ``portbench/``: no program to run.  The
    look for a card is passed over (``CUDA_VISIBLE_DEVICES`` cannot make
    one), so this checks the import of the program fails the run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, time; from pathlib import Path; "
            "sys.path[:0] = ['.']; "
            "from portbench.harness import manifest, session; "
            "session.run(manifest.Manifest(Path('.')), "
            "'rober3-bdf.solve-2m', 1, 0.01, False, time.perf_counter(), "
            "device='cpu', nsys=8); print('{}')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
