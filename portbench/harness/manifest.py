"""Everything the harness finds by name.

``BENCHMARK.json`` at the checkout's root lists the cells, the
configurations and the metrics.  Each piece that belongs to one of them
is a file of its own under ``portbench/``, found from its name:

* a configuration: ``configs/<config>.json`` (the manifest's ``file``),
  whose ``family`` names ``problems/<family>.py`` (inputs and the plain
  reference);
* a traffic mix: ``workloads/<traffic>.json``;
* a cell's limits on the numbers that decide ``correct``:
  ``limits/<cell>.json``;
* a metric: ``metrics/<name>.py``, a reader ``read(run) -> float | None``;
* an operation's cost: ``ops/<op>.py``, with ``SYMBOLS`` (the kernels
  that implement it) and ``cost(n, nsys, itemsize) -> (flops, bytes)``.

So a later cell, configuration, metric or operation is added by adding
files and entries; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        known = ", ".join(c["name"] for c in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")

    def config(self, name: str) -> dict:
        """The configuration's file, as a dict, with its ``name``."""
        for entry in self.data["configs"]:
            if entry["name"] == name:
                cfg = json.loads((self.root / entry["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.bench_dir / "workloads" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix["name"] = name
        return mix

    def limits(self, cell_name: str) -> dict:
        """``{number: limit}`` of the cell (``calls_failed`` is always
        held to 0 besides)."""
        path = self.bench_dir / "limits" / f"{cell_name}.json"
        return json.loads(path.read_text())["limits"]

    def family(self, name: str):
        return load_module(self.bench_dir / "problems" / f"{name}.py",
                           f"portbench_problem_{name}")

    def metrics(self, cell_name: str, kind: str) -> list:
        """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
        reports: those without a ``workloads`` key and those that list
        it."""
        return [m for m in self.data[kind]
                if cell_name in m.get("workloads", [cell_name])]

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}")


def ops(bench_dir: Path = BENCH_DIR) -> dict:
    """Every operation's cost file: ``{op name: module}``."""
    return {p.stem: load_module(p, f"portbench_op_{p.stem}")
            for p in sorted((Path(bench_dir) / "ops").glob("*.py"))}


def peaks(bench_dir: Path = BENCH_DIR) -> dict:
    """The table of published device peaks (``peaks.json``)."""
    return json.loads((Path(bench_dir) / "peaks.json").read_text())
