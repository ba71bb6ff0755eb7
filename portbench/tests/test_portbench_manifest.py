"""``BENCHMARK.json`` against the benchmark's contract, and discovery by
name: every cell, configuration, metric and operation is a file of its
own, and a new one is added by adding files only."""
import json
import re
import shutil

import pytest

from conftest import CELLS, ROOT, run_cell
from portbench.harness import manifest, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_keeps_the_contract_shape(data):
    assert set(data) == KEYS
    assert data["command"] == ["python3", "portbench/run.py"]
    assert data["paths"] == ["portbench"]
    assert isinstance(data["run_seconds"], int)
    assert 1 <= data["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (data["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in data[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_configs_name_their_files_and_cuts(data):
    used = {c["config"] for c in data["workloads"]}
    files = set()
    for cfg in data["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["name"] in used
        assert cfg["file"].startswith("portbench/")
        assert TEXT.match(cfg["source"]) and TEXT.match(cfg["why"])
        assert len(cfg["reduced"]) <= 16
        assert all(NAME.match(k) for k in cfg["reduced"])
        body = json.loads((ROOT / cfg["file"]).read_text())
        assert body["reduced"] == cfg["reduced"]
        assert body["source"] == cfg["source"]
        assert set(cfg["reduced"]) <= set(body["assumed"])
        files.add(cfg["file"])
    assert len(files) == len(data["configs"])


def test_cells_metrics_and_bounds(data):
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for cell in data["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and TEXT.match(cell["why"])
        assert NAME.match(cell["traffic"])
        pairs.add((cell["config"], cell["traffic"]))
        reported = [m for m in data["end_to_end"]
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell["name"] in m.get("workloads", [cell["name"]])
                   for m in data["per_layer"])
    assert len(pairs) == len(data["workloads"])
    four = sum(c["chips"] == 4 for c in data["workloads"])
    assert four <= max(1, len(data["workloads"]) // 4)
    for m in data["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in data["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(man, cell):
    c = man.cell(cell)
    cfg = man.config(c["config"])
    fam = man.family(cfg["family"])
    for fn in ("draw", "program_ivp", "rhs", "jac", "conserved"):
        assert callable(getattr(fam, fn))
    mix = man.traffic(c["traffic"])
    assert mix["nsys"] > 0 and mix["checked_lanes"] >= 1
    assert isinstance(man.limits(cell), dict)
    for kind in ("end_to_end", "per_layer"):
        for m in man.metrics(cell, kind):
            assert callable(man.reader(m["name"]).read)


def test_every_op_file_names_kernels_of_the_port():
    syms = trace.port_symbols(ROOT / "src" / "repro_torch" / "kernels"
                              / "csrc")
    assert "newton_update_kernel" in syms
    for name, mod in manifest.ops().items():
        assert mod.SYMBOLS and set(mod.SYMBOLS) <= syms, name
        flops, nbytes = mod.cost(3, 1024, 8)
        assert flops > 0 and nbytes > 0


def _extend(tmp_path):
    """A copy of the benchmark with one more configuration, cell, traffic
    mix, per-layer metric and operation, each added as files only."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "portbench"
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "rober3-bdf.json").read_text())
    cfg["nout"] = 2
    (bench / "configs" / "rober3-mild.json").write_text(json.dumps(cfg))
    (bench / "workloads" / "solve-tiny.json").write_text(json.dumps(
        {"nsys": 32, "checked_lanes": 8}))
    (bench / "limits" / "rober3-mild.solve-tiny.json").write_text(
        json.dumps({"limits": {"err_max": 50.0}}))
    (bench / "metrics" / "calls_per_window.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    (bench / "ops" / "toy_op.py").write_text(
        "SYMBOLS = ('toy_kernel',)\n\n\ndef cost(n, nsys, itemsize):\n"
        "    return n * nsys, 2 * n * nsys * itemsize\n")
    data["configs"].append({"name": "rober3-mild", "source": "x",
                            "file": "portbench/configs/rober3-mild.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "rober3-mild.solve-tiny",
                              "config": "rober3-mild",
                              "traffic": "solve-tiny", "chips": 1,
                              "why": "a test"})
    data["per_layer"].append({"name": "calls_per_window", "unit": "calls",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "front end",
                              "moves": "systems_per_s",
                              "workloads": ["rober3-mild.solve-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root


def test_a_new_cell_config_metric_and_op_are_files_only(tmp_path):
    root = _extend(tmp_path)
    man = manifest.Manifest(root, root / "portbench")
    ops = manifest.ops(root / "portbench")
    assert "toy_op" in ops
    s = trace.summarize(
        [trace.Event("void toy_kernel<double>(double*)", 10.0, 30.0)],
        [(0.0, 100.0)], {"toy_kernel"}, {"toy_op": ops["toy_op"]},
        (3, 10 ** 6, 8), {"bytes_per_s": 1e12, "flops_per_s": 1e12})
    assert s.by_op["toy_op"][0] == 1
    assert s.roofline_share == pytest.approx(100 * 48e6 / 1e12 / 20e-6)
    run, values, correct = run_cell(man, "rober3-mild.solve-tiny", nsys=None,
                                    seconds=0.3)
    assert run.nsys == 32 and run.cfg["nout"] == 2
    ends = [c.t1 for c, _, _ in run.answers]
    assert ends[:2] == [0.4, 4.0] and set(ends) == {0.4, 4.0}
    assert correct and values["err_max"] < 50.0
    metrics = man.metrics("rober3-mild.solve-tiny", "per_layer")
    assert "calls_per_window" in {m["name"] for m in metrics}
    assert man.reader("calls_per_window").read(run) == run.calls
