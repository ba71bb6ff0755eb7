"""Package-level contracts of the PyTorch port (``src/repro_torch``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import status as ref_status
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch import interop
from repro_torch.core import ivp, problems, status, sunmatrix
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.context import Context
from repro_torch.core.policies import ExecPolicy
from repro_torch import configs
from repro_torch.examples import serve_demo
from repro_torch.models import Model, ParallelCtx
from repro_torch.serve import decode

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_retcodes_match_reference():
    for name in ("SUCCESS", "TOO_MUCH_WORK", "ERR_FAILURE", "CONV_FAILURE",
                 "RHSFUNC_FAIL", "MXNCF", "MXNEF"):
        assert getattr(status, name) == getattr(ref_status, name), name
    assert status.RETCODE_NAMES == ref_status.RETCODE_NAMES
    assert status.SUNDIALS_FLAGS == ref_status.SUNDIALS_FLAGS


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad
    code = ("import sys, repro_torch.core.ivp, repro_torch.interop, "
            "repro_torch.kernels, repro_torch.core.precond, "
            "repro_torch.core.krylov, repro_torch.apps.brusselator, "
            "repro_torch.core.vector, repro_torch.core.sunmatrix, "
            "repro_torch.core.events, repro_torch.core.cvode, "
            "repro_torch.observability, repro_torch.core.context, "
            "repro_torch.examples.batched_kinetics, "
            "repro_torch.serve.solver, repro_torch.testing.chaos, "
            "repro_torch.examples.serve_solver_demo, "
            "repro_torch.examples.brusselator, "
            "repro_torch.examples.brusselator_sparse, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.serve.decode, repro_torch.examples.serve_demo, "
            "repro_torch.analysis.lint, repro_torch.analysis.hotloop, "
            "repro_torch.data.pipeline, repro_torch.optim.adamw, "
            "repro_torch.optim.gradflow, repro_torch.train.step, "
            "repro_torch.train.checkpoint, repro_torch.train.fault, "
            "repro_torch.launch.train, repro_torch.examples.quickstart, "
            "repro_torch.launch.dryrun, repro_torch.analysis.stepcost, "
            "repro_torch.analysis.roofline\n"
            "from repro_torch import configs\n"
            "configs.names()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT)


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        problems.batched_robertson(4)
    f, jac, y0 = problems.batched_robertson(4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, 1.0, "ensemble_bdf")
    # the sparse matrices' constructors, unless handed a tensor
    sm = sunmatrix
    for make in (lambda: sm.SparseCSR.from_pattern((0, 1, 2), (0, 1), (2, 2)),
                 lambda: sm.SparseCSR.from_dense(np.eye(2)),
                 lambda: sm.EnsembleBSR.from_sparsity(np.eye(2) > 0, 1, 3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    eye = torch.eye(2, dtype=torch.float64)
    assert sm.SparseCSR.from_dense(eye).data.device == eye.device
    # the model stack: weights, caches, generation and the example
    model = Model(configs.get("internlm2-1.8b-smoke"))
    for make in (lambda: model.init(0), lambda: model.init_cache(1, 4),
                 lambda: decode.generate(model, {}, torch.zeros(
                     (1, 2), dtype=torch.int32), 1),
                 lambda: serve_demo.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    params = model.init(0, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert model.init_cache(1, 4, device="cpu")["k"].device.type == "cpu"
    assert model.abstract_params()["embed"].device.type == "meta"
    assert sm.SparseCSR.from_pattern((0, 1, 2), (0, 1), (2, 2),
                                     data=eye[0]).data.device == eye.device


def test_unported_paths_raise():
    """What the port runs now (telemetry=, session=, timed=True and
    live= on the CPU, the autotuner's report of the CPU's decisions) and
    what raises: the default context's report without a card."""
    f, jac, y0 = problems.batched_robertson(4, device="cpu")
    prob = ivp.IVP(f=f, jac=jac, y0=y0)
    # bdf and adams are ported (tests/test_torch_cvode.py holds them to
    # the reference), bdf with its step telemetry
    decay = ivp.IVP(f=lambda t, y: -y, y0=torch.ones(2, dtype=torch.float64))
    for method in ("bdf", "adams"):
        sol = ivp.integrate(decay, 0.0, 1.0, method, device="cpu")
        assert bool(sol.success) and sol.method == method
        assert abs(float(sol.y[0]) - np.exp(-1.0)) < 1e-4
    assert int(ivp.integrate(decay, 0.0, 1.0, "bdf",
                             device="cpu").retcodes) == status.SUCCESS
    sol = ivp.integrate(decay, 0.0, 1.0, "bdf", device="cpu", telemetry=256)
    assert int(sol.telemetry.steps()) == int(sol.stats.steps)
    sol = ivp.integrate(prob, 0.0, 1e-3, "ensemble_dirk:sdirk2",
                        device="cpu", telemetry=512)
    assert sol.telemetry.steps().tolist() == sol.stats.steps.tolist()
    sol = ivp.integrate(prob, 0.0, 1e-3, "ensemble_bdf", device="cpu",
                        telemetry=512, return_session=True, timed=True)
    assert sol.telemetry.steps().tolist() == sol.stats.steps.tolist()
    assert set(sol.timings) == {"build", "execute"}
    assert sol.timings["build"] >= 0.0 and sol.timings["execute"] > 0.0
    sol2 = ivp.integrate(prob, 1e-3, 2e-3, "ensemble_bdf", device="cpu",
                         session=sol.session)
    assert bool(sol2.ok.all())
    live = torch.tensor([True, True, False, True])
    sol3 = ivp.integrate(prob, 0.0, 1e-3, "ensemble_bdf", device="cpu",
                         live=live)
    assert sol3.stats.steps[2] == 0 and bool(sol3.ok.all())
    assert torch.equal(sol3.stats.steps[live], sol.stats.steps[live])
    with pytest.raises(ValueError, match="live"):
        ivp.integrate(decay, 0.0, 1.0, "bdf", device="cpu",
                      live=torch.ones(1, dtype=torch.bool))
    # the default context's resolver is the card's row: no card, no row
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Context().dispatch_report()
    rep = Context(policy=ExecPolicy(device="cpu")).dispatch_report()
    assert rep["device"] == "cpu" and rep["cache_entries"] == 0
    assert rep["decisions"] and all(d["source"] == "cpu"
                                    for d in rep["decisions"])
    with pytest.raises(ValueError, match="telemetry"):
        ivp.integrate(decay, 0.0, 1.0, "erk:dopri5", device="cpu",
                      telemetry=8)
    with pytest.raises(ValueError, match="unknown method"):
        ivp.integrate(prob, 0.0, 1.0, "rk4", device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf", device="meta")
    # the expert-parallel MoE over a mesh builds (moe_ep.py; run across
    # ranks by tests/test_torch_moe_ep.py); without a mesh "ep" is the
    # dense path in both packages
    mesh = object()
    assert ParallelCtx(mesh=mesh, moe_impl="ep").mesh is mesh
    with pytest.raises(ValueError, match="moe_impl"):
        ParallelCtx(moe_impl="expert")
    moe = Model(configs.get("dbrx-132b-smoke").replace(dtype=torch.float32))
    p = moe.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int32),
             "targets": torch.zeros((1, 3), dtype=torch.int32)}
    assert torch.equal(moe.loss(p, batch, ParallelCtx(moe_impl="ep")),
                       moe.loss(p, batch))


def _fields(opts):
    d = opts._asdict()
    d.pop("policy")
    d["controller"] = opts.controller._asdict()
    return d


def test_interop_round_trips_options_and_params():
    assert _fields(ODEOptions()) == _fields(RefOptions())
    ref = RefOptions(rtol=1e-5, atol=1e-10, max_steps=1234, hmax=5.0,
                     newton_max=6)
    opts = interop.options_from_reference(_fields(ref))
    assert _fields(opts) == _fields(ref)
    with pytest.raises(ValueError, match="policy"):
        interop.options_from_reference(ref._asdict())
    rates = problems.robertson_rates(9, seed=3)
    params = interop.params_from_numpy(rates, device="cpu")
    for k, v in rates.items():
        assert params[k].dtype == torch.float64
        assert np.array_equal(params[k].numpy(), v)
    f, jac, y0 = problems.batched_robertson(9, rates=params, device="cpu")
    sol = ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, 1e-3,
                        "ensemble_bdf", opts=opts, device="cpu")
    out = interop.solution_to_numpy(sol)
    assert out["y"].shape == (9, 3) and out["retcodes"].dtype == np.int32
    assert np.array_equal(out["stats.steps"], sol.stats.steps.numpy())


def _pallas_entry_points():
    """(file, function) of every function under src/repro/kernels that
    calls pl.pallas_call."""
    found = set()
    for path in sorted((ROOT / "src" / "repro" / "kernels").glob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, ast.FunctionDef) and any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "pallas_call" for n in ast.walk(fn)):
                found.add((path.name, fn.name))
    return found


def test_perf_kernel_table_names_every_tpu_kernel():
    entries = _pallas_entry_points()
    assert len(entries) == 15
    rows = [ln for ln in (ROOT / "PERF.md").read_text().splitlines()
            if ln.startswith("|")]
    missing = [e for e in entries
               if not any(e[0] in r and f"`{e[1]}`" in r for r in rows)]
    assert not missing
