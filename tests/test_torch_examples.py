"""The port's examples (``python -m repro_torch.examples.<name>``) at a
tiny size on the CPU.  ``batched_kinetics`` is run by
``tests/test_torch_session.py`` and ``serve_solver_demo`` by
``tests/test_torch_serving.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import brusselator, brusselator_sparse


def test_brusselator_example_runs_on_the_cpu(capsys):
    out = brusselator.main(["--device", "cpu", "--nx", "16", "--tf",
                            "0.01"])
    assert set(out) == {"task-local", "global"}
    for y, st, _ in out.values():
        assert bool(st.success) and y.shape == (16, 3)
    assert "solutions agree" in capsys.readouterr().out


def test_brusselator_sparse_example_runs_on_the_cpu(capsys):
    out = brusselator_sparse.main(["--device", "cpu", "--nsys", "4",
                                   "--nx", "4", "--tf", "0.2"])
    assert set(out) == {"dense", "sparse", "krylov"}
    assert all(bool(sol.success) for sol, _ in out.values())
    assert out["sparse"][0].lin_solver != out["dense"][0].lin_solver
    assert "newton storage" in capsys.readouterr().out
