"""The port's Krylov solvers against the JAX reference's.

Each of ``gmres``, ``fgmres``, ``bicgstab``, ``tfqmr`` and ``pcg``
solves a fixed, well-conditioned float64 system of 24 unknowns held as
a (4, 6) tensor (the ensemble path's (n, nsys) form): nonsymmetric,
and symmetric positive definite for ``pcg``.  Each runs unpreconditioned,
with a left preconditioner and with a right one (diagonal scaling),
against ``repro.core.krylov`` under the reference's default jnp policy.
The solutions agree to 1e-10, and ``iters``, ``npsolves`` and
``converged`` are equal.

Each solver's tolerance (5e-10 for the GMRES pair, 2e-9 for the rest,
relative) lies far from a decision boundary: no residual the solver
tests lies within 25 % of its target
(:func:`test_tolerance_is_far_from_a_decision_boundary`), so rounding
differences between the two packages cannot move an iteration count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import krylov as rk
from repro.core.policies import XLA_FUSED
from repro_torch.core import krylov
from repro_torch.core.memory import MemoryHelper

SHAPE = (4, 6)
N = 24
#: relative tolerance per solver, each far from a decision boundary
TOLS = {"gmres": 5e-10, "fgmres": 5e-10, "bicgstab": 2e-9, "tfqmr": 2e-9,
        "pcg": 2e-9}
SOLVERS = ("gmres", "fgmres", "bicgstab", "tfqmr", "pcg")
MODES = ("none", "left", "right")


def _system(spd: bool):
    rng = np.random.default_rng(11)
    if spd:
        B = rng.normal(size=(N, N))
        A = B @ B.T / N + np.diag(rng.uniform(1.0, 4.0, size=N))
    else:
        A = np.diag(rng.uniform(2.0, 6.0, size=N)) \
            + 0.6 * rng.normal(size=(N, N)) / np.sqrt(N)
    b = rng.normal(size=SHAPE)
    return A, b


def _kwargs(name):
    if name in ("gmres", "fgmres"):
        return {"restart": 8, "max_restarts": 6}
    return {"maxiter": 200}


def _solve(pkg, name, mode, tol=None):
    """Run one solver of the port ("torch") or the reference ("jax");
    returns (x as numpy, stats with numpy fields)."""
    tol = TOLS[name] if tol is None else tol
    A, b = _system(name == "pcg")
    dinv = 1.0 / np.diag(A)
    if pkg == "torch":
        At, dt = torch.from_numpy(A), torch.from_numpy(dinv).reshape(SHAPE)
        matvec = lambda v: (At @ v.reshape(-1)).reshape(SHAPE)
        scale = lambda v: dt * v
        fn, rhs = getattr(krylov, name), torch.from_numpy(b)
        kw = {}
    else:
        Aj, dj = jnp.asarray(A), jnp.asarray(dinv).reshape(SHAPE)
        matvec = lambda v: (Aj @ v.reshape(-1)).reshape(SHAPE)
        scale = lambda v: dj * v
        fn, rhs = getattr(rk, name), jnp.asarray(b)
        kw = {"policy": XLA_FUSED}
    if mode == "left":
        kw["precond_left"] = scale
    elif mode == "right":
        kw["precond"] = scale
    x, st = fn(matvec, rhs, tol=tol, **_kwargs(name), **kw)
    return np.asarray(x), {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SOLVERS)
def test_solver_matches_reference(name, mode):
    x, st = _solve("torch", name, mode)
    x_ref, st_ref = _solve("jax", name, mode)
    assert x.shape == SHAPE
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-10)
    for k in ("iters", "npsolves", "converged"):
        assert int(st[k]) == int(st_ref[k]), (k, st, st_ref)
    assert bool(st["converged"])
    np.testing.assert_allclose(st["res_norm"], st_ref["res_norm"], rtol=0,
                               atol=1e-12)
    if mode == "none":
        assert int(st["npsolves"]) == 0


@pytest.mark.parametrize("name", SOLVERS)
def test_tolerance_is_far_from_a_decision_boundary(name):
    """The reference takes as many iterations at a tolerance 1.25 times
    smaller and 1.25 times larger, in every mode: no residual the solver
    tests lies within 25 % of the target."""
    tol = TOLS[name]
    for mode in MODES:
        iters = [int(_solve("jax", name, mode, t)[1]["iters"])
                 for t in (tol / 1.25, tol, 1.25 * tol)]
        assert len(set(iters)) == 1, (mode, iters)


@pytest.mark.parametrize("name", SOLVERS)
def test_workspace_registration_matches_reference(name):
    from repro.core.memory import MemoryHelper as RefMemory
    A, b = _system(name == "pcg")
    port, ref = MemoryHelper(), RefMemory()
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    getattr(krylov, name)(lambda v: (At @ v.reshape(-1)).reshape(SHAPE),
                          torch.from_numpy(b), tol=TOLS[name], mem=port,
                          **_kwargs(name))
    getattr(rk, name)(lambda v: (Aj @ v.reshape(-1)).reshape(SHAPE),
                      jnp.asarray(b), tol=TOLS[name], mem=ref,
                      policy=XLA_FUSED,
                      **_kwargs(name))
    assert port.workspaces == ref.workspaces


def test_complex_systems_raise():
    b = torch.ones(3, dtype=torch.complex128)
    for name in SOLVERS:
        with pytest.raises(TypeError, match="real"):
            getattr(krylov, name)(lambda v: v, b)
