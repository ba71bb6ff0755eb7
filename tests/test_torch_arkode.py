"""The port's scalar ARKODE integrators against the JAX reference.

``integrate`` with ``erk:dopri5``, ``erk:bogacki_shampine``,
``dirk:sdirk2``, ``dirk:sdirk33`` and ``imex:ark324`` on the reference's
own small problems (``tests/test_integrators.py:39-150``: the stiff
scalar test equation with a dense Newton solver, the IMEX split of it,
the explicit kick problem, and the 2x2 nonlinear system through the
matrix-free GMRES Newton path), on the same float64 inputs, through
both packages' front ends.  ``y`` is held to 10*(rtol*|y| + atol) of the
reference; ``success`` and every counter (steps, attempts, nfe, nfi,
nni, netf, ncfn) are held equal: the two packages take the same step
sequence on these problems.  The fixed-step variants are held to the
reference to 1e-12 and keep their convergence orders.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import arkode as rark
from repro.core import butcher as rbut
from repro.core import ivp as rivp
from repro.core import linsol as rlin
from repro_torch import interop
from repro_torch.core import arkode, butcher, ivp, kinsol, linsol, nonlinsol
from repro_torch.core import precond
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.policies import ExecPolicy

LAM = 50.0
COUNTERS = ("steps", "attempts", "nfe", "nfi", "nni", "netf", "ncfn")


def _np(x):
    if isinstance(x, tuple):
        return np.concatenate([_np(leaf).ravel() for leaf in x])
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pair(name):
    """(reference problem kwargs, port problem kwargs, y0, t1, rtol,
    atol, reference solver, port solver)"""
    if name == "decay":             # test_erk_adaptive_hits_tolerance
        return ({"f": lambda t, y: -y}, {"f": lambda t, y: -y},
                np.ones(4), 2.0, 1e-8, 1e-12, None, None)
    if name == "forced":            # test_erk_convergence_order's RHS
        return ({"f": lambda t, y: -y + jnp.sin(3 * t)},
                {"f": lambda t, y: -y + torch.sin(3 * t)},
                np.ones(2), 1.0, 1e-6, 1e-9, None, None)
    if name == "kick":              # test_erk_rejects_and_recovers_on_kick
        return ({"f": lambda t, y: -y + 100.0 * jnp.exp(
                    -((t - 1.0) / 0.01) ** 2)},
                {"f": lambda t, y: -y + 100.0 * torch.exp(
                    -((t - 1.0) / 0.01) ** 2)},
                np.ones(1), 2.0, 1e-6, 1e-9, None, None)
    if name == "stiff":             # test_dirk_stiff_adaptive (dense)
        return ({"f": lambda t, y: -LAM * (y - jnp.cos(t))},
                {"f": lambda t, y: -LAM * (y - torch.cos(t))},
                np.zeros(1), 0.5, 1e-6, 1e-9, rlin.DenseGJ(),
                linsol.DenseGJ())
    if name == "imex":              # test_imex_adaptive_stiff (dense)
        return ({"fe": lambda t, y: LAM * jnp.cos(t) * jnp.ones_like(y),
                 "fi": lambda t, y: -LAM * y},
                {"fe": lambda t, y: LAM * torch.cos(t) * torch.ones_like(y),
                 "fi": lambda t, y: -LAM * y},
                np.zeros(1), 0.5, 1e-7, 1e-10, rlin.DenseGJ(),
                linsol.DenseGJ())
    if name == "nonlinear":         # test_matrix_free_gmres_newton_path
        return ({"f": lambda t, y: jnp.stack([-80.0 * y[0] + y[1] ** 2,
                                              -0.5 * y[1] - 0.1 * y[0]])},
                {"f": lambda t, y: torch.stack([-80.0 * y[0] + y[1] ** 2,
                                                -0.5 * y[1] - 0.1 * y[0]])},
                np.ones(2), 0.25, 1e-5, 1e-9, None, None)
    # the IMEX split of the nonlinear system, matrix-free GMRES Newton
    return ({"fe": lambda t, y: jnp.stack([y[1] ** 2, -0.1 * y[0]]),
             "fi": lambda t, y: jnp.stack([-80.0 * y[0], -0.5 * y[1]])},
            {"fe": lambda t, y: torch.stack([y[1] ** 2, -0.1 * y[0]]),
             "fi": lambda t, y: torch.stack([-80.0 * y[0], -0.5 * y[1]])},
            np.ones(2), 0.25, 1e-5, 1e-9, None, None)


CASES = [("erk:dopri5", "decay"), ("erk:dopri5", "forced"),
         ("erk:bogacki_shampine", "kick"),
         ("erk:bogacki_shampine", "forced"),
         ("dirk:sdirk2", "stiff"), ("dirk:sdirk33", "stiff"),
         ("dirk:sdirk2", "nonlinear"), ("dirk:sdirk33", "nonlinear"),
         ("imex:ark324", "imex"), ("imex:ark324", "split")]


@pytest.mark.parametrize("method,problem,backend", [
    case + (backend,) for case in CASES for backend in ("torch", "auto")
    # on the CPU both backends run the plain versions; "auto" routes
    # through the kernel wrappers, checked once per family
    if backend == "torch" or case[1] in ("decay", "stiff", "imex")])
def test_integrate_matches_reference(method, problem, backend):
    rkw, pkw, y0, t1, rtol, atol, rls, pls = _pair(problem)
    ref = rivp.integrate(rivp.IVP(y0=jnp.asarray(y0), **rkw), 0.0, t1,
                         method, opts=rark.ODEOptions(rtol=rtol, atol=atol),
                         lin_solver=rls)
    sol = ivp.integrate(ivp.IVP(y0=torch.from_numpy(y0.copy()), **pkw), 0.0,
                        t1, method, lin_solver=pls, device="cpu",
                        opts=ODEOptions(rtol=rtol, atol=atol,
                                        policy=ExecPolicy(backend=backend)))
    assert bool(sol.success) == bool(ref.success) is True
    want = _np(ref.y)
    bound = 10 * (rtol * np.abs(want) + atol)
    assert np.all(np.abs(_np(sol.y) - want) <= bound)
    for k in COUNTERS:
        assert int(getattr(sol.stats, k)) == int(getattr(ref.stats, k)), k
    assert float(sol.t) == float(ref.t)
    assert sol.lin_solver == ref.lin_solver
    assert sol.nonlin_solver == ref.nonlin_solver
    assert int(sol.nni) == int(ref.nni)
    assert sol.retcodes is None and sol.ok is None


def test_tuple_state_matches_reference_pytree():
    """A state of two leaves (the reference's tuple pytree) through the
    explicit and the implicit families."""
    y0 = (np.ones(2), np.full(3, 0.5))
    for method in ("erk:dopri5", "dirk:sdirk2"):
        ref = rivp.integrate(
            rivp.IVP(f=lambda t, y: (-y[0], -2.0 * y[1] + jnp.sin(t)),
                     y0=tuple(jnp.asarray(a) for a in y0)), 0.0, 0.5, method,
            opts=rark.ODEOptions(rtol=1e-5, atol=1e-10))
        sol = ivp.integrate(
            ivp.IVP(f=lambda t, y: (-y[0], -2.0 * y[1] + torch.sin(t)),
                    y0=tuple(torch.from_numpy(a.copy()) for a in y0)),
            0.0, 0.5, method, opts=ODEOptions(rtol=1e-5, atol=1e-10),
            device="cpu")
        assert isinstance(sol.y, tuple) and sol.y[1].shape == (3,)
        want = _np(ref.y)
        assert np.all(np.abs(_np(sol.y) - want)
                      <= 10 * (1e-5 * np.abs(want) + 1e-10))
        for k in COUNTERS:
            assert int(getattr(sol.stats, k)) == int(getattr(ref.stats, k))


@pytest.mark.parametrize("name", ["euler", "heun_euler", "bogacki_shampine",
                                  "dormand_prince"])
def test_erk_fixed_matches_reference(name):
    tab = interop.table_from_reference(rbut.ERK_TABLES[name]._asdict())
    assert tab == butcher.ERK_TABLES[name]
    ref = rark.erk_fixed(lambda t, y: -y + jnp.sin(3 * t), jnp.ones((2,)),
                         0.0, 1.0, 32, rbut.ERK_TABLES[name])
    got = arkode.erk_fixed(lambda t, y: -y + torch.sin(3 * t),
                           torch.ones(2, dtype=torch.float64), 0.0, 1.0, 32,
                           tab)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-12)


def _exact_stiff(t):
    a = LAM * LAM / (1 + LAM * LAM)
    b = LAM / (1 + LAM * LAM)
    return a * np.cos(t) + b * np.sin(t) - a * np.exp(-LAM * t)


def test_fixed_implicit_variants_match_reference_and_keep_their_order():
    fi_t = lambda t, y: -LAM * (y - torch.cos(t))        # noqa: E731
    fi_j = lambda t, y: -LAM * (y - jnp.cos(t))          # noqa: E731
    errs = []
    for n in (40, 80, 160):
        got = arkode.dirk_fixed(fi_t, torch.zeros(1, dtype=torch.float64),
                                0.0, 1.0, n, butcher.SDIRK2,
                                lin_solver=linsol.DenseGJ())
        errs.append(abs(float(got[0]) - _exact_stiff(1.0)))
    ref = rark.dirk_fixed(fi_j, jnp.zeros((1,)), 0.0, 1.0, 160,
                          rbut.SDIRK2, lin_solver=rlin.DenseGJ())
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-12)
    assert math.log2(errs[1] / errs[2]) > 1.6
    tab = interop.imex_table_from_reference(rbut.ARK324._asdict())
    assert tab == butcher.ARK324
    fe_t = lambda t, y: LAM * torch.cos(t) * torch.ones_like(y)  # noqa: E731
    fe_j = lambda t, y: LAM * jnp.cos(t) * jnp.ones_like(y)      # noqa: E731
    errs = []
    for n in (40, 80, 160):
        got = arkode.imex_fixed(fe_t, lambda t, y: -LAM * y,
                                torch.zeros(1, dtype=torch.float64), 0.0,
                                1.0, n, tab, lin_solver=linsol.DenseGJ())
        errs.append(abs(float(got[0]) - _exact_stiff(1.0)))
    ref = rark.imex_fixed(fe_j, lambda t, y: -LAM * y, jnp.zeros((1,)), 0.0,
                          1.0, 160, rbut.ARK324, lin_solver=rlin.DenseGJ())
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-12)
    assert math.log2(errs[1] / errs[2]) > 2.5


def test_newton_reads_its_test_once_an_iteration():
    from repro_torch.core import loops
    loops.reset_loop_counts()
    z, st = kinsol.newton_solve(lambda z: z * z - 4.0,
                                torch.tensor([3.0], dtype=torch.float64),
                                lambda z, rhs: rhs / (2 * z), tol=1e-12,
                                max_iters=20)
    assert st.converged and abs(float(z[0]) - 2.0) < 1e-12
    assert loops.loop_counts["newton_trips"] == st.iters
    assert loops.loop_counts["host_syncs"] == st.iters


def test_waiting_solvers_raise():
    # the fixed point and the scalar preconditioner surface are ported:
    # y = y/2 + 1 converges to 2; a Jacobi preconditioner needs jac_diag
    y, st = nonlinsol.FixedPointSolver(tol=1e-12).solve(
        lambda y: 0.5 * y + 1.0, torch.ones(2, dtype=torch.float64))
    assert st.converged and float((y - 2.0).abs().max()) < 1e-10
    z = torch.ones(3, dtype=torch.float64)
    rhs = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    lin = linsol.SPGMR(precond=precond.JacobiPrecond()).bind(lambda t, y: -y)
    with pytest.raises(ValueError, match="jac_diag"):
        lin(torch.tensor(0.0), z, 0.5, rhs)
    lin = linsol.SPGMR(precond=precond.JacobiPrecond(
        jac_diag=lambda t, y: -torch.ones_like(y))).bind(lambda t, y: -y)
    np.testing.assert_allclose(lin(torch.tensor(0.0), z, 0.5, rhs).numpy(),
                               rhs.numpy() / 1.5, rtol=1e-12)
    with pytest.raises(NotImplementedError, match="ensemble"):
        linsol.BlockDiagGJ().bind(lambda t, y: y)
    prob = ivp.IVP(f=lambda t, y: -y, y0=torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="takes no lin_solver"):
        ivp.integrate(prob, 0.0, 1.0, "erk:dopri5", device="cpu",
                      lin_solver=linsol.DenseGJ())
    with pytest.raises(ValueError, match="takes no live"):
        ivp.integrate(prob, 0.0, 1.0, "erk:dopri5", device="cpu",
                      live=torch.ones(1, dtype=bool))
    with pytest.raises(ValueError, match="needs IVP.fe"):
        ivp.integrate(prob, 0.0, 1.0, "imex:ark324", device="cpu")
