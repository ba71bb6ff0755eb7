"""The port's sparse ensemble through ``integrate(..., "ensemble_bdf")``
against the JAX reference (mirrors ``tests/test_sparse_ensemble.py``).

The same problems go through both packages on the CPU, float64: batched
Robertson with the same numpy-drawn rates and the ensemble Brusselator
(its parameters are a linspace, the same in both).  The port runs its
plain PyTorch versions (CPU tensors), the reference its default jnp
policy.  In each case the success masks and the retcodes are equal and
y agrees within ``C*(rtol*|y|+atol)``: C = 100 for the Krylov solvers
(the reference's own gate between its jnp and Pallas backends on this
solver, ``test_sparse_ensemble.py:143-166``: one global Krylov iteration
couples the lanes, and rounding in its inner products can move an
iteration count) and C = 10 for ``EnsembleSparseGJ``.  ``nli``,
``npsolves``, ``npsetups`` and ``workspace_bytes`` are reported beside
the reference's; the workspace, a function of the shapes, is equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import ivp as rivp
from repro.core import linsol as rls
from repro.core import precond as rpc
from repro.core import problems as rprob
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch.core import batched, ivp, linsol, precond, problems
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.context import Context

ROBERTSON_PATTERN = np.array([[1, 1, 1], [1, 1, 1], [0, 1, 0]], bool)


def _robertson(nsys, seed=0):
    """Both packages' (IVP, ...) for batched Robertson with one set of
    numpy-drawn rates."""
    rates = problems.robertson_rates(nsys, seed=seed)
    F, J, FS, JS = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    y0 = jnp.concatenate([jnp.ones((nsys, 1)), jnp.zeros((nsys, 2))], axis=1)
    ref = dict(f=lambda t, y: F(t, y, p), jac=lambda t, y: J(t, y, p),
               f_soa=lambda t, y: FS(t, y, p),
               jac_soa=lambda t, y: JS(t, y, p), y0=y0)
    f, jac, y0p = problems.batched_robertson(nsys, rates=rates, device="cpu")
    f_soa, jac_soa = problems.batched_robertson_soa(nsys, rates=rates,
                                                    device="cpu")
    port = dict(f=f, jac=jac, f_soa=f_soa, jac_soa=jac_soa, y0=y0p)
    return ref, port


def _brusselator(nsys, nx):
    f, jac, P, y0 = rprob.ensemble_brusselator(nsys, nx)
    fp, jacp, Pp, y0p = problems.ensemble_brusselator(nsys, nx, device="cpu")
    assert np.array_equal(P, Pp)
    return dict(f=f, jac=jac, y0=y0), dict(f=fp, jac=jacp, y0=y0p), P


def _solvers(kind):
    """The same solver in both packages: (reference, port)."""
    return tuple({
        "sparse_gj": lambda m, p: m.EnsembleSparseGJ(),
        "spgmr_bj3": lambda m, p: m.SPGMR(
            tol=1e-12, restart=5, max_restarts=6,
            precond=p.BlockJacobiPrecond(block_size=3)),
        "spgmr_bj2": lambda m, p: m.SPGMR(
            tol=1e-9, restart=10, max_restarts=6,
            precond=p.BlockJacobiPrecond(block_size=2)),
        "spgmr_ilu0": lambda m, p: m.SPGMR(tol=1e-9, restart=10,
                                           max_restarts=6,
                                           precond=p.ILU0Precond()),
        "spbcgs_ilu0": lambda m, p: m.SPBCGS(tol=1e-10, maxiter=200,
                                             precond=p.ILU0Precond()),
        "spfgmr_ilu0": lambda m, p: m.SPFGMR(tol=1e-9, restart=10,
                                             max_restarts=6,
                                             precond=p.ILU0Precond()),
        "sptfqmr_bj2": lambda m, p: m.SPTFQMR(
            tol=1e-10, maxiter=200,
            precond=p.BlockJacobiPrecond(block_size=2)),
        "pcg_jacobi": lambda m, p: m.PCG(tol=1e-10, maxiter=200,
                                         precond=p.JacobiPrecond()),
    }[kind](m, p) for m, p in ((rls, rpc), (linsol, precond)))


def _run_both(ref_prob, port_prob, pattern, kind, tf, rtol, atol):
    ls_ref, ls_port = _solvers(kind)
    ref = rivp.integrate(
        rivp.IVP(jac_sparsity=pattern, **ref_prob), 0.0, tf, "ensemble_bdf",
        opts=RefOptions(rtol=rtol, atol=atol, max_steps=400_000),
        lin_solver=ls_ref)
    sol = ivp.integrate(
        ivp.IVP(jac_sparsity=pattern, **port_prob), 0.0, tf, "ensemble_bdf",
        opts=ODEOptions(rtol=rtol, atol=atol, max_steps=400_000),
        lin_solver=ls_port, ctx=Context(), device="cpu")
    return ref, sol


def _report(ref, sol):
    def val(x):
        return None if x is None else int(np.asarray(x))

    return ", ".join(
        f"{k} ref {val(getattr(ref, k))} port {val(getattr(sol, k))}"
        for k in ("nni", "nli", "npsolves", "npsetups", "workspace_bytes"))


def _agree(ref, sol, C, rtol, atol):
    report = _report(ref, sol)
    assert np.array_equal(sol.ok.numpy(), np.asarray(ref.ok)), report
    assert np.array_equal(sol.retcodes.numpy(), np.asarray(ref.retcodes))
    assert bool(sol.ok.all()), report
    y_ref = np.asarray(ref.y)
    bound = C * (rtol * np.abs(y_ref) + atol)
    ratio = float((np.abs(sol.y.numpy() - y_ref) / bound).max())
    assert ratio <= 1.0, f"y off by {ratio} of the bound; {report}"
    assert sol.workspace_bytes == ref.workspace_bytes, report
    assert sol.lin_solver == ref.lin_solver
    return report


@pytest.mark.parametrize("kind", ["sparse_gj", "spgmr_bj3"])
def test_robertson_sparse_solvers_match_reference(kind):
    """EnsembleSparseGJ and SPGMR + BlockJacobiPrecond(3) over the
    Robertson pattern, 24 systems."""
    rtol, atol = 1e-9, 1e-13
    ref_prob, port_prob = _robertson(24)
    ref, sol = _run_both(ref_prob, port_prob, ROBERTSON_PATTERN, kind, 10.0,
                         rtol, atol)
    _agree(ref, sol, 10 if kind == "sparse_gj" else 100, rtol, atol)
    if kind == "sparse_gj":
        assert int(sol.nli) == 0 and int(sol.npsolves) == 0
        assert sol.npsetups is None
    else:
        # block size == system size: the preconditioner is the exact
        # inverse, ~1 inner iteration per Newton solve (the reference's
        # own check)
        assert 0 < int(sol.nli) <= 1.05 * int(sol.nni)
        assert int(sol.npsolves) > 0
        assert int(sol.npsetups) == int(sol.stats.nsetups.sum()) > 0


def test_robertson_dense_krylov_path_matches_reference():
    """SPGMR + BlockJacobiPrecond(3) without a pattern: the dense
    Krylov path (block-diagonal SpMV matvec, dense psetup)."""
    rtol, atol = 1e-7, 1e-12
    ref_prob, port_prob = _robertson(12, seed=4)
    ref, sol = _run_both(ref_prob, port_prob, None, "spgmr_bj3", 10.0, rtol,
                         atol)
    _agree(ref, sol, 100, rtol, atol)
    assert 0 < int(sol.nli) <= 1.05 * int(sol.nni)


@pytest.mark.parametrize("kind", ["spgmr_bj2", "spgmr_ilu0", "spbcgs_ilu0",
                                  "spfgmr_ilu0", "sptfqmr_bj2"])
def test_brusselator_krylov_matches_reference(kind):
    """Preconditioned Krylov solvers over the banded Brusselator pattern
    (a bare ILU0Precond picks the pattern up from jac_sparsity)."""
    rtol, atol = 1e-5, 1e-8
    ref_prob, port_prob, P = _brusselator(6, 8)
    ref, sol = _run_both(ref_prob, port_prob, P, kind, 0.3, rtol, atol)
    report = _agree(ref, sol, 100, rtol, atol)
    assert int(sol.nli) > 0 and int(sol.npsolves) > 0, report
    assert int(sol.npsetups) == int(sol.stats.nsetups.sum()) > 0


def test_pcg_jacobi_matches_reference():
    """PCG with the point-Jacobi preconditioner over the Brusselator
    pattern (the Newton matrix is not symmetric: both packages run the
    same inexact Newton-CG and agree on where it gets)."""
    rtol, atol = 1e-5, 1e-8
    ref_prob, port_prob, P = _brusselator(4, 4)
    ref, sol = _run_both(ref_prob, port_prob, P, "pcg_jacobi", 0.1, rtol,
                         atol)
    _agree(ref, sol, 100, rtol, atol)
    assert int(sol.npsolves) > 0


def test_partial_lsetup_merges_every_leaf():
    """A lane that needs no lsetup keeps every leaf of its saved
    (Jacobian values, psetup product) object."""
    need = torch.tensor([True, False, True])
    new = (torch.ones(4, 3), (torch.full((2, 2, 3), 2.0),))
    old = (torch.zeros(4, 3), (torch.full((2, 2, 3), -1.0),))
    out = batched._merge(need, new, old)
    assert torch.equal(out[0][:, 1], torch.zeros(4))
    assert torch.equal(out[1][0][..., 1], torch.full((2, 2), -1.0))
    assert torch.equal(out[1][0][..., 0], torch.full((2, 2), 2.0))


def test_krylov_loops_are_counted():
    ref_prob, port_prob, P = _brusselator(3, 4)
    batched.reset_loop_counts()
    ivp.integrate(ivp.IVP(jac_sparsity=P, **port_prob), 0.0, 0.05,
                  "ensemble_bdf", opts=ODEOptions(rtol=1e-5, atol=1e-8),
                  lin_solver=_solvers("spbcgs_ilu0")[1], device="cpu")
    c = dict(batched.loop_counts)
    # one read per step trip, per lsetup decision, per Newton trip and
    # per Krylov trip (plus the Newton loop's exits by convergence)
    assert c["krylov_trips"] > c["newton_trips"] > 0
    assert c["host_syncs"] >= 2 * c["step_trips"] + c["newton_trips"] \
        + c["krylov_trips"]


def test_scalar_surfaces_wait_for_the_scalar_stack():
    # the scalar surfaces exist now: a preconditioner object binds to a
    # scalar Krylov solver, and its scalar psetup wants the user's
    # jac_diag / jac, as the reference's; the ensemble-only solver
    # refuses the scalar surface, as the reference's does
    assert callable(linsol.SPGMR().bind(lambda t, y: y))
    assert callable(linsol.SPGMR(precond=precond.JacobiPrecond())
                    .bind(lambda t, y: y))
    with pytest.raises(NotImplementedError, match="ensemble"):
        linsol.EnsembleSparseGJ().bind(lambda t, y: y)
    with pytest.raises(ValueError, match="jac_diag"):
        precond.JacobiPrecond().psetup(0.0, None, 1.0)
    with pytest.raises(ValueError, match="jac="):
        precond.BlockJacobiPrecond(2).psetup(0.0, None, 1.0)
    y = torch.tensor([1.0, 2.0], dtype=torch.float64)
    pdata = precond.JacobiPrecond(jac_diag=lambda t, y: -y).psetup(0.0, y, 0.5)
    assert torch.equal(pdata, 1.0 / (1.0 + 0.5 * y))
    with pytest.raises(ValueError, match="sparsity"):
        linsol.EnsembleSparseGJ().soa_carry_init(3, 4, torch.float64, "cpu")
