"""The port's ensemble DIRK, ensemble ERK and ``BlockDiagGJ(
factor_once=False)`` against the JAX reference, and the data they share.

The port runs its plain PyTorch versions on the CPU; the reference runs
its default jnp policy; both in float64 on the same inputs (Robertson
rates drawn with numpy, the Brusselator's deterministic data).  Held to
the bound the reference's own ``tests/test_integrators.py:235-263``
uses between its two backends: every lane succeeds with equal retcodes,
and y lies within ``100*(rtol*|y|+atol)``.  Per-lane counters are put
side by side in the failure report; the two packages take step
decisions on values that may differ in their last ulps, so the
counters are reported, not required equal.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import batched as rbatched
from repro.core import butcher as rbutcher
from repro.core import ivp as rivp
from repro.core import linsol as rlinsol
from repro.core import problems as rprob
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch import interop, kernels
from repro_torch.core import batched, butcher, ivp, linsol, problems
from repro_torch.core.arkode import ODEOptions

RTOL, ATOL = 1e-5, 1e-10
BOUND = 100


def _report(ref, sol):
    lines = []
    for k in ("steps", "attempts", "nni", "netf"):
        a = np.asarray(getattr(ref.stats, k))
        b = getattr(sol.stats, k).numpy()
        d = b - a
        lines.append(f"{k}: ref sum {a.sum()} port sum {b.sum()} per-lane "
                     f"diff min {d.min()} max {d.max()}")
    return "\n".join(lines)


def _agree(ref, sol):
    report = _report(ref, sol)
    assert bool(np.asarray(ref.success)) and bool(sol.success), report
    if ref.retcodes is not None:
        assert np.array_equal(sol.retcodes.numpy(), np.asarray(ref.retcodes))
        assert bool(sol.ok.all())
    y_ref = np.asarray(ref.y)
    bound = BOUND * (RTOL * np.abs(y_ref) + ATOL)
    assert np.all(np.abs(sol.y.numpy() - y_ref) <= bound), report
    assert sol.lin_solver == ref.lin_solver
    assert sol.nonlin_solver == ref.nonlin_solver


def _robertson(nsys, seed=0):
    rates = problems.robertson_rates(nsys, seed=seed)
    F, J, _, _ = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    y0 = jnp.concatenate([jnp.ones((nsys, 1)), jnp.zeros((nsys, 2))], axis=1)
    ref = rivp.IVP(f=lambda t, y: F(t, y, p), jac=lambda t, y: J(t, y, p),
                   y0=y0)
    f, jac, y0_t = problems.batched_robertson(nsys, rates=rates,
                                              device="cpu")
    f_soa, jac_soa = problems.batched_robertson_soa(nsys, rates=rates,
                                                    device="cpu")
    port = ivp.IVP(f=f, jac=jac, y0=y0_t, f_soa=f_soa, jac_soa=jac_soa)
    return ref, port


@pytest.mark.parametrize("nsys", [130, 512])
def test_ensemble_dirk_matches_reference(nsys):
    ref_prob, port_prob = _robertson(nsys)
    ref = rivp.integrate(ref_prob, 0.0, 10.0, "ensemble_dirk:sdirk2",
                         opts=RefOptions(rtol=RTOL, atol=ATOL))
    sol = ivp.integrate(port_prob, 0.0, 10.0, "ensemble_dirk:sdirk2",
                        opts=ODEOptions(rtol=RTOL, atol=ATOL), device="cpu")
    _agree(ref, sol)
    for k in ("steps", "attempts", "netf", "nni", "retcodes"):
        assert getattr(sol.stats, k).dtype == torch.int32, k
    assert sol.nli is None and sol.nsetups is None


def test_ensemble_dirk_esdirk3_explicit_first_stage():
    """ark324_esdirk (alias esdirk3) has an explicit first stage
    (a_00 = 0), the branch sdirk2 never takes."""
    ref_prob, port_prob = _robertson(64, seed=4)
    ref = rivp.integrate(ref_prob, 0.0, 1.0, "ensemble_dirk:esdirk3",
                         opts=RefOptions(rtol=RTOL, atol=ATOL))
    sol = ivp.integrate(port_prob, 0.0, 1.0, "ensemble_dirk:esdirk3",
                        opts=ODEOptions(rtol=RTOL, atol=ATOL), device="cpu")
    _agree(ref, sol)


def test_ensemble_dirk_aos_callables_match_native_soa():
    nsys = 40
    rates = problems.robertson_rates(nsys, seed=2)
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    _, port_prob = _robertson(nsys, seed=2)
    opts = ODEOptions(rtol=RTOL, atol=ATOL)
    aos = ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, 10.0,
                        "ensemble_dirk", opts=opts, device="cpu")
    soa = ivp.integrate(port_prob, 0.0, 10.0, "ensemble_dirk", opts=opts,
                        device="cpu")
    assert torch.equal(aos.y, soa.y)
    assert torch.equal(aos.stats.nni, soa.stats.nni)


def test_ensemble_dirk_h0_newton_iters_and_loop_counts():
    """opts.h0 seeds the step and newton_iters sets the stage Newton
    depth, as in the reference; the step loop syncs once a trip and the
    stage Newton never."""
    nsys = 16
    ref_prob, port_prob = _robertson(nsys, seed=5)
    kw = dict(rtol=RTOL, atol=ATOL, h0=1e-4)
    ref = rivp.integrate(ref_prob, 0.0, 1.0, "ensemble_dirk:sdirk2",
                         opts=RefOptions(**kw), newton_iters=3)
    batched.reset_loop_counts()
    sol = ivp.integrate(port_prob, 0.0, 1.0, "ensemble_dirk:sdirk2",
                        opts=ODEOptions(**kw), device="cpu", newton_iters=3)
    c = dict(batched.loop_counts)
    _agree(ref, sol)
    assert c["host_syncs"] == c["step_trips"] + 1
    assert c["step_trips"] == int(sol.stats.attempts.max())
    assert c["newton_trips"] == 2 * 3 * c["step_trips"]
    assert torch.equal(sol.stats.nni, 2 * 3 * sol.stats.attempts)


def _brusselator(nsys, nx):
    F, J, P, Y0 = rprob.ensemble_brusselator(nsys, nx=nx)
    f, jac, P_t, y0 = problems.ensemble_brusselator(nsys, nx=nx,
                                                    device="cpu")
    assert np.array_equal(P, P_t)
    return rivp.IVP(f=F, jac=J, y0=Y0), ivp.IVP(f=f, jac=jac, y0=y0)


def test_bdf_factor_once_false_matches_reference():
    """n = b = 16 takes the tiled plain solve every Newton iteration."""
    ref_prob, port_prob = _brusselator(8, nx=8)
    ref = rivp.integrate(ref_prob, 0.0, 0.5, "ensemble_bdf",
                         opts=RefOptions(rtol=RTOL, atol=ATOL),
                         lin_solver=rlinsol.BlockDiagGJ(factor_once=False))
    kernels.reset_counts()
    sol = ivp.integrate(port_prob, 0.0, 0.5, "ensemble_bdf",
                        opts=ODEOptions(rtol=RTOL, atol=ATOL), device="cpu",
                        lin_solver=linsol.BlockDiagGJ(factor_once=False))
    c = kernels.counts()
    _agree(ref, sol)
    # one tiled solve per Newton trip, no inverse and no SpMV
    assert c["block_solve_tiled"][1] > 0
    assert c["block_inverse_tiled"] == c["blockdiag_spmv"] == (0, 0)


def test_bdf_factor_once_true_matches_reference():
    """The default BlockDiagGJ() at n = b = 16: each lsetup inverts the
    Newton blocks (the tiled inverse) and each Newton iteration is one
    block-diagonal SpMV against the saved inverse."""
    ref_prob, port_prob = _brusselator(8, nx=8)
    ref = rivp.integrate(ref_prob, 0.0, 0.5, "ensemble_bdf",
                         opts=RefOptions(rtol=RTOL, atol=ATOL),
                         lin_solver=rlinsol.BlockDiagGJ())
    kernels.reset_counts()
    sol = ivp.integrate(port_prob, 0.0, 0.5, "ensemble_bdf",
                        opts=ODEOptions(rtol=RTOL, atol=ATOL), device="cpu",
                        lin_solver=linsol.BlockDiagGJ())
    c = kernels.counts()
    _agree(ref, sol)
    y_ref = np.asarray(ref.y)
    assert np.all(np.abs(sol.y.numpy() - y_ref)
                  <= 10 * (RTOL * np.abs(y_ref) + ATOL)), _report(ref, sol)
    assert c["block_inverse_tiled"][1] > 0 and c["blockdiag_spmv"][1] > 0
    assert c["block_solve_tiled"] == (0, 0)


def test_bdf_factor_once_false_agrees_with_factor_once():
    """Both lsolves of BlockDiagGJ integrate the same problem within the
    controller's bound (the saved inverse lags gamma by up to dgmax)."""
    _, port_prob = _brusselator(8, nx=8)
    opts = ODEOptions(rtol=RTOL, atol=ATOL)
    a = ivp.integrate(port_prob, 0.0, 0.5, "ensemble_bdf", opts=opts,
                      device="cpu")
    b = ivp.integrate(port_prob, 0.0, 0.5, "ensemble_bdf", opts=opts,
                      device="cpu",
                      lin_solver=linsol.BlockDiagGJ(factor_once=False))
    assert bool(a.ok.all()) and bool(b.ok.all())
    bound = BOUND * (RTOL * a.y.abs() + ATOL)
    assert bool(((a.y - b.y).abs() <= bound).all())


def test_ensemble_erk_per_system_adaptivity():
    """The reference's ``test_ensemble_erk_per_system_adaptivity`` case
    through both packages."""
    rates = np.linspace(0.5, 3.0, 8)
    opts = dict(rtol=1e-7, atol=1e-10)
    r_rates = jnp.asarray(rates)
    y_ref, st_ref = rbatched.ensemble_erk_integrate(
        lambda t, y: -r_rates[:, None] * y, jnp.ones((8, 4)), 0.0, 1.5,
        rbutcher.BOGACKI_SHAMPINE, RefOptions(**opts))
    t_rates = torch.from_numpy(rates)
    y, st = batched.ensemble_erk_integrate(
        lambda t, y: -t_rates[:, None] * y,
        torch.ones((8, 4), dtype=torch.float64), 0.0, 1.5,
        butcher.BOGACKI_SHAMPINE, ODEOptions(**opts))
    exact = np.broadcast_to(np.exp(-rates * 1.5)[:, None], (8, 4))
    assert bool(st.success.all())
    np.testing.assert_allclose(y.numpy(), exact, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=BOUND * 1e-7)
    steps = st.steps.numpy()
    assert steps[-1] > steps[0]
    assert np.asarray(st_ref.steps)[-1] > np.asarray(st_ref.steps)[0]


def test_ensemble_erk_on_brusselator_matches_reference():
    ref_prob, port_prob = _brusselator(64, nx=16)
    ref = rivp.integrate(ref_prob, 0.0, 2.0, "ensemble_erk:bogacki_shampine",
                         opts=RefOptions(rtol=RTOL, atol=ATOL))
    sol = ivp.integrate(port_prob, 0.0, 2.0, "ensemble_erk:bogacki_shampine",
                        opts=ODEOptions(rtol=RTOL, atol=ATOL), device="cpu")
    _agree(ref, sol)
    assert sol.retcodes is None and ref.retcodes is None


def test_ensemble_erk_without_embedding_is_fixed_step():
    """euler has no embedded weights: h0 is the fixed step."""
    rates = np.linspace(0.5, 3.0, 4)
    opts = dict(h0=0.01)
    y_ref, st_ref = rbatched.ensemble_erk_integrate(
        lambda t, y: -jnp.asarray(rates)[:, None] * y, jnp.ones((4, 2)), 0.0,
        0.5, rbutcher.EULER, RefOptions(**opts))
    t_rates = torch.from_numpy(rates)
    y, st = batched.ensemble_erk_integrate(
        lambda t, y: -t_rates[:, None] * y,
        torch.ones((4, 2), dtype=torch.float64), 0.0, 0.5, butcher.EULER,
        ODEOptions(**opts))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-12)
    assert torch.all(st.steps == 50) and np.all(np.asarray(st_ref.steps) == 50)


@pytest.mark.parametrize("nsys,nx", [(8, 8), (5, 16), (3, 1)])
def test_brusselator_f_and_jac_match_reference(nsys, nx):
    """The port's analytic Jacobian against the reference's jacfwd, and
    the SoA pair against the batched forms, at 1e-12."""
    F, J, _, Y0 = rprob.ensemble_brusselator(nsys, nx=nx)
    f, jac, _, y0 = problems.ensemble_brusselator(nsys, nx=nx, device="cpu")
    f_soa, jac_soa = problems.ensemble_brusselator_soa(nsys, nx=nx,
                                                       device="cpu")
    np.testing.assert_allclose(y0.numpy(), np.asarray(Y0), rtol=0,
                               atol=1e-12)
    rng = np.random.default_rng(nsys * 100 + nx)
    y = np.asarray(Y0) + 0.3 * rng.normal(size=Y0.shape)
    t = np.zeros(nsys)
    f_ref = np.asarray(F(jnp.asarray(t), jnp.asarray(y)))
    j_ref = np.asarray(J(jnp.asarray(t), jnp.asarray(y)))
    yt, tt = torch.from_numpy(y), torch.from_numpy(t)
    for got, want in ((f(tt, yt), f_ref), (jac(tt, yt), j_ref),
                      (f_soa(tt, yt.T.contiguous()).T, f_ref),
                      (jac_soa(tt, yt.T.contiguous()).permute(2, 0, 1),
                       j_ref)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(want).max()))


def _tables():
    out = []
    for group in ("ERK_TABLES", "DIRK_TABLES"):
        for name in getattr(rbutcher, group):
            out.append((group, name))
    return out


@pytest.mark.parametrize("group,name", _tables())
def test_butcher_tables_equal_reference_bitwise(group, name):
    ref = getattr(rbutcher, group)[name]
    port = getattr(butcher, group)[name]
    assert type(port).__name__ == "ButcherTable"
    assert port == ref                     # every float, bit for bit
    assert (port.stages, port.explicit, list(port.diag)) == \
        (ref.stages, ref.explicit, list(ref.diag))
    back = interop.table_from_reference(ref._asdict())
    assert back == port
    for row_a, row_b in zip(back.A, ref.A):
        assert all(math.copysign(1, x) == math.copysign(1, y) and
                   float(x).hex() == float(y).hex()
                   for x, y in zip(row_a, row_b))


def test_imex_tables_equal_reference():
    assert set(butcher.IMEX_TABLES) == set(rbutcher.IMEX_TABLES)
    for name, ref in rbutcher.IMEX_TABLES.items():
        port = butcher.IMEX_TABLES[name]
        assert (port.expl, port.impl, port.order, port.emb_order) == \
            (ref.expl, ref.impl, ref.order, ref.emb_order)


def test_method_strings_and_aliases():
    assert set(ivp.METHOD_STRINGS) <= set(rivp.METHOD_STRINGS)
    for var in (None, "dopri5", "bs32", "heun", "euler"):
        assert ivp._erk_table(var) == rivp._erk_table(var)
    for var in (None, "sdirk2", "sdirk33", "esdirk3", "implicit_euler"):
        assert ivp._dirk_table(var) == rivp._dirk_table(var)
    _, port_prob = _robertson(4)
    with pytest.raises(ValueError, match="takes no lin_solver"):
        ivp.integrate(port_prob, 0.0, 1.0, "ensemble_dirk", device="cpu",
                      lin_solver=linsol.BlockDiagGJ())
    with pytest.raises(ValueError, match="takes no"):
        ivp.integrate(port_prob, 0.0, 1.0, "ensemble_erk", device="cpu",
                      newton_iters=3)
