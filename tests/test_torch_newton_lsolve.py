"""The port's fused Newton iteration ``newton_residual_lsolve_soa``
against the JAX reference, on the CPU.

The op is the port's own: the reference's BDF Newton iteration is the
residual (``newton_residual_soa``), the SpMV of the saved inverse
(``blockdiag_spmv_soa``) and CVODE's correction ``2/(1+gamrat)``, which
its jitted step leaves to XLA to fuse.  Here the plain version (what a
CPU tensor runs) is held to that composition of the reference's
``repro.kernels.ref`` oracles, and ``ensemble_bdf_integrate`` with
``BlockDiagGJ()``, which now takes the op at b <= 8, to the reference's
solver.  Inputs are numpy-seeded, float64; tolerances as in
``tests/test_torch_kernels.py`` (1e-10) and the ensemble tests (10 *
(rtol*|y| + atol)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import batched as ref_batched
from repro.core import problems as rprob
from repro.core.arkode import ODEOptions as RefOptions
from repro.kernels import ref as kref
from repro_torch import kernels
from repro_torch.core import batched, dispatch as dv, problems
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.linsol import BlockDiagGJ
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import newton

RTOL, ATOL = 1e-5, 1e-10
CPU = ExecPolicy(device="cpu")


def _inputs(b, nb, seed=0):
    """z, f, psi (b, nb), gamma (nb,) > 0, gamrat (nb,) around 1 (the
    drift a step may carry since lsetup) and Minv (b, b, nb): the
    inverse of a diagonally dominant block."""
    rng = np.random.default_rng(seed + 97 * b + nb)
    z, f, psi = (rng.normal(size=(b, nb)) for _ in range(3))
    gam = np.abs(rng.normal(size=nb)) + 0.01
    gamrat = rng.uniform(0.7, 1.3, size=nb)
    M = rng.normal(size=(b, b, nb)) + b * np.eye(b)[:, :, None]
    Minv = np.linalg.inv(M.transpose(2, 0, 1)).transpose(1, 2, 0).copy()
    return z, f, psi, gam, gamrat, Minv


def _reference_iteration(z, f, psi, gam, gamrat, Minv):
    rhs = kref.newton_residual_soa_ref(*map(jnp.asarray, (z, f, psi, gam)),
                                       negate=True)
    y = kref.blockdiag_spmv_soa_ref(jnp.asarray(Minv), rhs)
    return np.asarray((2.0 / (1.0 + jnp.asarray(gamrat)))[None, :] * y)


@pytest.mark.parametrize("nb", [130, 516])
@pytest.mark.parametrize("b", range(1, 9))
def test_plain_version_matches_the_reference_composition(b, nb):
    args = _inputs(b, nb)
    kernels.reset_counts()
    port = newton.newton_residual_lsolve_plain(*map(torch.from_numpy, args))
    assert kernels.counts()["newton_residual_lsolve"] == (0, 1)
    want = _reference_iteration(*args)
    scale = max(1.0, np.abs(want).max())
    assert port.dtype == torch.float64 and port.shape == (b, nb)
    assert np.abs(port.numpy() - want).max() <= 1e-10 * scale
    # and, bit for bit, the port's own two ops and the plain correction
    z, f, psi, gam, gamrat, Minv = map(torch.from_numpy, args)
    two = (2.0 / (1.0 + gamrat))[None, :] * dv.blockdiag_spmv_soa(
        Minv, dv.newton_residual_soa(z, f, psi, gam, CPU, negate=True), CPU)
    assert torch.equal(port, two)


def test_the_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = tuple(map(torch.from_numpy, _inputs(3, 130)))
    kernels.reset_counts()
    got = newton.newton_residual_lsolve(*args)
    assert kernels.counts()["newton_residual_lsolve"] == (0, 1)
    assert torch.equal(got, newton.newton_residual_lsolve_plain(*args))
    with pytest.raises(ValueError, match="backend 'cuda'"):
        dv.newton_residual_lsolve_soa(*args, ExecPolicy(backend="cuda"))


#: policy -> whether BlockDiagGJ() takes the fused op: the default and a
#: pin of the op itself do, a pin of either composed op does not; a pin
#: of another op changes nothing
ROUTES = {
    "default": (CPU, True),
    "torch backend": (ExecPolicy(device="cpu", backend="torch"), True),
    "fused pinned": (CPU.override(newton_residual_lsolve_soa="torch"), True),
    "residual pinned": (CPU.override(newton_residual_soa="torch"), False),
    "spmv pinned": (CPU.override(blockdiag_spmv_soa="torch"), False),
    "both pinned": (CPU.override(newton_residual_soa="torch",
                                 blockdiag_spmv_soa="torch"), False),
    "other pin": (CPU.override(wrms_soa="torch"), True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_soa_residual_solve_routes(route):
    policy, fused = ROUTES[route]
    z, f, psi, gam, gamrat, Minv = map(torch.from_numpy, _inputs(6, 130))
    kernels.reset_counts()
    dz, nli, nps = BlockDiagGJ().soa_residual_solve(Minv, gam, gamrat, z, f,
                                                    psi, policy)
    c = kernels.counts()
    assert (nli, nps) == (0, 0)
    if fused:
        assert c["newton_residual_lsolve"] == (0, 1)
        assert c["newton_residual"] == c["blockdiag_spmv"] == (0, 0)
    else:
        assert c["newton_residual_lsolve"] == (0, 0)
        assert c["newton_residual"] == c["blockdiag_spmv"] == (0, 1)
    assert torch.equal(dz, newton.newton_residual_lsolve_plain(
        z, f, psi, gam, gamrat, Minv))


@pytest.mark.parametrize("op", BlockDiagGJ.COMPOSED_OPS)
def test_a_cuda_pin_of_a_composed_op_reaches_it(op):
    """Under ``backend="torch"`` a pin of either composed op to "cuda"
    keeps the two ops, so the pin reaches its op: on CPU tensors the
    "cuda" backend refuses them (the fused op's plain version would have
    run instead)."""
    z, f, psi, gam, gamrat, Minv = map(torch.from_numpy, _inputs(6, 130))
    policy = ExecPolicy(device="cpu", backend="torch").override(**{op: "cuda"})
    with pytest.raises(ValueError, match=f"{op}: backend 'cuda'"):
        BlockDiagGJ().soa_residual_solve(Minv, gam, gamrat, z, f, psi, policy)


def test_wide_blocks_and_factor_once_false_keep_the_two_ops():
    """b = 9 (past the fused body) through the residual and the SpMV;
    ``factor_once=False`` through the residual and the block solve."""
    z, f, psi, gam, gamrat, Minv = map(torch.from_numpy, _inputs(9, 130))
    kernels.reset_counts()
    dz, _, _ = BlockDiagGJ().soa_residual_solve(Minv, gam, gamrat, z, f, psi,
                                                CPU)
    c = kernels.counts()
    assert c["newton_residual_lsolve"] == (0, 0)
    assert c["newton_residual"] == c["blockdiag_spmv"] == (0, 1)
    assert torch.equal(dz, newton.newton_residual_lsolve_plain(
        z, f, psi, gam, gamrat, Minv))
    z, f, psi, gam, gamrat, Minv = map(torch.from_numpy, _inputs(3, 130))
    M = torch.linalg.inv(Minv.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    kernels.reset_counts()
    BlockDiagGJ(factor_once=False).soa_residual_solve(M, gam, gamrat, z, f,
                                                      psi, CPU)
    c = kernels.counts()
    assert c["newton_residual_lsolve"] == (0, 0)
    assert c["newton_residual"] == c["block_solve"] == (0, 1)


def _robertson(nsys):
    rates = problems.robertson_rates(nsys, seed=0)
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    F, J, _, _ = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    return (f, jac, y0), (lambda t, y: F(t, y, p), lambda t, y: J(t, y, p),
                          jnp.asarray(y0.numpy()))


def _decay_chain(nsys, n):
    # the serving tier's decay-chain rates (chip_smoke.py path M: numpy
    # seed 1, U(0.1, 5))
    k = np.random.default_rng(1).uniform(0.1, 5.0, size=(nsys, n))
    y0 = np.zeros((nsys, n))
    y0[:, 0] = 1.0
    f, jac, _, _ = problems.decay_chain_family(n)
    F, J, _, _ = rprob.decay_chain_family(n)
    p, rp = {"k": torch.from_numpy(k)}, {"k": jnp.asarray(k)}
    return ((lambda t, y: f(t, y, p), lambda t, y: jac(t, y, p),
             torch.from_numpy(y0)),
            (lambda t, y: F(t, y, rp), lambda t, y: J(t, y, rp),
             jnp.asarray(y0)))


@pytest.mark.parametrize("case", ["robertson", "decay6", "decay8"])
def test_ensemble_bdf_takes_the_fused_op_and_matches_the_reference(case):
    """Robertson (b = 3) to t = 10 and decay chains (b = 6, 8) to t = 5,
    64 systems: the fused Newton iteration's plain version (the whole
    iteration, ``newton_update_soa``, which holds this op) runs once a
    Newton trip and no composed op runs; y within 10*(rtol*|y|+atol) of the
    reference's ``ensemble_bdf_integrate``, success masks and retcodes
    equal; bit for bit the run with the residual pinned to its plain
    version (the composition), with the same counters."""
    nsys = 64
    (f, jac, y0), (rf, rj, ry0) = _robertson(nsys) if case == "robertson" \
        else _decay_chain(nsys, int(case[-1]))
    tf = 10.0 if case == "robertson" else 5.0
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    kernels.reset_counts()
    batched.reset_loop_counts()
    y, st = batched.ensemble_bdf_integrate(f, jac, y0, 0.0, tf, opts=opts,
                                           policy=CPU)
    c = kernels.counts()
    trips = batched.loop_counts["newton_trips"]
    assert c["newton_update"] == (0, trips) and trips > 0
    assert c["newton_residual_lsolve"] == c["masked_update_wrms"] == (0, 0)
    assert c["newton_residual"] == c["blockdiag_spmv"] == (0, 0)
    y_ref, st_ref = ref_batched.ensemble_bdf_integrate(
        rf, rj, ry0, 0.0, tf, opts=RefOptions(rtol=RTOL, atol=ATOL,
                                              max_steps=100_000))
    y_ref = np.asarray(y_ref)
    assert np.all(np.abs(y.numpy() - y_ref) <= 10 * (RTOL * np.abs(y_ref)
                                                     + ATOL))
    np.testing.assert_array_equal(st.success.numpy(),
                                  np.asarray(st_ref.success))
    np.testing.assert_array_equal(st.retcodes.numpy(),
                                  np.asarray(st_ref.retcodes))
    loops = dict(batched.loop_counts)
    batched.reset_loop_counts()
    y2, st2 = batched.ensemble_bdf_integrate(
        f, jac, y0, 0.0, tf, opts=opts,
        policy=CPU.override(newton_residual_soa="torch"))
    assert dict(batched.loop_counts) == loops
    assert torch.equal(y, y2)
    for name, a, b in zip(st._fields, st, st2):
        assert (a is None and b is None) or torch.equal(a, b), name


def _exact_decay(k, y0, t):
    """The decay chain's exact solution ``expm(t J) y0`` per system (J
    lower bidiagonal, -k on the diagonal)."""
    from scipy.linalg import expm
    return np.stack([expm(t * (np.diag(-ks) + np.diag(ks[:-1], -1))) @ y
                     for ks, y in zip(k, y0)])


@pytest.mark.parametrize("seed", [2, 8])
def test_ensemble_bdf_on_wide_rates_is_as_accurate_as_the_reference(seed):
    """Decay chains at n = 8 with rates 10^U(-1, 2), 64 systems, to
    t = 5: the two codes' step decisions part on last-ulp differences
    there (seed 8: one lane lies 1.99x the 10*(rtol*|y|+atol) gate from
    the reference's), so each is held to the exact solution instead.
    The port's global error (each lane's WRMS over rtol*|y_exact|+atol,
    their mean; and its largest component) is within 10 % of the
    reference's, whose largest errors lie 2.7x (seed 2) and 4.3x (seed 8)
    that gate from the exact solution (``tools/decay_chain_witness.py``);
    success and retcodes equal; the fused Newton iteration taken and bit
    for bit the pinned two-op run."""
    n, nsys, tf = 8, 64, 5.0
    k = 10.0 ** np.random.default_rng(seed).uniform(-1.0, 2.0, size=(nsys, n))
    y0 = np.zeros((nsys, n))
    y0[:, 0] = 1.0
    f, jac, _, _ = problems.decay_chain_family(n)
    F, J, _, _ = rprob.decay_chain_family(n)
    p, rp = {"k": torch.from_numpy(k)}, {"k": jnp.asarray(k)}
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)

    def port(policy):
        return batched.ensemble_bdf_integrate(
            lambda t, y: f(t, y, p), lambda t, y: jac(t, y, p),
            torch.from_numpy(y0), 0.0, tf, opts=opts, policy=policy)

    kernels.reset_counts()
    batched.reset_loop_counts()
    y, st = port(CPU)
    c = kernels.counts()
    trips = batched.loop_counts["newton_trips"]
    assert c["newton_update"] == (0, trips) and trips > 0
    assert c["newton_residual_lsolve"] == c["masked_update_wrms"] == (0, 0)
    assert c["newton_residual"] == c["blockdiag_spmv"] == (0, 0)
    y_ref, st_ref = ref_batched.ensemble_bdf_integrate(
        lambda t, y: F(t, y, rp), lambda t, y: J(t, y, rp), jnp.asarray(y0),
        0.0, tf, opts=RefOptions(rtol=RTOL, atol=ATOL, max_steps=100_000))
    np.testing.assert_array_equal(st.success.numpy(),
                                  np.asarray(st_ref.success))
    np.testing.assert_array_equal(st.retcodes.numpy(),
                                  np.asarray(st_ref.retcodes))
    exact = _exact_decay(k, y0, tf)
    w = 1.0 / (RTOL * np.abs(exact) + ATOL)
    err = {name: (v - exact) * w
           for name, v in (("port", y.numpy()), ("ref", np.asarray(y_ref)))}
    lane = {name: np.sqrt(np.mean(e ** 2, axis=1)).mean()
            for name, e in err.items()}
    worst = {name: np.abs(e).max() for name, e in err.items()}
    assert lane["port"] <= 1.1 * lane["ref"], lane
    assert worst["port"] <= 1.1 * worst["ref"], worst
    y2, st2 = port(CPU.override(newton_residual_soa="torch"))
    assert torch.equal(y, y2)
    for name, a, b in zip(st._fields, st, st2):
        assert (a is None and b is None) or torch.equal(a, b), name


def test_path_k_block_size_never_takes_the_fused_op():
    """``BlockDiagGJ()`` on the Brusselator ensemble (n = b = 32, path
    K's shape): the residual and the b = 32 SpMV every Newton trip."""
    f, jac, _, y0 = problems.ensemble_brusselator(4, nx=16, device="cpu")
    kernels.reset_counts()
    batched.reset_loop_counts()
    y, st = batched.ensemble_bdf_integrate(
        f, jac, y0, 0.0, 0.5, opts=ODEOptions(rtol=RTOL, atol=ATOL),
        policy=CPU)
    c = kernels.counts()
    trips = batched.loop_counts["newton_trips"]
    assert trips > 0 and bool(st.success.all())
    assert c["newton_residual_lsolve"] == (0, 0)
    assert c["newton_residual"] == c["blockdiag_spmv"] == (0, trips)
