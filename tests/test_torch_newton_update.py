"""The port's whole Newton iteration ``newton_update_soa`` and its lsetup
``newton_block_inverse_soa`` against the JAX reference, on the CPU.

Both ops are the port's own.  The reference's BDF Newton iteration is
the residual (``newton_residual_soa``), the SpMV of the saved inverse
(``blockdiag_spmv_soa``), CVODE's correction ``2/(1+gamrat)`` and the
masked update with its correction norm (``masked_update_wrms_soa``); its
lsetup forms the Newton blocks (``newton_blocks_soa``) and inverts them
(``block_inverse_soa``).  Here each plain version (what a CPU tensor
runs) is held bit for bit to the port's own composition and to the
reference's, its ops run as the reference's tests run them here (the
Pallas kernels in interpret mode), within 1e-10; ``ensemble_bdf_integrate``
with ``BlockDiagGJ()``, which takes both ops at b <= 8, to the
reference's solver within 10 * (rtol*|y| + atol).  Inputs are
numpy-seeded, float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import batched as ref_batched
from repro.core import dispatch as rdv
from repro.core import linsol as rlinsol
from repro.core import problems as rprob
from repro.core.arkode import ODEOptions as RefOptions
from repro.core.policies import ExecPolicy as RefPolicy
from repro_torch import kernels
from repro_torch.core import batched, dispatch as dv, problems
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.linsol import BlockDiagGJ, newton_blocks_soa
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import block_solve, newton

RTOL, ATOL = 1e-5, 1e-10
CPU = ExecPolicy(device="cpu")
PALLAS = RefPolicy(backend="pallas", interpret=True, batch_tile=128)
NBS = (7, 130, 516)
BS = range(1, 9)
MASKS = ("all", "none", "random")


def _inputs(b, nb, mask="random", seed=0):
    """z, f, psi, w (b, nb), gamma (nb,) > 0, gamrat (nb,) around 1,
    Minv (b, b, nb) the inverse of a diagonally dominant block, the mask
    (nb,) bool, and a Jacobian J (b, b, nb) whose Newton blocks I -
    gamma*J are diagonally dominant, with a zero column (as Robertson's
    third has zeros) in every fourth system."""
    rng = np.random.default_rng(seed + 97 * b + nb)
    z, f, psi = (rng.normal(size=(b, nb)) for _ in range(3))
    w = np.abs(rng.normal(size=(b, nb))) + 0.1
    gam = np.abs(rng.normal(size=nb)) + 0.01
    gamrat = rng.uniform(0.7, 1.3, size=nb)
    M = rng.normal(size=(b, b, nb)) + b * np.eye(b)[:, :, None]
    Minv = np.linalg.inv(M.transpose(2, 0, 1)).transpose(1, 2, 0).copy()
    m = {"all": np.ones(nb, bool), "none": np.zeros(nb, bool),
         "random": rng.uniform(size=nb) > 0.4}[mask]
    J = rng.normal(size=(b, b, nb)) / (b * (gam + 1.0))
    J[:, -1, ::4] = 0.0
    return [torch.from_numpy(a) for a in (z, f, psi, gam, gamrat, Minv, w,
                                          m, J)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("b", BS)
def test_newton_update_plain_is_its_composition_bit_for_bit(b, nb, mask):
    z, f, psi, gam, gamrat, Minv, w, m, _ = _inputs(b, nb, mask)
    kernels.reset_counts()
    z_new, dn = newton.newton_update_plain(z, f, psi, gam, gamrat, Minv, w,
                                           m)
    assert kernels.counts()["newton_update"] == (0, 1)
    assert z_new.shape == (b, nb) and dn.shape == (nb,)
    dz = newton.newton_residual_lsolve_plain(z, f, psi, gam, gamrat, Minv)
    z_two, dn_two = newton.masked_update_wrms_plain(z, dz, w, m)
    assert torch.equal(z_new, z_two) and torch.equal(dn, dn_two)
    assert torch.equal(z_new[:, ~m], z[:, ~m])
    # a uint8 mask is the same mask
    z8, dn8 = newton.newton_update_plain(z, f, psi, gam, gamrat, Minv, w,
                                         m.to(torch.uint8))
    assert torch.equal(z8, z_new) and torch.equal(dn8, dn)


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("b", BS)
def test_newton_block_inverse_plain_is_its_composition_bit_for_bit(b, nb):
    _, _, _, gam, _, _, _, _, J = _inputs(b, nb)
    kernels.reset_counts()
    got = block_solve.newton_block_inverse_soa_plain(J, gam)
    assert kernels.counts()["newton_block_inverse"] == (0, 1)
    assert kernels.counts()["block_inverse"] == (0, 0)
    want = block_solve.block_inverse_soa_plain(newton_blocks_soa(J, gam))
    assert torch.equal(got, want)
    # zeros keep their sign: the blocks are formed as eye - gamma*J
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def _reference_update(z, f, psi, gam, gamrat, Minv, w, m):
    rhs = rdv.newton_residual_soa(*map(jnp.asarray, (z, f, psi, gam)),
                                  PALLAS, negate=True)
    dz = (2.0 / (1.0 + jnp.asarray(gamrat)))[None, :] * \
        rdv.blockdiag_spmv_soa(jnp.asarray(Minv), rhs, PALLAS)
    return rdv.masked_update_wrms_soa(jnp.asarray(z), dz, jnp.asarray(w),
                                      jnp.asarray(m), PALLAS)


def _close(port, ref):
    ref = np.asarray(ref)
    scale = max(1.0, np.abs(ref).max())
    assert port.dtype == torch.float64 and port.shape == ref.shape
    assert np.abs(port.numpy() - ref).max() <= 1e-10 * scale


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("b", BS)
def test_newton_update_matches_the_reference_composition(b, mask):
    args = _inputs(b, 130, mask)[:8]
    for impl in (newton.newton_update_plain,
                 lambda *a: dv.newton_update_soa(*a, CPU)):
        z_new, dn = impl(*args)
        z_ref, dn_ref = _reference_update(*(a.numpy() for a in args))
        _close(z_new, z_ref)
        _close(dn, dn_ref)


@pytest.mark.parametrize("b", BS)
def test_newton_block_inverse_matches_the_reference_composition(b):
    _, _, _, gam, _, _, _, _, J = _inputs(b, 130)
    want = rdv.block_inverse_soa(rlinsol.newton_blocks_soa(
        jnp.asarray(J.numpy()), jnp.asarray(gam.numpy())), PALLAS)
    _close(block_solve.newton_block_inverse_soa_plain(J, gam), want)
    _close(dv.newton_block_inverse_soa(J, gam, CPU), want)


def test_the_wrappers_take_the_plain_versions_for_cpu_tensors():
    z, f, psi, gam, gamrat, Minv, w, m, J = _inputs(6, 130)
    kernels.reset_counts()
    got = newton.newton_update(z, f, psi, gam, gamrat, Minv, w, m)
    inv = block_solve.newton_block_inverse_soa(J, gam)
    c = kernels.counts()
    assert c["newton_update"] == c["newton_block_inverse"] == (0, 1)
    want = newton.newton_update_plain(z, f, psi, gam, gamrat, Minv, w, m)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert torch.equal(inv, block_solve.newton_block_inverse_soa_plain(J,
                                                                       gam))
    with pytest.raises(ValueError, match="backend 'cuda'"):
        dv.newton_update_soa(z, f, psi, gam, gamrat, Minv, w, m,
                             ExecPolicy(backend="cuda"))
    with pytest.raises(ValueError, match="backend 'cuda'"):
        dv.newton_block_inverse_soa(J, gam, ExecPolicy(backend="cuda"))


#: policy -> the ops a Newton iteration of BlockDiagGJ() takes: the fused
#: iteration by default, under a pin of itself or of an op off its path;
#: a pin of the fused lsolve or of the update keeps the fused lsolve and
#: the update; a pin of the residual or the SpMV the three ops
FUSED = ("newton_update",)
LSOLVE = ("newton_residual_lsolve", "masked_update_wrms")
THREE = ("newton_residual", "blockdiag_spmv", "masked_update_wrms")
ROUTES = {
    "default": (CPU, FUSED),
    "torch backend": (ExecPolicy(device="cpu", backend="torch"), FUSED),
    "fused pinned": (CPU.override(newton_update_soa="torch"), FUSED),
    "lsolve pinned": (CPU.override(newton_residual_lsolve_soa="torch"),
                      LSOLVE),
    "update pinned": (CPU.override(masked_update_wrms_soa="torch"), LSOLVE),
    "residual pinned": (CPU.override(newton_residual_soa="torch"), THREE),
    "spmv pinned": (CPU.override(blockdiag_spmv_soa="torch"), THREE),
    "other pin": (CPU.override(wrms_soa="torch"), FUSED),
}
NEWTON_KERNELS = set(FUSED + LSOLVE + THREE)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_soa_newton_update_routes(route):
    policy, ops = ROUTES[route]
    z, f, psi, gam, gamrat, Minv, w, m, _ = _inputs(6, 130)
    kernels.reset_counts()
    z_new, dn, nli, nps = BlockDiagGJ().soa_newton_update(
        Minv, gam, gamrat, z, f, psi, w, m, policy)
    c = kernels.counts()
    assert (nli, nps) == (0, 0)
    for name in NEWTON_KERNELS:
        assert c[name] == ((0, 1) if name in ops else (0, 0)), name
    want = newton.newton_update_plain(z, f, psi, gam, gamrat, Minv, w, m)
    assert torch.equal(z_new, want[0]) and torch.equal(dn, want[1])


#: policy -> whether BlockDiagGJ()'s lsetup takes the fused inverse
SETUP_ROUTES = {
    "default": (CPU, True),
    "torch backend": (ExecPolicy(device="cpu", backend="torch"), True),
    "fused pinned": (CPU.override(newton_block_inverse_soa="torch"), True),
    "inverse pinned": (CPU.override(block_inverse_soa="torch"), False),
    "other pin": (CPU.override(wrms_soa="torch"), True),
}


@pytest.mark.parametrize("route", sorted(SETUP_ROUTES))
def test_soa_setup_routes(route):
    policy, fused = SETUP_ROUTES[route]
    _, _, _, gam, _, _, _, _, J = _inputs(6, 130)
    kernels.reset_counts()
    got = BlockDiagGJ().soa_setup(J, gam, policy)
    c = kernels.counts()
    assert c["newton_block_inverse"] == ((0, 1) if fused else (0, 0))
    assert c["block_inverse"] == ((0, 0) if fused else (0, 1))
    assert torch.equal(got, block_solve.newton_block_inverse_soa_plain(J,
                                                                       gam))


@pytest.mark.parametrize("op", BlockDiagGJ.UPDATE_OPS + ("block_inverse_soa",))
def test_a_cuda_pin_of_a_composed_op_reaches_it(op):
    """Under ``backend="torch"`` a pin of any op of the composition to
    "cuda" keeps the composition, so the pin reaches its op: on CPU
    tensors the "cuda" backend refuses them (the fused op's plain
    version would have run instead)."""
    z, f, psi, gam, gamrat, Minv, w, m, J = _inputs(6, 130)
    policy = ExecPolicy(device="cpu", backend="torch").override(**{op: "cuda"})
    with pytest.raises(ValueError, match=f"{op}: backend 'cuda'"):
        if op == "block_inverse_soa":
            BlockDiagGJ().soa_setup(J, gam, policy)
        else:
            BlockDiagGJ().soa_newton_update(Minv, gam, gamrat, z, f, psi, w,
                                            m, policy)


def test_wide_blocks_and_factor_once_false_never_take_the_fused_ops():
    """b = 9 (past both fused bodies): lsetup by the plain blocks and the
    tiled inverse, each Newton iteration the residual, the SpMV and the
    update.  ``factor_once=False``: no inverse, the residual, the block
    solve and the update."""
    z, f, psi, gam, gamrat, Minv, w, m, J = _inputs(9, 130)
    kernels.reset_counts()
    MJ = BlockDiagGJ().soa_setup(J, gam, CPU)
    z_new, dn, _, _ = BlockDiagGJ().soa_newton_update(MJ, gam, gamrat, z, f,
                                                      psi, w, m, CPU)
    c = kernels.counts()
    assert c["newton_block_inverse"] == c["block_inverse"] == (0, 0)
    assert c["block_inverse_tiled"] == (0, 1)
    for name in NEWTON_KERNELS:
        assert c[name] == ((0, 1) if name in THREE else (0, 0)), name
    assert torch.equal(MJ, block_solve.block_inverse_soa_plain(
        newton_blocks_soa(J, gam)))
    want = newton.masked_update_wrms_plain(
        z, newton.newton_residual_lsolve_plain(z, f, psi, gam, gamrat, MJ),
        w, m)
    assert torch.equal(z_new, want[0]) and torch.equal(dn, want[1])
    z, f, psi, gam, gamrat, _, w, m, J = _inputs(3, 130)
    kernels.reset_counts()
    ls = BlockDiagGJ(factor_once=False)
    MJ = ls.soa_setup(J, gam, CPU)
    ls.soa_newton_update(MJ, gam, gamrat, z, f, psi, w, m, CPU)
    c = kernels.counts()
    assert MJ is J
    assert c["newton_block_inverse"] == c["block_inverse"] == (0, 0)
    assert c["newton_update"] == c["newton_residual_lsolve"] == (0, 0)
    assert c["newton_residual"] == c["block_solve"] == \
        c["masked_update_wrms"] == (0, 1)


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


@pytest.mark.parametrize("case", ["robertson", "decay6"])
def test_ensemble_bdf_takes_both_fused_ops_and_matches_the_reference(case):
    """Robertson (b = 3) to t = 10 and the decay chain (b = 6) to t = 5,
    64 systems: the fused Newton iteration's plain version once a Newton
    trip, the fused lsetup's once a lsetup, and no op they replace; y
    within 10*(rtol*|y|+atol) of the reference's
    ``ensemble_bdf_integrate``, success masks and retcodes equal; bit for
    bit the run with the update and the inverse pinned to their plain
    versions (the composition), with the same counters."""
    nsys = 64
    (f, jac, y0), (rf, rj, ry0) = _robertson(nsys) if case == "robertson" \
        else _decay_chain(nsys, 6)
    tf = 10.0 if case == "robertson" else 5.0
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    kernels.reset_counts()
    batched.reset_loop_counts()
    y, st = batched.ensemble_bdf_integrate(f, jac, y0, 0.0, tf, opts=opts,
                                           policy=CPU)
    c = kernels.counts()
    loops = dict(batched.loop_counts)
    trips, lsetups = loops["newton_trips"], loops["lsetups"]
    assert trips > 0 and 0 < lsetups <= loops["step_trips"]
    assert c["newton_update"] == (0, trips)
    assert c["newton_block_inverse"] == (0, lsetups)
    for name in NEWTON_KERNELS - set(FUSED) | {"block_inverse"}:
        assert c[name] == (0, 0), name
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
    kernels.reset_counts()
    batched.reset_loop_counts()
    y2, st2 = batched.ensemble_bdf_integrate(
        f, jac, y0, 0.0, tf, opts=opts,
        policy=CPU.override(masked_update_wrms_soa="torch",
                            block_inverse_soa="torch"))
    c2 = kernels.counts()
    assert dict(batched.loop_counts) == loops
    assert c2["newton_residual_lsolve"] == c2["masked_update_wrms"] == \
        (0, trips)
    assert c2["block_inverse"] == (0, lsetups)
    assert c2["newton_update"] == c2["newton_block_inverse"] == (0, 0)
    assert torch.equal(y, y2)
    for name, a, b in zip(st._fields, st, st2):
        assert (a is None and b is None) or torch.equal(a, b), name
