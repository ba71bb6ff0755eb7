"""The paper's §7 demonstration in the port against the JAX reference.

``repro_torch.apps.brusselator`` (the 1D advection-reaction Brusselator
through ``imex:ark324``) against ``repro.apps.brusselator`` on one
configuration carried across by ``interop``, at nx in {64, 96}, in the
task-local (3x3 block solve) and global (Newton-GMRES, block-solve
preconditioner) configurations: ``y`` within 10*(rtol*|y| + atol), and
the two packages' steps, attempts, Newton iterations and error-test
failures reported side by side and held equal.  Then the port's
versions of the reference's own checks (``tests/test_brusselator.py``):
the Jacobian is exact against ``torch.func.jacfwd``, advection is
conservative and periodic, task-local matches global, and the IMEX
solve matches a fine explicit reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.apps import brusselator as rbr
from repro.configs.brusselator import BrusselatorConfig as RefConfig
from repro_torch import interop
from repro_torch.apps import brusselator as br
from repro_torch.configs.brusselator import BrusselatorConfig
from repro_torch.core.policies import ExecPolicy

TF = 0.1
COUNTERS = ("steps", "attempts", "nni", "netf", "ncfn")


def _configs(**kw):
    ref = RefConfig(**kw)
    return ref, interop.brusselator_config_from_reference(
        dataclasses.asdict(ref))


@pytest.mark.parametrize("nx,solver,backend", [
    (64, "task-local", "torch"), (64, "task-local", "auto"),
    (96, "task-local", "torch"), (64, "global", "torch"),
    (64, "global", "auto"), (96, "global", "torch")])
def test_app_matches_reference(nx, solver, backend):
    ref_cfg, cfg = _configs(nx=nx, solver=solver)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    y_ref, st_ref = rbr.integrate(ref_cfg, t_final=TF)
    y, st = br.integrate(cfg, t_final=TF,
                         policy=ExecPolicy(backend=backend, device="cpu"))
    assert bool(st.success) and bool(st_ref.success)
    want = np.asarray(y_ref)
    assert y.shape == want.shape == (nx, 3)
    bound = 10 * (cfg.rtol * np.abs(want) + cfg.atol)
    assert np.all(np.abs(y.numpy() - want) <= bound)
    side_by_side = {k: (int(getattr(st, k)), int(getattr(st_ref, k)))
                    for k in COUNTERS}
    print(f"nx={nx} {solver} {backend}: port/reference {side_by_side}")
    assert all(a == b for a, b in side_by_side.values()), side_by_side


def test_problem_functions_match_reference():
    ref_cfg, cfg = _configs(nx=40)
    y0 = br.initial_state(cfg, device="cpu")
    np.testing.assert_allclose(y0.numpy(), np.asarray(rbr.initial_state(
        ref_cfg)), rtol=1e-15, atol=0)
    rng = np.random.default_rng(0)
    y = 1.0 + 0.1 * rng.normal(size=(40, 3))
    t_y, j_y = torch.from_numpy(y), jnp.asarray(y)
    for port, ref in ((br.advection_rhs, rbr.advection_rhs),
                      (br.reaction_rhs, rbr.reaction_rhs),
                      (br.reaction_jacobian, rbr.reaction_jacobian)):
        np.testing.assert_allclose(
            port(cfg)(torch.tensor(0.0), t_y).numpy(),
            np.asarray(ref(ref_cfg)(0.0, j_y)), rtol=1e-14, atol=1e-9)


def test_reaction_jacobian_is_exact():
    cfg = BrusselatorConfig(nx=8)
    fi = br.reaction_rhs(cfg)
    jac = br.reaction_jacobian(cfg)
    y = br.initial_state(cfg, device="cpu") + 0.05
    J_ad = torch.func.jacfwd(lambda yy: fi(0.0, yy))(y)   # (nx,3,nx,3)
    J_an = jac(0.0, y)
    for i in range(cfg.nx):
        np.testing.assert_allclose(J_ad[i, :, i, :].numpy(),
                                   J_an[i].numpy(), rtol=1e-10)
        # off-diagonal blocks are exactly zero (point-local reactions)
        if i:
            assert float(J_ad[i, :, 0, :].abs().max()) == 0.0


def test_advection_is_conservative_and_periodic():
    cfg = BrusselatorConfig(nx=32)
    y = br.initial_state(cfg, device="cpu")
    dy = br.advection_rhs(cfg)(0.0, y)
    # upwind advection conserves the total of each species (periodic BC)
    np.testing.assert_allclose(dy.sum(dim=0).numpy(), np.zeros(3),
                               atol=1e-10)
    # the first cell's upwind neighbour is the last cell
    dx = cfg.b_domain / cfg.nx
    assert torch.equal(dy[0], -(cfg.c / dx) * (y[0] - y[-1]))


def test_task_local_matches_global():
    """The reference's bound between its two configurations
    (``tests/test_brusselator.py:14``), at its mesh and interval."""
    cpu = ExecPolicy(device="cpu")
    y_tl, st_tl = br.integrate(BrusselatorConfig(nx=96, solver="task-local"),
                               t_final=0.2, policy=cpu)
    y_gl, st_gl = br.integrate(BrusselatorConfig(nx=96, solver="global"),
                               t_final=0.2, policy=cpu)
    assert bool(st_tl.success) and bool(st_gl.success)
    np.testing.assert_allclose(y_tl.numpy(), y_gl.numpy(), rtol=1e-7,
                               atol=1e-9)


def test_against_explicit_reference():
    """The IMEX solve against a fine fixed-step explicit one, and that
    explicit reference against the reference package's; an interval
    short enough for the explicit stability limit (h ~ eps)."""
    ref_cfg, cfg = _configs(nx=64)
    y, st = br.integrate(cfg, t_final=0.02, policy=ExecPolicy(device="cpu"))
    fine = br.reference_solution(cfg, 0.02, n_steps=2000, device="cpu")
    np.testing.assert_allclose(y.numpy(), fine.numpy(), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(
        fine.numpy(), np.asarray(rbr.reference_solution(ref_cfg, 0.02,
                                                        n_steps=2000)),
        rtol=1e-12, atol=1e-12)
    # IMEX needs far fewer steps than the explicit stability limit
    assert int(st.steps) < 100


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        br.integrate(BrusselatorConfig(nx=8), t_final=0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        br.initial_state(BrusselatorConfig(nx=8))
