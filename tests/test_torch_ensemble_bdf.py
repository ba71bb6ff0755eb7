"""The port's ``integrate(..., "ensemble_bdf")`` against the JAX reference.

Batched Robertson with the same numpy-drawn rate constants in both
packages (the reference's ``jax.random`` draw cannot be reproduced in
PyTorch), float64 on the CPU, rtol 1e-5, atol 1e-10, t in [0, 10].  The
port runs its plain PyTorch versions here (CPU tensors); the reference
runs its default jnp policy.  Held to tolerances, not bits: the two
decide step acceptance on values that differ in the last ulps, and the
reference's own jnp and Pallas trajectories agree only at O(rtol).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import ivp as rivp
from repro.core import problems as rprob
from repro.core import status as rstatus
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch.core import batched, ivp, problems, status
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.context import Context

RTOL, ATOL = 1e-5, 1e-10


def _reference(rates, nsys, max_steps):
    F, J, FS, JS = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    y0 = jnp.concatenate([jnp.ones((nsys, 1)), jnp.zeros((nsys, 2))], axis=1)
    prob = rivp.IVP(f=lambda t, y: F(t, y, p), jac=lambda t, y: J(t, y, p),
                    f_soa=lambda t, y: FS(t, y, p),
                    jac_soa=lambda t, y: JS(t, y, p), y0=y0)
    return rivp.integrate(prob, 0.0, 10.0, "ensemble_bdf",
                          opts=RefOptions(rtol=RTOL, atol=ATOL,
                                          max_steps=max_steps))


def _port(rates, nsys, max_steps, ctx=None):
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    f_soa, jac_soa = problems.batched_robertson_soa(nsys, rates=rates,
                                                    device="cpu")
    return ivp.integrate(
        ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa), 0.0, 10.0,
        "ensemble_bdf", ctx=ctx,
        opts=ODEOptions(rtol=RTOL, atol=ATOL, max_steps=max_steps),
        device="cpu")


def _counter_report(ref, sol):
    lines = []
    for k in ("steps", "nni", "nsetups", "netf"):
        a = np.asarray(getattr(ref.stats, k))
        b = getattr(sol.stats, k).numpy()
        d = b - a
        lines.append(f"{k}: ref sum {a.sum()} port sum {b.sum()} per-lane "
                     f"diff min {d.min()} max {d.max()} mean {d.mean():.3f}")
    return "\n".join(lines)


@pytest.mark.parametrize("nsys", [130, 512])
def test_ensemble_bdf_matches_reference(nsys):
    rates = problems.robertson_rates(nsys, seed=0)
    ref = _reference(rates, nsys, 100_000)
    sol = _port(rates, nsys, 100_000)
    report = _counter_report(ref, sol)
    assert bool(sol.ok.all()) and bool(np.asarray(ref.ok).all()), report
    assert np.array_equal(sol.retcodes.numpy(), np.asarray(ref.retcodes))
    y_ref = np.asarray(ref.y)
    bound = 10 * (RTOL * np.abs(y_ref) + ATOL)
    assert np.all(np.abs(sol.y.numpy() - y_ref) <= bound), report
    s_ref = int(np.asarray(ref.stats.steps).sum())
    s_port = int(sol.stats.steps.sum())
    assert abs(s_port - s_ref) <= 0.05 * s_ref, report
    # counters keep the reference's int32, state keeps y0's dtype
    assert sol.y.dtype == torch.float64
    for k in ("steps", "attempts", "netf", "nni", "nsetups", "ncfn",
              "retcodes"):
        assert getattr(sol.stats, k).dtype == torch.int32, k


def test_max_steps_quarantines_every_lane_in_both():
    nsys = 130
    rates = problems.robertson_rates(nsys, seed=0)
    ref = _reference(rates, nsys, 20)
    sol = _port(rates, nsys, 20)
    assert np.all(np.asarray(ref.retcodes) == rstatus.TOO_MUCH_WORK)
    assert torch.all(sol.retcodes == status.TOO_MUCH_WORK)
    assert not bool(sol.success) and not bool(sol.ok.any())
    assert np.all(np.isfinite(sol.y.numpy()))


def test_loop_counts_and_context_accounting():
    nsys = 64
    rates = problems.robertson_rates(nsys, seed=1)
    ctx = Context()
    batched.reset_loop_counts()
    sol = _port(rates, nsys, 100_000, ctx=ctx)
    c = dict(batched.loop_counts)
    # one sync per step trip, one for lsetup, one per Newton trip, plus
    # one per step whose Newton loop ends by convergence
    assert c["step_trips"] == int(sol.stats.attempts.max())
    assert c["host_syncs"] >= 2 * c["step_trips"] + c["newton_trips"] + 1
    assert c["host_syncs"] <= 3 * c["step_trips"] + c["newton_trips"] + 1
    assert ctx.counters["integrations"] == 1
    assert ctx.counters["steps"] == int(sol.stats.steps.sum())
    assert ctx.counters["newton_iters"] == int(sol.nni)
    history = 6 * 3 * nsys * 8
    assert sol.workspace_bytes == history + 3 * 3 * nsys * 8
    assert ctx.memory.live_bytes == 0
    assert ctx.memory.high_water_bytes == sol.workspace_bytes


def test_aos_callables_match_native_soa():
    """Without f_soa/jac_soa the boundary wrapper transposes; the
    arithmetic is the same, so the runs agree exactly."""
    nsys = 40
    rates = problems.robertson_rates(nsys, seed=2)
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    opts = ODEOptions(rtol=RTOL, atol=ATOL)
    aos = ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, 10.0,
                        "ensemble_bdf", opts=opts, device="cpu")
    soa = _port(rates, nsys, opts.max_steps)
    assert torch.equal(aos.y, soa.y)
    assert torch.equal(aos.stats.steps, soa.stats.steps)
