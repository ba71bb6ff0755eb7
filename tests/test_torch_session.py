"""Warm start (``SolverSession``), the memory helper, the ``lin_mode=``
shim and the batched-kinetics example of the port, against the JAX
package where it has a counterpart.

Warm start: leg 1 of batched Robertson runs in the reference, its
session crosses into the port as numpy leaves, and leg 2 runs in both,
held as ``tests/test_torch_ensemble_bdf.py`` holds the main path: y
within 10*(rtol*|y|+atol), retcodes equal, steps within 5 %.  The
port's own session contracts (a cold session, lane slicing, reuse of a
handle, quarantined lanes exported cold) are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import ivp as rivp
from repro.core import memory as rmemory
from repro.core import problems as rprob
from repro.core.arkode import ODEOptions as RefOptions
from repro.core.batched import SolverSession as RefSession
from repro_torch import interop
from repro_torch.core import batched, ivp, memory, problems, status
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.batched import SolverSession
from repro_torch.core.linsol import BlockDiagGJ
from repro_torch.core.policies import ExecPolicy
from repro_torch.examples import batched_kinetics

RTOL, ATOL = 1e-5, 1e-10
OPTS = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000,
                  policy=ExecPolicy(device="cpu"))


def _port_problem(nsys, rates, y0=None):
    f, jac, y0_ = problems.batched_robertson(nsys, rates=rates, device="cpu")
    fs, js = problems.batched_robertson_soa(nsys, rates=rates, device="cpu")
    return ivp.IVP(f=f, jac=jac, y0=y0_ if y0 is None else y0, f_soa=fs,
                   jac_soa=js)


def _ref_problem(nsys, rates, y0=None):
    F, J, FS, JS = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    if y0 is None:
        y0 = jnp.concatenate([jnp.ones((nsys, 1)), jnp.zeros((nsys, 2))],
                             axis=1)
    return rivp.IVP(f=lambda t, y: F(t, y, p), jac=lambda t, y: J(t, y, p),
                    f_soa=lambda t, y: FS(t, y, p),
                    jac_soa=lambda t, y: JS(t, y, p), y0=jnp.asarray(y0))


def _leaves(session):
    return [x.clone() for x in session]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_warm_leg_from_a_reference_session_matches_the_reference():
    nsys = 130
    rates = problems.robertson_rates(nsys, seed=0)
    ropts = RefOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    leg1 = rivp.integrate(_ref_problem(nsys, rates), 0.0, 0.1,
                          "ensemble_bdf", opts=ropts, return_session=True)
    leaves = {k: np.asarray(v) for k, v in leg1.session._asdict().items()}
    sess = interop.session_from_reference(leaves, device="cpu")
    for k, v in interop.session_to_numpy(sess).items():
        assert v.dtype == leaves[k].dtype and np.array_equal(v, leaves[k]), k
    assert sess.Z.shape == (6, 3, nsys) and sess.nsys == nsys
    y1 = np.asarray(leg1.y)
    ref = rivp.integrate(_ref_problem(nsys, rates, y1), 0.1, 0.3,
                         "ensemble_bdf", opts=ropts, session=leg1.session)
    sol = ivp.integrate(_port_problem(nsys, rates, torch.tensor(y1)),
                        0.1, 0.3, "ensemble_bdf", opts=OPTS, session=sess,
                        return_session=True, telemetry=512)
    assert np.array_equal(sol.retcodes.numpy(), np.asarray(ref.retcodes))
    y_ref = np.asarray(ref.y)
    assert np.all(np.abs(sol.y.numpy() - y_ref) <=
                  10 * (RTOL * np.abs(y_ref) + ATOL))
    s_ref = int(np.asarray(ref.stats.steps).sum())
    assert abs(int(sol.stats.steps.sum()) - s_ref) <= 0.05 * s_ref
    # the leg's counters, the session's cumulative steps, the ring
    assert torch.equal(sol.session.steps,
                       sess.steps + sol.stats.steps)
    tel = sol.telemetry
    assert tel.steps().tolist() == sol.stats.steps.tolist()
    assert tel.newton_iters_total().tolist() == sol.stats.nni.tolist()
    assert tel.lsetups().tolist() == sol.stats.nsetups.tolist()
    # a warm leg skips the cold order-1 ramp
    cold = ivp.integrate(_port_problem(nsys, rates, torch.tensor(y1)),
                         0.1, 0.3, "ensemble_bdf", opts=OPTS)
    assert int(sol.stats.steps.sum()) < int(cold.stats.steps.sum())


def test_cold_session_is_the_session_free_run_bit_for_bit():
    nsys = 24
    rates = problems.robertson_rates(nsys, seed=4)
    prob = _port_problem(nsys, rates)
    plain = ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf", opts=OPTS)
    sess = SolverSession.cold(prob.y0, 0.0)
    ref = RefSession.cold(jnp.asarray(prob.y0.numpy()), 0.0)
    for k, v in interop.session_to_numpy(sess).items():
        want = np.asarray(getattr(ref, k))
        assert v.dtype == want.dtype and np.array_equal(v, want), k
    sol = ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf", opts=OPTS,
                        session=sess, return_session=True)
    assert torch.equal(sol.y, plain.y)
    for k in ("steps", "attempts", "nni", "nsetups", "retcodes"):
        assert torch.equal(getattr(sol.stats, k), getattr(plain.stats, k)), k
    # y0 may be omitted with a session, and must fit it when given
    y, st, _ = batched.ensemble_bdf_integrate(
        prob.f, prob.jac, None, None, 1.0, opts=OPTS, session=sess,
        return_session=True)
    assert torch.equal(y, plain.y)
    with pytest.raises(ValueError, match="disagrees with the session"):
        batched.ensemble_bdf_integrate(prob.f, prob.jac, prob.y0[:3], None,
                                       1.0, opts=OPTS, session=sess)
    with pytest.raises(ValueError, match="needs y0"):
        batched.ensemble_bdf_integrate(prob.f, prob.jac, None, 0.0, 1.0,
                                       opts=OPTS)


def test_session_reuse_leaves_the_handle_and_repeats_its_bits():
    nsys = 16
    rates = problems.robertson_rates(nsys, seed=5)
    leg1 = ivp.integrate(_port_problem(nsys, rates), 0.0, 1.0,
                         "ensemble_bdf", opts=OPTS, return_session=True)
    sess = leg1.session
    before = _leaves(sess)
    prob2 = _port_problem(nsys, rates, leg1.y)
    runs = [ivp.integrate(prob2, 1.0, 3.0, "ensemble_bdf", opts=OPTS,
                          session=sess, return_session=True)
            for _ in range(2)]
    assert _same(before, sess)
    assert torch.equal(runs[0].y, runs[1].y)
    assert _same(runs[0].session, runs[1].session)
    assert torch.equal(runs[0].stats.steps, runs[1].stats.steps)


def test_lanes_and_concat_round_trip_and_integrate_lane_by_lane():
    nsys = 12
    rates = problems.robertson_rates(nsys, seed=6)
    leg1 = ivp.integrate(_port_problem(nsys, rates), 0.0, 1.0,
                         "ensemble_bdf", opts=OPTS, return_session=True)
    sess = leg1.session
    parts = [sess.lanes(slice(0, 5)), sess.lanes(slice(5, nsys))]
    assert parts[0].nsys == 5 and parts[1].n == 3
    assert _same(SolverSession.concat(parts), sess)
    # a mixed bundle: warm lanes 0-4 with cold lanes, run as one
    idx = torch.arange(5)
    mixed = SolverSession.concat([sess.lanes(idx),
                                  SolverSession.cold(leg1.y[5:], 1.0)])
    full = ivp.integrate(_port_problem(nsys, rates, leg1.y), 1.0, 2.0,
                         "ensemble_bdf", opts=OPTS, session=sess)
    sol = ivp.integrate(_port_problem(nsys, rates, leg1.y), 1.0, 2.0,
                        "ensemble_bdf", opts=OPTS, session=mixed)
    assert torch.equal(sol.y[:5], full.y[:5])
    cold = ivp.integrate(_port_problem(nsys, rates, leg1.y), 1.0, 2.0,
                         "ensemble_bdf", opts=OPTS)
    assert torch.equal(sol.y[5:], cold.y[5:])


def test_quarantined_lane_is_exported_cold():
    nsys = 8
    rates = problems.robertson_rates(nsys, seed=7)
    leg1 = ivp.integrate(_port_problem(nsys, rates), 0.0, 0.5,
                         "ensemble_bdf", opts=OPTS, return_session=True)
    # lane 0 starts cold from its state, the others warm: a few attempts
    # quarantine the cold lane only
    sess = SolverSession.concat([SolverSession.cold(leg1.y[:1], 0.5),
                                 leg1.session.lanes(slice(1, None))])
    sol = ivp.integrate(_port_problem(nsys, rates, leg1.y), 0.5, 0.6,
                        "ensemble_bdf", opts=OPTS._replace(max_steps=12),
                        session=sess, return_session=True)
    bad = sol.retcodes != 0
    assert bool(bad[0]) and int(sol.retcodes[0]) == status.TOO_MUCH_WORK
    assert not bool(bad[1:].any())
    out = sol.session
    assert float(out.h[0]) == 0.0 and int(out.q[0]) == 1
    assert float(out.e1[0]) == 1.0 == float(out.e2[0])
    assert int(out.steps[0]) == 0
    assert torch.equal(out.Z[0, :, 0], sol.y[0])
    assert bool((out.h[1:] > 0).all())
    assert torch.equal(out.steps[1:], leg1.session.steps[1:]
                       + sol.stats.steps[1:])


def _drive_memory(mod, helper, host_of, dtype64, dtype32):
    MT = mod.MemoryType
    src = helper.wrap(host_of(np.arange(12.0).reshape(4, 3)), MT.HOST)
    dev = helper.alloc((4, 3), dtype64, MT.DEVICE)
    dev = helper.copy(dev, src)
    back = helper.alloc((4, 3), dtype64, MT.HOST)
    back = helper.copy(back, dev)
    pinned = helper.alloc((2,), dtype32, MT.PINNED)
    uvm = helper.alloc((5,), dtype64, MT.UVM)
    helper.register("history", (6, 3, 4), dtype64)
    helper.register("history", (6, 3, 2), dtype64)
    helper.register("blocks", (3, 3, 4), dtype64)
    helper.release("blocks")
    mems = (src, dev, back, pinned, uvm)
    return helper.stats, [(m.mem_type.value, m.own, None if m.requested_type
                           is None else m.requested_type.value)
                          for m in mems], np.asarray(back.data)


def test_memory_helper_stats_equal_the_reference():
    ref = _drive_memory(rmemory, rmemory.MemoryHelper(), jnp.asarray,
                        jnp.float64, jnp.float32)
    port = _drive_memory(memory, memory.MemoryHelper(device="cpu"),
                         torch.from_numpy, torch.float64, torch.float32)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert np.array_equal(port[2], ref[2])
    h = memory.MemoryHelper(device="cpu")
    a = h.alloc((2,), torch.float64, memory.MemoryType.HOST)
    with pytest.raises(ValueError, match="copy"):
        h.copy(a, h.wrap(torch.zeros(3, dtype=torch.float64)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            memory.MemoryHelper().alloc((2,))


@pytest.mark.parametrize("mode", ["setup", "direct"])
def test_lin_mode_shim_warns_and_equals_blockdiag_gj(mode):
    nsys = 10
    prob = _port_problem(nsys, problems.robertson_rates(nsys, seed=8))
    args = (prob.f, prob.jac, prob.y0, 0.0, 1.0)
    with pytest.warns(DeprecationWarning, match="repro-compat"):
        y, st = batched.ensemble_bdf_integrate(*args, opts=OPTS,
                                               lin_mode=mode)
    y2, st2 = batched.ensemble_bdf_integrate(
        *args, opts=OPTS,
        linear_solver=BlockDiagGJ(factor_once=mode == "setup"))
    assert torch.equal(y, y2) and torch.equal(st.nni, st2.nni)
    with pytest.warns(DeprecationWarning, match="repro-compat"):
        with pytest.raises(ValueError, match="lin_mode"):
            batched.ensemble_bdf_integrate(*args, opts=OPTS, lin_mode="lu")


@pytest.mark.parametrize("argv", [["--bdf"], ["--tf", "1"]])
def test_batched_kinetics_example_runs_on_the_cpu(argv, capsys):
    sol = batched_kinetics.main(["--device", "cpu", "--cells", "16"] + argv)
    assert bool(sol.success)
    assert "all converged: True" in capsys.readouterr().out
