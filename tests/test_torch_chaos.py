"""The port's fault-injection harness (``repro_torch.testing.chaos``),
its retcode vocabulary and the serving tier's fault containment, against
the JAX package's.

Core containment runs the reference's Robertson lanes (its rates,
recomputed here with its PRNG keys) poisoned in both packages at 512
lanes: exactly the planned lanes fail, with the reference's retcodes;
healthy lanes are bitwise the port's own clean run and within
10*(rtol*|y|+atol) of the reference's poisoned run (ROADMAP queue C,
"Chaos bitwise checks": the reference does not hold its own bits).  The
serving faults are ``tests/test_chaos.py``'s ``TestServingFaults``
cases, on the port's server on the CPU.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import status as rstatus
from repro.core.batched import ensemble_bdf_integrate as rbdf
from repro.core.problems import batched_robertson as rrobertson
from repro.core.problems import batched_robertson_soa as rrobertson_soa
from repro.serve import solver as rsolver
from repro.testing import chaos as rchaos
from repro_torch.core import ivp, problems, status
from repro_torch.core.batched import (ensemble_bdf_integrate,
                                      ensemble_dirk_integrate)
from repro_torch.core.butcher import DIRK_TABLES
from repro_torch.core.context import Context
from repro_torch.core.policies import ExecPolicy
from repro_torch.observability import ObservabilityConfig
from repro_torch.serve.solver import (IVPRequest, ProblemFamily,
                                      RetryAfter, SolverServer)
from repro_torch.serve.solver.server import DeadlineExceeded, SolverError
from repro_torch.testing.chaos import (ChaosPlan, chaotic_robertson_family,
                                       failing_executions, poison_rhs,
                                       run_core_chaos, run_serving_chaos)

ROB_PARAMS = {"k1": 0.04, "k2": 1.2e4, "k3": 3e7}
CPU = ExecPolicy(device="cpu")


def _reference_rates(nsys):
    """The rates the reference's ``batched_robertson`` closes over (its
    PRNG keys), as numpy arrays for the port's ``rates=``."""
    k2 = 1e4 * (0.5 + jax.random.uniform(jax.random.PRNGKey(0), (nsys,)))
    k3 = 3e7 * 10.0 ** jax.random.uniform(jax.random.PRNGKey(1), (nsys,),
                                          minval=-1.0, maxval=1.0)
    return {"k1": np.full(nsys, 0.04), "k2": np.array(k2),
            "k3": np.array(k3)}


# ---------------------------------------------------------------------------
# retcode vocabulary
# ---------------------------------------------------------------------------

def test_status_names_and_flags_match_the_reference():
    assert status.retcode_name(status.SUCCESS) == "SUCCESS"
    assert status.retcode_name(-999) == "UNKNOWN(-999)"
    assert status.is_success(0) and not status.is_success(-4)
    for code in list(status.RETCODE_NAMES) + [-999, 7]:
        assert status.is_success(code) == rstatus.is_success(code)
    assert status.SUNDIALS_FLAGS == rstatus.SUNDIALS_FLAGS
    assert set(status.SUNDIALS_FLAGS) == set(status.RETCODE_NAMES)


# ---------------------------------------------------------------------------
# seeded fault plans and injectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_plan_draws_the_references_lanes_and_onsets(seed):
    for nsys, k, t0, tf in ((64, 5, 0.0, 1.0), (512, 8, 0.0, 0.4),
                            (10, 10, 2.0, 3.0)):
        got = ChaosPlan.draw(nsys, k, t0, tf, seed=seed)
        want = rchaos.ChaosPlan.draw(nsys, k, t0, tf, seed=seed)
        assert (got.nsys, got.lanes, got.onsets) == \
            (want.nsys, want.lanes, want.onsets)
        assert np.array_equal(got.mask(), want.mask())
        assert np.array_equal(got.onset_vector(), want.onset_vector())


def test_plan_deterministic_bounded_and_validated():
    a = ChaosPlan.draw(64, 5, 0.0, 1.0, seed=7)
    assert a == ChaosPlan.draw(64, 5, 0.0, 1.0, seed=7)
    assert ChaosPlan.draw(64, 5, 0.0, 1.0, seed=8) != a
    assert list(a.lanes) == sorted(set(a.lanes))
    assert all(0.3 <= t <= 0.7 for t in a.onsets)
    assert a.mask().sum() == 5 and np.isinf(a.onset_vector()).sum() == 59
    with pytest.raises(ValueError):
        ChaosPlan.draw(4, 5, 0.0, 1.0)


@pytest.mark.parametrize("mode", ["nan", "divergent"])
@pytest.mark.parametrize("soa", [False, True])
def test_poison_rhs_matches_the_reference(mode, soa):
    nsys = 24
    plan = ChaosPlan.draw(nsys, 4, 0.0, 1.0, seed=3)
    rplan = rchaos.ChaosPlan.draw(nsys, 4, 0.0, 1.0, seed=3)
    rng = np.random.default_rng(1)
    y = rng.normal(size=(3, nsys) if soa else (nsys, 3))
    f = lambda t, yy: 2.0 * yy + 1.0
    for t in (0.1, 0.5, 0.9):
        tv = np.full(nsys, t)
        got = poison_rhs(f, plan, mode=mode, soa=soa)(
            torch.from_numpy(tv), torch.from_numpy(y)).numpy()
        want = np.asarray(rchaos.poison_rhs(f, rplan, mode=mode, soa=soa)(
            jnp.asarray(tv), jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    with pytest.raises(ValueError):
        poison_rhs(f, plan, mode="bogus")


def test_chaotic_family_matches_the_reference():
    port, ref = chaotic_robertson_family(), rchaos.chaotic_robertson_family()
    rng = np.random.default_rng(4)
    nsys = 16
    params = {"k1": np.full(nsys, 0.04),
              "k2": 1e4 * (0.5 + rng.uniform(size=nsys)),
              "k3": 3e7 * 10.0 ** rng.uniform(-1, 1, nsys),
              "t_fault": np.where(rng.uniform(size=nsys) < 0.4, 0.2, np.inf)}
    t = rng.uniform(0, 0.4, nsys)
    y = np.abs(rng.normal(size=(nsys, 3))) * [1.0, 1e-5, 0.1]
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    for i, yy in ((0, y), (1, y), (2, y.T.copy()), (3, y.T.copy())):
        got = port[i](torch.from_numpy(t), torch.from_numpy(yy), pp).numpy()
        want = np.asarray(ref[i](jnp.asarray(t), jnp.asarray(yy), rp))
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# core containment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nan", "divergent"])
def test_core_containment_matches_the_reference(mode):
    nsys, k, seed, tf = 512, 8, 5, 0.4
    rates = _reference_rates(nsys)
    rep = run_core_chaos(nsys, k, seed=seed, tf=tf, policy=CPU, mode=mode,
                         rates=rates)
    assert rep["failed"] == k and rep["bitwise_checked"]
    # the port's poisoned run, for the values
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    fs, js = problems.batched_robertson_soa(nsys, rates=rates, device="cpu")
    plan = ChaosPlan.draw(nsys, k, 0.0, tf, seed=seed)
    y, st = ensemble_bdf_integrate(
        poison_rhs(f, plan, mode=mode), jac, y0, 0.0, tf,
        f_soa=poison_rhs(fs, plan, mode=mode, soa=True), jac_soa=js)
    # the reference's poisoned run on the same lanes
    rf, rj, ry0 = rrobertson(nsys)
    rfs, rjs = rrobertson_soa(nsys)
    rplan = rchaos.ChaosPlan.draw(nsys, k, 0.0, tf, seed=seed)
    ry, rst = rbdf(rchaos.poison_rhs(rf, rplan, mode=mode), rj, ry0, 0.0,
                   tf, f_soa=rchaos.poison_rhs(rfs, rplan, mode=mode,
                                               soa=True), jac_soa=rjs)
    rrc = np.asarray(rst.retcodes)
    assert np.array_equal(st.retcodes.numpy(), rrc)
    assert {str(lane): rstatus.retcode_name(int(rrc[lane]))
            for lane in plan.lanes} == rep["retcodes"]
    healthy = ~plan.mask()
    ry = np.asarray(ry)[healthy]
    bound = 10 * (1e-6 * np.abs(ry) + 1e-9)
    assert (np.abs(y.numpy()[healthy] - ry) <= bound).all()


def test_no_fault_run_is_all_success():
    f, jac, y0 = problems.batched_robertson(4, device="cpu")
    _, st = ensemble_bdf_integrate(f, jac, y0, 0.0, 0.2)
    assert not st.retcodes.any() and bool(st.ok.all())


def test_dirk_lane_quarantine():
    nsys, tf = 6, 0.02
    f, jac, y0 = problems.batched_robertson(nsys, device="cpu")
    plan = ChaosPlan.draw(nsys, 1, 0.0, tf, seed=5)
    y, st = ensemble_dirk_integrate(poison_rhs(f, plan, mode="nan"), jac,
                                    y0, 0.0, tf, DIRK_TABLES["sdirk2"])
    rcs = st.retcodes.numpy()
    assert set(np.flatnonzero(rcs)) == set(plan.lanes)
    assert np.array_equal(st.ok.numpy(), rcs == 0)
    assert bool(torch.isfinite(y[torch.from_numpy(~plan.mask())]).all())


def test_solution_surfaces_retcodes_and_event():
    nsys, tf = 6, 0.2
    f, jac, y0 = problems.batched_robertson(nsys, device="cpu")
    plan = ChaosPlan.draw(nsys, 2, 0.0, tf, seed=6)
    ctx = Context(policy=CPU,
                  observability=ObservabilityConfig(log_level="WARNING"))
    sol = ivp.integrate(ivp.IVP(f=poison_rhs(f, plan, mode="nan"), jac=jac,
                                y0=y0), 0.0, tf, "ensemble_bdf", ctx=ctx)
    rcs = sol.retcodes.numpy()
    assert set(np.flatnonzero(rcs)) == set(plan.lanes)
    assert np.array_equal(sol.ok.numpy(), rcs == 0) and not sol.degraded
    ev = [e for e in ctx.logger.events
          if e["event"] == "integrate.lane_failed"]
    assert len(ev) == 1 and ev[0]["failed"] == 2
    assert set(ev[0]["lanes"]) == set(plan.lanes)


# ---------------------------------------------------------------------------
# session hygiene after failure (tests/test_chaos.py:156)
# ---------------------------------------------------------------------------

def test_mid_leg_nan_lane_cold_restarts():
    nsys, tm, tf = 6, 0.15, 0.4
    f, jac, y0 = problems.batched_robertson(nsys, device="cpu")
    fs, js = problems.batched_robertson_soa(nsys, device="cpu")
    lane = 2
    plan = ChaosPlan(nsys=nsys, lanes=(lane,), onsets=(0.08,))
    clean = ivp.integrate(ivp.IVP(f=f, jac=jac, f_soa=fs, jac_soa=js, y0=y0),
                          0.0, tf, "ensemble_bdf", device="cpu")
    y1, st1, sess = ensemble_bdf_integrate(
        poison_rhs(f, plan, mode="nan"), jac, y0, 0.0, tm,
        f_soa=poison_rhs(fs, plan, mode="nan", soa=True), jac_soa=js,
        return_session=True)
    rcs1 = st1.retcodes.numpy()
    assert rcs1[lane] != 0 and not np.delete(rcs1, lane).any()
    assert float(sess.h[lane]) == 0.0 and int(sess.q[lane]) == 1
    assert int(sess.steps[lane]) == 0 and float(sess.t[lane]) < tm
    assert bool(torch.isfinite(y1).all())
    assert (np.delete(sess.h.numpy(), lane) > 0.0).all()
    y2, st2, sess2 = ensemble_bdf_integrate(
        f, jac, y1, tm, tf, f_soa=fs, jac_soa=js, session=sess,
        return_session=True)
    assert not st2.retcodes.any() and bool(st2.ok.all())
    assert np.allclose(sess2.t.numpy(), tf)
    rel = ((y2 - clean.y).abs() / (clean.y.abs() + 1e-30)).max().item()
    assert rel < 1e-3
    assert int(sess2.steps[lane]) == int(st2.steps[lane])


# ---------------------------------------------------------------------------
# depth-proportional RetryAfter hints, against the reference's
# ---------------------------------------------------------------------------

def _req(ref=False):
    cls = rsolver.IVPRequest if ref else IVPRequest
    return cls(family="robertson", y0=jnp.zeros(3) if ref else np.zeros(3),
               t0=0.0, tf=0.2)


def _hints(mod, ref):
    """The reference's three TestRetryHint scenarios on ``mod``'s queue."""
    out = []
    q = mod.AdmissionQueue(bucket_sizes=(64,), max_batch=64, max_wait=1e-2,
                           max_depth=10_000)
    out.append(q.retry_hint())
    for _ in range(640):
        q.offer(_req(ref), now=0.0)
    out.append(q.retry_hint())
    q = mod.AdmissionQueue(bucket_sizes=(4,), max_batch=4, max_wait=1e-3,
                           max_depth=10_000)
    for t in (0.0, 1.0):
        for _ in range(4):
            q.offer(_req(ref), now=t)
        q.poll(now=t + 0.5, flush_all=True)
    for _ in range(2):
        for _ in range(8):
            q.offer(_req(ref), now=2.0)
        out.append(q.retry_hint())
    q = mod.AdmissionQueue(bucket_sizes=(4,), max_batch=4, max_wait=1e-3,
                           max_depth=2)
    q.offer(_req(ref), now=0.0)
    q.offer(_req(ref), now=0.0)
    with pytest.raises(mod.RetryAfter) as ei:
        q.offer(_req(ref), now=0.0)
    out.append((ei.value.retry_after, q.retry_hint()))
    return out


def test_retry_hints_equal_the_references():
    from repro_torch.serve import solver as psolver
    got, want = _hints(psolver, False), _hints(rsolver, True)
    assert got == want
    assert got[:4] == [pytest.approx(1e-2), pytest.approx(1e-1),
                       pytest.approx(8 / 4.0), pytest.approx(16 / 4.0)]
    assert 1e-3 <= got[4][0] == got[4][1] <= 30.0


# ---------------------------------------------------------------------------
# serving-tier graceful degradation (tests/test_chaos.py TestServingFaults)
# ---------------------------------------------------------------------------

def _chaos_server(**kw):
    fam = chaotic_robertson_family()
    ctx = Context(policy=CPU,
                  observability=ObservabilityConfig(log_level="WARNING"))
    kw.setdefault("bucket_sizes", (4,))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait", 1e-3)
    return SolverServer([ProblemFamily("chaos_rob", 3, *fam)], ctx=ctx, **kw)


def _params(t_fault=math.inf):
    return {**ROB_PARAMS, "t_fault": float(t_fault)}


def _submit(srv, **kw):
    return srv.submit("chaos_rob", [1.0, 0.0, 0.0], 0.0, 0.2, **kw)


class TestServingFaults:
    def test_lane_fault_fails_only_offender(self):
        srv = _chaos_server()
        try:
            healthy = [_submit(srv, params=_params()) for _ in range(3)]
            bad = _submit(srv, params=_params(t_fault=0.1))
            srv.drain()
            with pytest.raises(SolverError) as ei:
                bad.result(timeout=5)
            assert ei.value.retcode in (status.CONV_FAILURE,
                                        status.RHSFUNC_FAIL)
            assert ei.value.retcode_name in ("CONV_FAILURE", "RHSFUNC_FAIL")
            assert "CV_" in str(ei.value)
            assert int(ei.value.stats.retcodes) == ei.value.retcode
            for fut in healthy:
                sol = fut.result(timeout=5)
                assert bool(sol.success) and bool(sol.ok)
                assert int(sol.retcodes) == 0 and not sol.degraded
            ev = [e["event"] for e in srv.ctx.logger.events]
            assert "serve.lane_failed" in ev
            assert sum(srv.metrics()["failures"].values()) == 1
            assert 'reason="' in srv.metrics_prometheus()
        finally:
            srv.stop()

    def test_deadline_shed_before_compute(self):
        srv = _chaos_server()
        try:
            with pytest.raises(ValueError, match="deadline"):
                _submit(srv, params=_params(), deadline=0.0)
            doomed = _submit(srv, params=_params(), deadline=1e-9)
            ok = _submit(srv, params=_params())
            srv.drain()
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=5)
            assert bool(ok.result(timeout=5).success)
            assert srv.metrics()["failures"]["deadline"] == 1
            ev = [e["event"] for e in srv.ctx.logger.events]
            assert "serve.deadline_shed" in ev
            assert ('repro_serve_failures_total{reason="deadline"} 1'
                    in srv.metrics_prometheus())
        finally:
            srv.stop()

    def test_runner_raise_degrades_to_the_plain_versions(self):
        srv = _chaos_server()
        try:
            with failing_executions(srv, k=1) as box:
                futs = [_submit(srv, params=_params()) for _ in range(2)]
                srv.drain()
            assert box["raised"] == 1
            for fut in futs:
                sol = fut.result(timeout=5)
                assert bool(sol.success) and sol.degraded
            m = srv.metrics()
            assert m["degraded"] == 1 and not m["failures"]
            keys = srv.cache.keys()
            assert [k.policy.backend for k in keys] == ["auto", "torch"]
            ev = [e["event"] for e in srv.ctx.logger.events]
            assert "serve.bundle.degraded" in ev
            assert "repro_serve_degraded_total 1" in srv.metrics_prometheus()
            # the next bundle runs the configured backend again
            fut = _submit(srv, params=_params())
            srv.drain()
            assert not fut.result(timeout=5).degraded
        finally:
            srv.stop()

    def test_fallback_failure_fails_futures_typed(self):
        srv = _chaos_server()
        try:
            with failing_executions(srv, k=2):
                fut = _submit(srv, params=_params())
                with pytest.raises(RuntimeError):
                    srv.drain()
            with pytest.raises(SolverError):
                fut.result(timeout=5)
            assert srv.metrics()["failures"]["exec_error"] == 1
        finally:
            srv.stop()

    def test_kernel_error_fails_the_bundle_without_fallback(self):
        """Any runner error but ``BackendUnavailable`` (a kernel that
        fails or refuses its inputs) fails the bundle's futures typed;
        nothing is re-run on the plain versions in its place."""
        srv = _chaos_server()
        try:
            with failing_executions(srv, k=1, exc=RuntimeError(
                    "kernel refused its inputs")) as box:
                futs = [_submit(srv, params=_params()) for _ in range(2)]
                with pytest.raises(RuntimeError, match="refused"):
                    srv.drain()
            assert box["raised"] == 1
            for fut in futs:
                with pytest.raises(SolverError, match="refused"):
                    fut.result(timeout=5)
            m = srv.metrics()
            assert m["degraded"] == 0 and m["failures"] == {"exec_error": 2}
            assert [k.policy.backend for k in srv.cache.keys()] == ["auto"]
            ev = [e["event"] for e in srv.ctx.logger.events]
            assert "serve.bundle.failed" in ev
            assert "serve.bundle.degraded" not in ev
        finally:
            srv.stop()

    def test_all_non_finite_state_fails_the_bundle(self):
        srv = _chaos_server()
        orig = srv._run_compiled

        def poisoned(entry, sess, tfa, params):
            y, st, sess_out = orig(entry, sess, tfa, params)
            return torch.full_like(y, math.nan), st, sess_out

        srv._run_compiled = poisoned
        try:
            fut = _submit(srv, params=_params())
            with pytest.raises(RuntimeError, match="non-finite"):
                srv.drain()
            with pytest.raises(SolverError, match="non-finite"):
                fut.result(timeout=5)
            m = srv.metrics()
            assert m["degraded"] == 0 and m["failures"] == {"exec_error": 1}
        finally:
            srv.stop()

    def test_failed_bundle_spares_the_rest_of_its_poll(self):
        """Two bundles due in one poll, the first fails: its futures
        fail typed, the second still runs, nothing hangs."""
        srv = _chaos_server()
        srv.families["chaos_rob2"] = ProblemFamily(
            "chaos_rob2", 3, *chaotic_robertson_family())
        try:
            with failing_executions(srv, k=1, exc=RuntimeError(
                    "kernel failure")):
                first = [_submit(srv, params=_params()) for _ in range(2)]
                second = [srv.submit("chaos_rob2", [1.0, 0.0, 0.0], 0.0,
                                     0.2, params=_params())
                          for _ in range(2)]
                with pytest.raises(RuntimeError, match="kernel failure"):
                    srv.pump(flush_all=True)
            assert srv.queue.depth == 0
            for fut in first:
                assert isinstance(fut.exception(timeout=5), SolverError)
            for fut in second:
                assert bool(fut.result(timeout=5).success)
            m = srv.metrics()
            assert m["bundles"] == 1 and m["failures"] == {"exec_error": 2}
        finally:
            srv.stop()

    def test_async_pump_outlives_a_failed_bundle(self):
        srv = _chaos_server()
        with srv:
            with failing_executions(srv, k=1, exc=RuntimeError(
                    "kernel failure")):
                bad = _submit(srv, params=_params())
                assert isinstance(bad.exception(timeout=30), SolverError)
            good = _submit(srv, params=_params())
            assert bool(good.result(timeout=30).success)
        assert srv.metrics()["failures"] == {"exec_error": 1}

    def test_submit_with_retry_backoff(self):
        srv = _chaos_server(max_depth=1)
        try:
            _submit(srv, params=_params())
            sleeps = []

            def sleep(s):
                sleeps.append(s)
                srv.drain()

            fut = srv.submit_with_retry("chaos_rob", [1.0, 0.0, 0.0], 0.0,
                                        0.2, params=_params(), seed=0,
                                        sleep=sleep)
            srv.drain()
            assert bool(fut.result(timeout=5).success)
            assert len(sleeps) == 1 and sleeps[0] > 0
        finally:
            srv.stop()

    def test_submit_with_retry_exhaustion(self):
        srv = _chaos_server(max_depth=1)
        try:
            _submit(srv, params=_params())
            sleeps = []
            with pytest.raises(RetryAfter):
                srv.submit_with_retry("chaos_rob", [1.0, 0.0, 0.0], 0.0, 0.2,
                                      params=_params(), retries=2, seed=0,
                                      sleep=sleeps.append)
            assert len(sleeps) == 2 and sleeps[1] > sleeps[0]
        finally:
            srv.stop()


def test_serving_chaos_suite_on_the_cpu():
    rep = run_serving_chaos(600, 12, 6, bucket=64, device="cpu")
    assert rep["failed_retcode"] == 12 and rep["failed_deadline"] == 6
    assert rep["degraded_bundles"] == 1 and rep["failed_exec"] == 8
    assert rep["succeeded"] == 600 - 12 - 6 + 4


def test_chaos_cli_on_the_cpu(capsys):
    from repro_torch.testing import chaos
    assert chaos.main(["--device", "cpu", "--nsys", "64", "--faults", "3",
                       "--requests", "120"]) == 0
    assert '"ok": true' in capsys.readouterr().out
