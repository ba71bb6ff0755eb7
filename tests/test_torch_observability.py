"""The port's observability package against the JAX package's.

The profiler, logger and metrics are host code in both packages: the
same calls, with the clock injected, must render, summarise and export
exactly the same.  The telemetry ring and ``StepTelemetry`` are fed one
seeded record sequence in both (numpy, then jnp / torch on the CPU):
every field equal, and ``summary()`` equal with histogram edges within
1e-12.  ``integrate``'s telemetry reconciles exactly with the port's
own counters, per lane, and the port's counters are held to the
reference's as ``tests/test_torch_ensemble_bdf.py`` holds them: y within
10*(rtol*|y|+atol), retcodes equal, steps within 5 %.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import observability as robs
from repro.core import ivp as rivp
from repro.core import problems as rprob
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch import observability as obs
from repro_torch.core import ivp, problems
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.context import Context
from repro_torch.core.policies import ExecPolicy

RTOL, ATOL = 1e-5, 1e-10
CPU = ExecPolicy(device="cpu")


def _ticks():
    clock = iter(float(i) * 0.25 for i in range(1000))
    return lambda: next(clock)


# ---------------------------------------------------------------------------
# config, profiler, logger, metrics: the same calls in both packages
# ---------------------------------------------------------------------------

def test_config_fields_and_defaults_equal_the_reference():
    assert dataclasses.asdict(obs.ObservabilityConfig()) == \
        dataclasses.asdict(robs.ObservabilityConfig())
    for kw in ({}, {"profile": True}, {"telemetry": True},
               {"log_level": "INFO"}):
        assert obs.ObservabilityConfig(**kw).enabled == \
            robs.ObservabilityConfig(**kw).enabled
    ctx = Context()
    assert not ctx.profiler.enabled and not ctx.logger.enabled
    ctx2 = Context(policy=CPU, observability=obs.ObservabilityConfig(
        profile=True, log_level="DEBUG"))
    assert ctx2.profiler.enabled and ctx2.logger.enabled_for("DEBUG")
    assert ctx2.trace_cache is None
    # the reference's context fronts its autotuner's resolver; the port's
    # the resolver of its policy's device (the CPU's here)
    assert ctx2.autotune.device == "cpu"
    assert ctx2.autotune is Context(policy=CPU).autotune


def _drive_profiler(mod):
    p = mod.Profiler(enabled=True, sync=False, clock=_ticks())
    with p.region("outer", cat="solve", method="bdf"):
        with p.region("inner"):
            pass
        with p.region("inner"):
            with p.region("leaf"):
                pass
    p.add_span("queue", 0.5, 1.75, cat="serve", args={"k": 1}, depth=2)
    return p


def test_profiler_render_summary_chrome_trace_equal_the_reference(tmp_path):
    ref, port = _drive_profiler(robs), _drive_profiler(obs)
    assert [dataclasses.astuple(s) for s in port.spans] == \
        [dataclasses.astuple(s) for s in ref.spans]
    assert port.summary() == ref.summary()
    assert port.render() == ref.render()
    assert port.chrome_trace() == ref.chrome_trace()
    path = port.export_chrome_trace(str(tmp_path / "trace.json"))
    assert json.loads(open(path).read()) == ref.chrome_trace()
    # disabled: one shared no-op region, nothing recorded
    off = obs.Profiler(enabled=False)
    assert off.region("a") is off.region("b")
    off.add_span("x", 0.0, 1.0)
    assert off.spans == []


def test_profiler_synchronises_its_device():
    calls = []
    p = obs.Profiler(sync_fn=lambda: calls.append(1))
    with p.region("r"):
        pass
    with p.region("nosync", sync=False):
        pass
    assert calls == [1]
    # the default synchronise: a no-op on a CPU device, and the card's
    # otherwise, which raises when there is no card
    with obs.Profiler(device="cpu").region("cpu"):
        pass
    if not torch.cuda.is_available():
        p = obs.Profiler()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with p.region("card"):
                pass


def _drive_logger(mod, path):
    log = mod.EventLogger(level="INFO", path=str(path), clock=lambda: 12.5)
    log.debug("d")
    log.info("step.done", steps=3, method="bdf")
    log.warning("w", lanes=[1, 2])
    log.error("e", codes={"ERR_FAILURE": 2})
    log.close()
    return log


def test_logger_events_and_jsonl_equal_the_reference(tmp_path):
    ref = _drive_logger(robs, tmp_path / "ref.jsonl")
    port = _drive_logger(obs, tmp_path / "port.jsonl")
    assert list(port.events) == list(ref.events)
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    assert obs.LEVELS == robs.LEVELS
    log = obs.EventLogger(level="WARNING")
    assert log.enabled_for("ERROR") and not log.enabled_for("INFO")
    assert not obs.EventLogger().enabled
    with pytest.raises(ValueError, match="level"):
        obs.EventLogger(level="CHATTY")


def _drive_metrics(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("repro_reqs", "requests")
    c.inc()
    c.inc(2.0, family="rob")
    c.set_cumulative(7, family="dec")
    g = reg.gauge("repro_depth", "queue depth")
    g.set(3)
    g.inc(0.5, lane="a")
    h = reg.histogram("repro_lat", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    h.set_counts([1, 2, 3], 4.5, 6, family="rob")
    assert reg.counter("repro_reqs") is c
    with pytest.raises(ValueError, match="registered"):
        reg.gauge("repro_reqs")
    with pytest.raises(ValueError, match="bucket counts"):
        h.set_counts([1, 2], 0.0, 3)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    # a context with counters and a trace cache, and no dispatch report
    tc = types.SimpleNamespace(stats=lambda: {
        "hits": 5, "misses": 2, "evictions": 0, "size": 2, "hit_rate": 0.7})
    ctx = types.SimpleNamespace(
        counters={"integrations": 2, "steps": 19, "newton_iters": 40},
        trace_cache=tc, dispatch_report=lambda: None)
    mod.context_metrics(reg, ctx)
    return reg.render()


def test_metrics_prometheus_text_equals_the_reference():
    assert _drive_metrics(obs) == _drive_metrics(robs)


def test_context_metrics_counts_integrations():
    ctx = Context(policy=CPU)
    f, jac, y0 = problems.batched_robertson(2, device="cpu")
    for _ in range(2):
        ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, 0.05,
                      "ensemble_bdf", ctx=ctx)
    reg = obs.MetricsRegistry()
    obs.context_metrics(reg, ctx)
    text = reg.render()
    assert "repro_context_integrations_total 2" in text
    # the CPU's "auto" decisions, with no cache: no measured agreement
    rep = ctx.dispatch_report()
    assert "repro_autotune_cache_entries 0" in text
    assert f"repro_autotune_decisions_total {len(rep['decisions'])}" in text
    assert rep["decisions"] and "repro_autotune_model_agreement" not in text


# ---------------------------------------------------------------------------
# the ring and StepTelemetry: one seeded record sequence in both packages
# ---------------------------------------------------------------------------

def _records(count, nsys, seed):
    """``count`` records of RECORD_FIELDS, each field (nsys,) or ()."""
    rng = np.random.default_rng(seed)
    shape = () if nsys is None else (nsys,)
    out = []
    for i in range(count):
        active = rng.uniform(size=shape) < 0.9
        conv = rng.uniform(size=shape) < 0.8
        out.append((0.01 * (i + 1) + 1e-3 * rng.uniform(size=shape),
                    10.0 ** rng.uniform(-8, 0, size=shape),
                    rng.integers(1, 6, size=shape).astype(np.int32),
                    rng.integers(0, 5, size=shape).astype(np.int32),
                    rng.uniform(0, 2, size=shape),
                    rng.uniform(size=shape) < 0.3, conv,
                    conv & (rng.uniform(size=shape) < 0.7) & active, active))
    return out


FIELDS = ("t", "h", "q", "newton_iters", "err_ratio", "lsetup_fired",
          "converged", "accepted", "active")


@pytest.mark.parametrize("K,count,nsys,live", [
    (8, 5, None, None),        # scalar, not wrapped
    (3, 7, None, None),        # scalar, wrapped
    (16, 11, 6, None),         # ensemble, not wrapped
    (4, 11, 6, None),          # ensemble, wrapped
    (16, 9, 6, [True, False, True, True, False, True]),   # padded bundle
])
def test_ring_and_step_telemetry_equal_the_reference(K, count, nsys, live):
    tail = () if nsys is None else (nsys,)
    rring = robs.ring_init(K, tail, jnp.float64)
    pring = obs.ring_init(K, tail, torch.float64, "cpu")
    for rec in _records(count, nsys, seed=K * 100 + count):
        rring = robs.ring_record(rring, tuple(jnp.asarray(v) for v in rec))
        pring = obs.ring_record(pring, tuple(torch.from_numpy(np.asarray(v))
                                             for v in rec))
    assert pring.idx == int(rring.idx) and pring.capacity == K
    for name in obs.RECORD_FIELDS:
        got, want = getattr(pring, name).numpy(), np.asarray(getattr(rring,
                                                                     name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    ref, port = robs.StepTelemetry(rring, live=live), \
        obs.StepTelemetry(pring, live=live)
    assert (port.records, port.total_records, port.truncated) == \
        (ref.records, ref.total_records, ref.truncated)
    for name in FIELDS:
        assert np.array_equal(getattr(port, name).numpy(),
                              getattr(ref, name)), name
    for name in ("steps", "attempts", "newton_iters_total", "lsetups"):
        assert np.array_equal(getattr(port, name)().numpy(),
                              getattr(ref, name)()), name
    s_ref, s_port = ref.summary(), port.summary()
    e_ref = s_ref.pop("h_hist_log10")
    e_port = s_port.pop("h_hist_log10")
    assert s_port == s_ref
    assert e_port["counts"] == e_ref["counts"]
    assert np.allclose(e_port["edges"], e_ref["edges"], rtol=0, atol=1e-12)
    assert repr(port) == repr(ref)


def test_ring_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        obs.ring_init(0, (), torch.float64, "cpu")


# ---------------------------------------------------------------------------
# integrate(): exact reconciliation, counters held to the reference
# ---------------------------------------------------------------------------

def _port_problem(nsys, rates):
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    fs, js = problems.batched_robertson_soa(nsys, rates=rates, device="cpu")
    return ivp.IVP(f=f, jac=jac, y0=y0, f_soa=fs, jac_soa=js)


def _ref_problem(nsys, rates, y0=None):
    F, J, FS, JS = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    if y0 is None:
        y0 = jnp.concatenate([jnp.ones((nsys, 1)), jnp.zeros((nsys, 2))],
                             axis=1)
    return rivp.IVP(f=lambda t, y: F(t, y, p), jac=lambda t, y: J(t, y, p),
                    f_soa=lambda t, y: FS(t, y, p),
                    jac_soa=lambda t, y: JS(t, y, p), y0=jnp.asarray(y0))


def _held_to_reference(sol, ref):
    assert np.array_equal(sol.retcodes.numpy(), np.asarray(ref.retcodes))
    y_ref = np.asarray(ref.y)
    bound = 10 * (RTOL * np.abs(y_ref) + ATOL)
    assert np.all(np.abs(sol.y.numpy() - y_ref) <= bound)
    s_ref = int(np.asarray(ref.stats.steps).sum())
    assert abs(int(sol.stats.steps.sum()) - s_ref) <= 0.05 * s_ref


def _reconciles(tel, st, nsetups=True):
    assert not tel.truncated
    pairs = [(tel.steps(), st.steps), (tel.attempts(), st.attempts),
             (tel.newton_iters_total(), st.nni)]
    if nsetups:
        pairs.append((tel.lsetups(), st.nsetups))
    for got, want in pairs:
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("method,tf", [("ensemble_bdf", 0.2),
                                       ("ensemble_dirk:sdirk2", 0.05)])
def test_ensemble_telemetry_reconciles_and_matches_reference(method, tf):
    nsys = 8
    rates = problems.robertson_rates(nsys, seed=3)
    opts = ODEOptions(rtol=RTOL, atol=ATOL, policy=CPU)
    plain = ivp.integrate(_port_problem(nsys, rates), 0.0, tf, method,
                          opts=opts)
    sol = ivp.integrate(_port_problem(nsys, rates), 0.0, tf, method,
                        opts=opts, telemetry=2048)
    # telemetry does not perturb the integration
    assert torch.equal(sol.y, plain.y)
    _reconciles(sol.telemetry, sol.stats, nsetups=method == "ensemble_bdf")
    if method != "ensemble_bdf":
        assert sol.telemetry.q.unique().tolist() == [2]
        assert not bool(sol.telemetry.lsetup_fired.any())
    s = sol.telemetry.summary()
    assert s["steps"] == int(sol.stats.steps.sum())
    assert s["h_hist_log10"]["counts"] and s["order_occupancy"]
    ref = rivp.integrate(_ref_problem(nsys, rates), 0.0, tf, method,
                         opts=RefOptions(rtol=RTOL, atol=ATOL),
                         telemetry=2048)
    _held_to_reference(sol, ref)


def test_scalar_bdf_telemetry_reconciles_and_matches_reference():
    rates = problems.robertson_rates(1, seed=0)
    pf, pjac, py0 = problems.batched_robertson(1, rates=rates, device="cpu")
    sf = lambda t, y: pf(torch.as_tensor(t).reshape(1), y[None, :])[0]
    sol = ivp.integrate(ivp.IVP(f=sf, y0=py0[0].clone()), 0.0, 0.2, "bdf",
                        opts=ODEOptions(rtol=RTOL, atol=ATOL, policy=CPU),
                        telemetry=1024, dense_jac=True)
    tel = sol.telemetry
    assert not tel.truncated and tel.t.shape == (int(sol.stats.attempts),)
    assert int(tel.steps()) == int(sol.stats.steps)
    assert int(tel.attempts()) == int(sol.stats.attempts)
    assert int(tel.newton_iters_total()) == int(sol.stats.nni)
    assert int(tel.lsetups()) == 0 and bool(tel.active.all())
    F, _, _, _ = rprob.robertson_family()
    p = {k: jnp.asarray(v) for k, v in rates.items()}
    rf = lambda t, y: F(jnp.asarray(t)[None], y[None, :], p)[0]
    ref = rivp.integrate(rivp.IVP(f=rf, y0=jnp.asarray([1.0, 0.0, 0.0])),
                         0.0, 0.2, "bdf", opts=RefOptions(rtol=RTOL, atol=ATOL),
                         telemetry=1024, dense_jac=True)
    assert int(ref.retcodes) == int(sol.retcodes) == 0
    y_ref = np.asarray(ref.y)
    assert np.all(np.abs(sol.y.numpy() - y_ref) <=
                  10 * (RTOL * np.abs(y_ref) + ATOL))
    # Robertson's scalar counters: within 10 % (ROADMAP queue C, the
    # compiled reference against the eager one)
    s_ref = int(ref.telemetry.steps())
    assert abs(int(tel.steps()) - s_ref) <= 0.1 * s_ref


@pytest.mark.parametrize("method", ["erk:dopri5", "adams",
                                    "ensemble_erk:bogacki_shampine"])
def test_telemetry_rejected_for_explicit_methods(method):
    f, jac, y0 = problems.batched_robertson(2, device="cpu")
    y = y0 if method.startswith("ensemble") else y0[0]
    with pytest.raises(ValueError, match="telemetry"):
        ivp.integrate(ivp.IVP(f=lambda t, y: -y, y0=y), 0.0, 1.0, method,
                      device="cpu", telemetry=64)
    # a context's telemetry switch skips the families without a ring
    ctx = Context(policy=CPU, observability=obs.ObservabilityConfig(
        telemetry=True))
    assert ivp.integrate(ivp.IVP(f=lambda t, y: -y, y0=y), 0.0, 0.1, method,
                         ctx=ctx).telemetry is None


def test_timed_integrate_spans_timings_and_events():
    nsys = 4
    rates = problems.robertson_rates(nsys, seed=1)
    ctx = Context(policy=CPU, observability=obs.ObservabilityConfig(
        profile=True, log_level="INFO", telemetry=True,
        telemetry_capacity=512))
    sol = ivp.integrate(_port_problem(nsys, rates), 0.0, 0.05,
                        "ensemble_bdf", ctx=ctx)
    assert set(sol.timings) == {"build", "execute"}
    assert sol.timings["build"] >= 0.0 and sol.timings["execute"] > 0.0
    names = [s.name for s in ctx.profiler.spans]
    assert names == ["integrate.build", "integrate.execute"]
    assert all(s.args == {"method": "ensemble_bdf"}
               for s in ctx.profiler.spans)
    done = [e for e in ctx.logger.events if e["event"] == "integrate.done"]
    assert len(done) == 1 and done[0]["steps"] == int(sol.stats.steps.sum())
    assert done[0]["nni"] == int(sol.nni) and done[0]["success"] == 1
    assert sol.telemetry is not None
    # explicit timed=False wins over the config; untimed has no timings
    assert ivp.integrate(_port_problem(nsys, rates), 0.0, 0.05,
                         "ensemble_bdf", ctx=ctx, timed=False).timings is None
    assert ivp.integrate(_port_problem(nsys, rates), 0.0, 0.05,
                         "ensemble_bdf", device="cpu").timings is None
    # a quarantined lane is logged as the reference logs it
    sol = ivp.integrate(_port_problem(nsys, rates), 0.0, 10.0,
                        "ensemble_bdf", ctx=ctx,
                        opts=ctx.options(rtol=RTOL, atol=ATOL, max_steps=5))
    failed = [e for e in ctx.logger.events
              if e["event"] == "integrate.lane_failed"]
    assert len(failed) == 1 and failed[0]["level"] == "WARNING"
    assert failed[0]["failed"] == nsys and failed[0]["nsys"] == nsys
    assert failed[0]["retcodes"] == {"TOO_MUCH_WORK": nsys}
    assert failed[0]["lanes"] == list(range(nsys))
