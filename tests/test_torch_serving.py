"""The port's serving tier (``repro_torch.serve.solver``), its problem
families and ``integrate(live=...)``, against the JAX package's.

The queue and the bundle cache are driven through the same operations
as the reference's (``tests/test_serving.py``'s cases, one port test
each) and must give the same answers under a fixed clock.  The
families' callables agree with the reference's at 1e-14.  The end-to-end
case sends the same mixed traffic (40 Robertson and 20 decay-chain
requests, bucket sizes (16, 32), and a four-leg warm stream) through
both servers on the CPU: y within 10*(rtol*|y|+atol), equal retcodes,
per-lane steps within 10 % (ROADMAP queue C: compiled step sequences
hinge on the last bit; the warm stream in its cumulative steps), and
the same metrics keys.  The reference
server is module-scoped so that JAX compiles each bundle shape once.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import problems as rprob
from repro.serve import solver as rsolver
from repro_torch.core import ivp, problems
from repro_torch.core.batched import SolverSession
from repro_torch.core.context import Context
from repro_torch.core.policies import ExecPolicy
from repro_torch.observability import MetricsRegistry, context_metrics
from repro_torch.serve.solver import (AdmissionQueue, Bundle, IVPRequest,
                                      ProblemFamily, RetryAfter,
                                      SolverServer, TraceCache, TraceKey,
                                      bucket_key, bucket_sizes_from_bench,
                                      tolerance_class)
from repro_torch.serve.solver.queue import DEFAULT_BUCKET_SIZES

ROB_PARAMS = {"k1": 0.04, "k2": 1.2e4, "k3": 3e7}


def _req(family="robertson", n=3, rtol=1e-6, atol=1e-9, tf=0.2,
         method="ensemble_bdf", ref=False):
    mod = rsolver if ref else None
    cls = mod.IVPRequest if ref else IVPRequest
    y0 = jnp.zeros(n) if ref else np.zeros(n)
    return cls(family=family, y0=y0, t0=0.0, tf=tf, rtol=rtol, atol=atol,
               method=method)


def _queues(**kw):
    """The port's queue and the reference's, built alike."""
    return AdmissionQueue(**kw), rsolver.AdmissionQueue(**kw)


def _bundles(bundles):
    return [(b.key.family, b.live, b.nsys, b.flushed) for b in bundles]


def _server(**kw):
    fr = problems.robertson_family()
    fd = problems.decay_chain_family(6)
    kw.setdefault("device", "cpu")
    return SolverServer(
        [ProblemFamily("robertson", 3, *fr), ProblemFamily("decay6", 6, *fd)],
        **kw)


# ---------------------------------------------------------------------------
# admission queue (tests/test_serving.py TestAdmissionQueue, case by case)
# ---------------------------------------------------------------------------

class TestAdmissionQueue:
    def test_tolerance_class(self):
        assert tolerance_class(1e-6, 1e-9) == (-6, -9)
        assert tolerance_class(5e-6, 2e-9) == (-6, -9)
        assert tolerance_class(1e-7, 1e-9) == (-7, -9)
        for bad in ((0.0, 1e-9), (1e-6, 2.0)):
            with pytest.raises(ValueError):
                tolerance_class(*bad)
        for rtol in (1e-3, 3e-5, 1e-5, 9.99e-7, 1e-10):
            for atol in (1e-6, 1e-10, 4e-12):
                assert tolerance_class(rtol, atol) == \
                    rsolver.tolerance_class(rtol, atol)

    def test_bucketing_key_splits(self):
        d = "float64"
        base = bucket_key(_req(), d)
        assert bucket_key(_req(rtol=3e-6), d) == base
        assert bucket_key(_req(rtol=1e-4), d) != base
        assert bucket_key(_req(family="x"), d) != base
        assert bucket_key(_req(n=6), d) != base
        assert bucket_key(_req(method="ensemble_dirk"), d) != base
        for kw in ({}, {"rtol": 3e-6}, {"family": "x"}, {"n": 6},
                   {"method": "ensemble_dirk"}, {"atol": 1e-12}):
            assert dataclasses.astuple(bucket_key(_req(**kw), d)) == \
                dataclasses.astuple(rsolver.bucket_key(_req(ref=True, **kw),
                                                       d))

    def test_flush_on_max_batch(self):
        out = []
        for q, ref in zip(_queues(bucket_sizes=(4, 8), max_batch=4,
                                  clock=lambda: 0.0), (False, True)):
            for _ in range(6):
                q.offer(_req(ref=ref), now=0.0)
            out.append((_bundles(q.poll(now=0.0)), q.depth))
        assert out[0] == out[1] == ([("robertson", 4, 4, 0.0)], 2)

    def test_flush_on_max_wait_and_padding(self):
        out = []
        for q, ref in zip(_queues(bucket_sizes=(4, 8), max_batch=8,
                                  max_wait=1e-3), (False, True)):
            for _ in range(3):
                q.offer(_req(ref=ref), now=0.0)
            early = q.poll(now=5e-4)
            late = q.poll(now=2e-3)
            out.append((early, _bundles(late), late[0].occupancy, q.depth))
        assert out[0] == out[1] == ([], [("robertson", 3, 4, 2e-3)], 0.75, 0)

    def test_staleness_clock_restarts_at_new_head(self):
        out = []
        for q, ref in zip(_queues(bucket_sizes=(2, 4), max_batch=2,
                                  max_wait=1.0), (False, True)):
            for t in (0.0, 0.0, 0.9):
                q.offer(_req(ref=ref), now=t)
            out.append([len(q.poll(now=t)) for t in (0.95, 1.5, 2.0)])
        assert out[0] == out[1] == [1, 0, 1]

    def test_backpressure_retry_after(self):
        out = []
        for q, ref in zip(_queues(bucket_sizes=(64,), max_depth=2,
                                  max_wait=1e-3), (False, True)):
            q.offer(_req(ref=ref), now=0.0)
            q.offer(_req(ref=ref), now=0.0)
            with pytest.raises(RuntimeError) as ei:
                q.offer(_req(ref=ref), now=0.0)
            exc = ei.value
            q.poll(now=1.0)
            q.offer(_req(ref=ref), now=1.0)
            out.append((type(exc).__name__, exc.retry_after, exc.depth,
                        exc.max_depth, q.rejected, q.depth))
        assert out[0] == out[1]
        assert out[0][1] > 0 and out[0][2] == 2 and out[0][4:] == (1, 1)

    def test_bucket_sizes_from_bench(self, tmp_path):
        assert DEFAULT_BUCKET_SIZES == rsolver.queue.DEFAULT_BUCKET_SIZES
        assert bucket_sizes_from_bench("/nonexistent.json") == \
            DEFAULT_BUCKET_SIZES
        p = tmp_path / "bench.json"
        p.write_text(json.dumps({"results": [
            {"nsys": 512, "plain_systems_per_sec": 1.0,
             "kernel_systems_per_sec": 2.0},               # sweet spot
            {"nsys": 4096, "plain_systems_per_sec": 1.0,
             "kernel_systems_per_sec": 2.0},               # > max_size
            {"nsys": 256, "plain_systems_per_sec": 2.0,
             "kernel_systems_per_sec": 1.0},               # loses
        ]}))
        assert bucket_sizes_from_bench(str(p)) == (64, 128, 256, 512)
        assert bucket_sizes_from_bench(str(p), max_size=4096,
                                       fill=(16,)) == (16, 512, 4096)
        # the reference's interpret-mode rows are not the card's: the
        # port reads only its own keys, and falls back without them
        p.write_text(json.dumps({"results": [
            {"nsys": 32, "jnp_systems_per_sec": 1.0,
             "pallas_interpret_systems_per_sec": 2.0}]}))
        assert bucket_sizes_from_bench(str(p)) == DEFAULT_BUCKET_SIZES

    def test_server_default_buckets_are_not_read_from_a_file(self):
        srv = _server()
        assert srv.queue.bucket_sizes == DEFAULT_BUCKET_SIZES
        assert srv.dtype == "float64"


# ---------------------------------------------------------------------------
# bundle cache (tests/test_serving.py TestTraceCache, case by case)
# ---------------------------------------------------------------------------

class TestTraceCache:
    @staticmethod
    def _key(i, ref=False):
        mod = rsolver if ref else None
        key = (mod.TraceKey if ref else TraceKey)
        bk = (mod.bucket_key if ref else bucket_key)
        return key(bucket=bk(_req(n=3 + i, ref=ref), "float64"), nsys=8,
                   policy=None)

    def test_hit_miss_evict_counters(self):
        stats = []
        for cache, ref in ((TraceCache(maxsize=2), False),
                           (rsolver.TraceCache(maxsize=2), True)):
            built = []
            cache.get(self._key(0, ref), lambda: built.append(0) or "a")
            entry, hit = cache.get(self._key(0, ref),
                                   lambda: built.append(1) or "b")
            assert entry == "a" and hit and built == [0]
            cache.get(self._key(1, ref), lambda: "c")
            cache.get(self._key(2, ref), lambda: "d")
            assert self._key(0, ref) not in cache and len(cache) == 2
            stats.append(cache.stats())
        assert stats[0] == stats[1] == {"hits": 1, "misses": 3,
                                        "evictions": 1, "size": 2,
                                        "hit_rate": 0.25}

    def test_lru_touch_refreshes(self):
        c = TraceCache(maxsize=2)
        c.get(self._key(0), lambda: "a")
        c.get(self._key(1), lambda: "b")
        c.get(self._key(0))
        c.get(self._key(2), lambda: "c")
        assert self._key(0) in c and self._key(1) not in c
        assert c.keys() == (self._key(0), self._key(2))

    def test_miss_without_a_build_raises(self):
        with pytest.raises(KeyError):
            TraceCache().get(self._key(0))

    def test_context_metrics_export_the_cache_once_a_server_attaches(self):
        ctx = Context(policy=ExecPolicy(device="cpu"))
        reg = MetricsRegistry()
        context_metrics(reg, ctx)
        assert "repro_trace_cache" not in reg.render()
        srv = _server(ctx=ctx, bucket_sizes=(4,), max_batch=4)
        assert ctx.trace_cache is srv.cache
        fut = srv.submit("robertson", [1.0, 0.0, 0.0], 0.0, 0.05,
                         params=ROB_PARAMS)
        srv.drain()
        assert bool(fut.result(timeout=5).success)
        reg = MetricsRegistry()
        context_metrics(reg, ctx)
        text = reg.render()
        for line in ("repro_trace_cache_hits_total 0",
                     "repro_trace_cache_misses_total 1",
                     "repro_trace_cache_evictions_total 0",
                     "repro_trace_cache_size 1"):
            assert line + "\n" in text, line
        assert "repro_trace_cache_misses_total 1\n" in \
            srv.metrics_prometheus()


# ---------------------------------------------------------------------------
# the problem families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["robertson", "decay6"])
def test_families_match_the_reference(family):
    rng = np.random.default_rng(7)
    nsys = 37
    if family == "robertson":
        port, ref, n = problems.robertson_family(), \
            rprob.robertson_family(), 3
        params = {"k1": rng.uniform(0.01, 0.1, nsys),
                  "k2": 1e4 * (0.5 + rng.uniform(size=nsys)),
                  "k3": 3e7 * 10.0 ** rng.uniform(-1, 1, nsys)}
        y = np.abs(rng.normal(size=(nsys, n))) * [1.0, 1e-5, 0.1]
    else:
        port, ref, n = problems.decay_chain_family(6), \
            rprob.decay_chain_family(6), 6
        params = {"k": rng.uniform(0.1, 5.0, (nsys, n))}
        y = rng.uniform(size=(nsys, n))
    t = rng.uniform(size=nsys)
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    for i, yy in ((0, y), (1, y), (2, y.T.copy()), (3, y.T.copy())):
        got = port[i](torch.from_numpy(t), torch.from_numpy(yy), pp)
        want = np.asarray(ref[i](jnp.asarray(t), jnp.asarray(yy), rp))
        assert got.shape == want.shape and got.dtype == torch.float64
        assert np.allclose(got.numpy(), want, rtol=1e-14, atol=1e-14), i
    assert port[3](torch.from_numpy(t), torch.from_numpy(y.T.copy()),
                   pp).is_contiguous()


# ---------------------------------------------------------------------------
# integrate(live=...): padded-lane hygiene
# ---------------------------------------------------------------------------

def test_padding_invariance_and_masked_stats():
    """13 live systems padded to 16, the dead lanes replicating the last
    live system with tf = t0 (the serving layout).

    The dead lanes change no live lane: the live lanes are bit for bit
    those of the same 16-lane program with every lane live.  Against the
    unpadded 13-lane run they agree within 10*(rtol*|y|+atol) with equal
    retcodes, the port's gate between two programs: on the CPU,
    PyTorch's sum over the history's rows (``batched.py`` predictor and
    psi) takes another order in a lane count's vector tail, so 13 and 16
    lanes round differently.  On the card every op is lane-local, and
    ``tests/test_torch_cuda.py::test_server_bundles_match_a_direct_
    kernel_run_on_card`` (200 lanes padded to 256) and ``chip_smoke.py``
    path M (16000 padded to 16384) hold padded lanes to the unpadded run
    with equal per-lane steps, nni and retcodes.  The dead lanes are
    zeroed out of the stats and the telemetry; the aggregates count live
    work only.
    """
    live_n, pad_n, tf, rtol, atol = 13, 16, 0.3, 1e-6, 1e-9
    rates = problems.robertson_rates(live_n, seed=3)
    f, jac, y0 = problems.batched_robertson(live_n, rates=rates,
                                            device="cpu")
    ref = ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, tf,
                        "ensemble_bdf", device="cpu")
    prates = {k: np.concatenate([v, np.repeat(v[-1:], pad_n - live_n)])
              for k, v in rates.items()}
    fp, jp, y0p = problems.batched_robertson(pad_n, rates=prates,
                                             device="cpu")
    mask = np.arange(pad_n) < live_n
    tfv = torch.from_numpy(np.where(mask, tf, 0.0))
    sol = ivp.integrate(ivp.IVP(f=fp, jac=jp, y0=y0p), 0.0, tfv,
                        "ensemble_bdf", device="cpu", live=mask,
                        telemetry=512)
    every = ivp.integrate(ivp.IVP(f=fp, jac=jp, y0=y0p), 0.0, tf,
                          "ensemble_bdf", device="cpu")
    st, rst, est = sol.stats, ref.stats, every.stats
    assert torch.equal(sol.y[:live_n], every.y[:live_n])
    for name in ("steps", "attempts", "nni", "nsetups", "netf", "ncfn",
                 "retcodes"):
        assert torch.equal(getattr(st, name)[:live_n],
                           getattr(est, name)[:live_n]), name
        assert not getattr(st, name)[live_n:].any(), name
    bound = 10 * (rtol * ref.y.abs() + atol)
    assert bool(((sol.y[:live_n] - ref.y).abs() <= bound).all())
    assert torch.equal(st.retcodes[:live_n], rst.retcodes)
    assert bool(st.success[live_n:].all()) and bool(st.ok[live_n:].all())
    assert int(sol.nni) == int(st.nni[:live_n].sum())
    assert int(sol.nsetups.sum()) == int(est.nsetups[:live_n].sum())
    assert bool(sol.success) == bool(ref.success)
    assert sol.telemetry.steps().tolist() == st.steps.tolist()
    assert not sol.telemetry.newton_iters_total()[live_n:].any()


def test_masked_stats_are_the_references():
    from repro.core.batched import EnsembleStats as RefStats
    from repro_torch.core.batched import EnsembleStats
    rng = np.random.default_rng(2)
    n = 9
    ints = {k: rng.integers(0, 50, n).astype(np.int32)
            for k in ("steps", "attempts", "netf", "nni", "nsetups", "ncfn",
                      "nli", "npsolves")}
    rc = np.where(rng.uniform(size=n) < 0.3, -4, 0).astype(np.int32)
    success = rng.uniform(size=n) < 0.6
    live = rng.uniform(size=n) < 0.5
    port = EnsembleStats(
        **{k: torch.from_numpy(v) for k, v in ints.items()},
        success=torch.from_numpy(success), retcodes=torch.from_numpy(rc),
        ok=torch.from_numpy(rc == 0)).masked(live)
    ref = RefStats(**{k: jnp.asarray(v) for k, v in ints.items()},
                   success=jnp.asarray(success), retcodes=jnp.asarray(rc),
                   ok=jnp.asarray(rc == 0)).masked(live)
    for name in port._fields:
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def test_live_mask_rejected_for_scalar_methods():
    with pytest.raises(ValueError, match="live"):
        ivp.integrate(ivp.IVP(f=lambda t, y: -y,
                              y0=torch.ones(2, dtype=torch.float64)),
                      0.0, 1.0, "erk:dopri5", live=np.array([True]),
                      device="cpu")


# ---------------------------------------------------------------------------
# _assemble: cold lanes in one call, warm lanes gathered
# ---------------------------------------------------------------------------

def _per_request_bundle(reqs, nsys):
    """The reference's construction: one SolverSession.cold a cold
    request, the warm handles as they are, the last lane repeated into
    the padding, joined by concat."""
    lanes = [r.session if r.session is not None else
             SolverSession.cold(torch.as_tensor(r.y0)[None, :], r.t0)
             for r in reqs]
    npad = nsys - len(reqs)
    sess = SolverSession.concat(lanes + [lanes[-1]] * npad)
    tfa = torch.cat([torch.tensor([r.tf for r in reqs], dtype=torch.float64),
                     sess.t[-1:].expand(npad)])
    return sess, tfa


def test_assemble_equals_per_request_sessions_bit_for_bit():
    srv = _server(bucket_sizes=(8, 16), max_batch=16)
    rng = np.random.default_rng(0)
    futs = [srv.submit("robertson", [1.0, 0.0, 0.0], 0.0, 0.05 + 0.01 * i,
                       params={**ROB_PARAMS, "k2": 1e4 * (1 + i)})
            for i in range(6)]
    srv.drain()
    sols = [f.result(timeout=5) for f in futs]
    # a handle that is a copy, not a view of a bundle's session
    loose = SolverSession(*(x.clone() for x in sols[4].session))
    warm = [sols[3].session, sols[0].session, loose, sols[5].session]
    for pattern in ("cwcwwcc", "wwww", "ccc", "wcw"):
        reqs, it = [], iter(warm)
        for j, kind in enumerate(pattern):
            s = next(it) if kind == "w" else None
            y0 = rng.uniform(size=3) if s is None else s.Z[0, :, 0]
            reqs.append(IVPRequest(
                family="robertson", y0=np.asarray(y0), t0=0.01 * j,
                tf=0.5 + j, params={"k1": 0.04, "k2": float(1e4 + j),
                                    "k3": 3e7}, session=s))
        for nsys in (len(reqs), 16):
            bundle = Bundle(key=bucket_key(reqs[0], "float64"),
                            requests=reqs, nsys=nsys, flushed=0.0)
            sess, tfa, params = srv._assemble(bundle)
            want, want_tf = _per_request_bundle(reqs, nsys)
            for a, b in zip(sess, want):
                assert a.dtype == b.dtype and torch.equal(a, b), pattern
            assert torch.equal(tfa, want_tf)
            assert params["k2"].tolist() == [float(1e4 + j)
                                             for j in range(len(reqs))] + \
                [float(1e4 + len(reqs) - 1)] * (nsys - len(reqs))


def test_warm_lanes_of_one_bundle_are_found_as_views():
    """The handles the server hands out record their bundle session and
    lane; ``_join_warm`` gathers those of one bundle with one
    ``index_select`` a leaf and joins any other handle by ``concat``,
    with the bits of the per-request ``concat``."""
    from repro_torch.core.batched import EnsembleStats
    from repro_torch.serve.solver.server import _join_warm
    s = SolverSession.cold(torch.arange(12.0, dtype=torch.float64)
                           .reshape(4, 3), 0.5)
    st = EnsembleStats(*(torch.zeros(4) for _ in EnsembleStats._fields))
    lanes = [lane[3] for lane in
             SolverServer._lane_views(s.Z[0].T, st, s, 4)]
    assert [(h.origin is s, h.lane) for h in lanes] == \
        [(True, i) for i in range(4)]
    assert all(isinstance(h, SolverSession) for h in lanes)
    # a view made by hand is not a served handle
    hand = SolverSession(*(x.split(1, dim=-1)[1] for x in s))
    joined, order = _join_warm([lanes[2], hand, lanes[0], lanes[3]],
                               torch.device("cpu"))
    assert order == [0, 2, 3, 1]
    for a, b in zip(joined, SolverSession.concat([lanes[2], lanes[0],
                                                  lanes[3], hand])):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the port's server on the CPU (tests/test_serving.py TestSolverServer)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    srv = _server(bucket_sizes=(4,), max_batch=4, max_wait=1e-3,
                  warmup_bundles=4)
    yield srv
    srv.stop()


def _submit_rob(srv, tf=0.2, session=None, y0=(1.0, 0.0, 0.0), t0=0.0):
    return srv.submit("robertson", list(y0), t0, tf, params=ROB_PARAMS,
                      session=session)


class TestSolverServer:
    def test_mixed_bundle_end_to_end(self, server):
        futs = [_submit_rob(server) for _ in range(3)]
        futs.append(server.submit("decay6", np.ones(6), 0.0, 0.5,
                                  params={"k": np.linspace(0.5, 3.0, 6)}))
        assert server.drain() == 2
        sols = [f.result(timeout=5) for f in futs]
        assert all(bool(s.success) for s in sols)
        assert sols[0].y.shape == (3,) and sols[-1].y.shape == (6,)
        assert torch.equal(sols[0].y, sols[1].y)
        fr = problems.robertson_family()
        pb = {k: torch.full((1,), v, dtype=torch.float64)
              for k, v in ROB_PARAMS.items()}
        direct = ivp.integrate(
            ivp.IVP(f=lambda t, y: fr[0](t, y, pb),
                    jac=lambda t, y: fr[1](t, y, pb),
                    y0=torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)),
            0.0, 0.2, "ensemble_bdf", device="cpu")
        assert np.allclose(sols[0].y.numpy(), direct.y[0].numpy(),
                           rtol=1e-10, atol=1e-12)

    def test_timings_and_cache_reuse(self, server):
        _submit_rob(server)      # the robertson@4 runner exists after this
        server.drain()
        stats0 = server.cache.stats()
        futs = [_submit_rob(server) for _ in range(4)]
        server.drain()
        s = futs[0].result(timeout=5)
        assert set(s.timings) == {"queue_wait", "compile", "execute"}
        assert s.timings["queue_wait"] >= 0.0
        assert s.timings["execute"] > 0.0
        assert s.timings["compile"] == 0.0
        stats1 = server.cache.stats()
        assert stats1["hits"] == stats0["hits"] + 1
        assert stats1["misses"] == stats0["misses"]
        assert server.metrics()["steady_misses"] == 0

    def test_warm_start_via_server(self, server):
        f1 = _submit_rob(server, tf=0.4)
        server.drain()
        s1 = f1.result(timeout=5)
        assert s1.session is not None and s1.session.nsys == 1
        leg = dict(tf=float(s1.t) + 0.4, y0=s1.y.numpy(), t0=float(s1.t))
        f_warm = _submit_rob(server, session=s1.session, **leg)
        f_cold = _submit_rob(server, **leg)
        server.drain()
        warm, cold = f_warm.result(timeout=5), f_cold.result(timeout=5)
        assert int(warm.stats.steps) < int(cold.stats.steps)
        assert bool(warm.success) and bool(cold.success)
        assert np.allclose(warm.y.numpy(), cold.y.numpy(), rtol=1e-4)

    def test_backpressure_propagates(self):
        fr = problems.robertson_family()
        srv = SolverServer([ProblemFamily("robertson", 3, fr[0], fr[1])],
                           device="cpu", bucket_sizes=(4,), max_batch=4,
                           max_depth=2)
        _submit_rob(srv)
        _submit_rob(srv)
        with pytest.raises(RetryAfter):
            _submit_rob(srv)

    def test_submit_validation(self, server):
        with pytest.raises(ValueError, match="unknown family"):
            server.submit("nope", np.ones(3), 0.0, 1.0)
        with pytest.raises(ValueError, match="y0 shape"):
            server.submit("robertson", np.ones(4), 0.0, 1.0)
        with pytest.raises(ValueError, match="single-lane"):
            server.submit("robertson", np.ones(3), 0.0, 1.0,
                          session=SolverSession.cold(
                              torch.ones((2, 3), dtype=torch.float64), 0.0))

    def test_metrics_and_context_metrics(self, server):
        for _ in range(2):       # a miss (or a hit), then a hit
            _submit_rob(server)
            server.drain()
        m = server.metrics()
        for k in ("queue_depth", "rejected", "requests", "bundles",
                  "occupancy", "latency_p50_s", "latency_p99_s",
                  "steady_misses", "trace_cache"):
            assert k in m
        assert 0.0 < m["occupancy"] <= 1.0
        assert m["trace_cache"]["hits"] > 0
        assert server.ctx.trace_cache is server.cache
        prom = server.metrics_prometheus()
        assert f"repro_serve_requests_total {m['requests']}\n" in prom
        assert (f"repro_trace_cache_hits_total "
                f"{m['trace_cache']['hits']}\n") in prom

    def test_async_facade(self, server):
        with server:
            fut = _submit_rob(server)
            sol = fut.result(timeout=30)
        assert bool(sol.success)


def test_server_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    fr = problems.robertson_family()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolverServer([ProblemFamily("robertson", 3, fr[0], fr[1])])


# ---------------------------------------------------------------------------
# end to end against the reference server, on the CPU
# ---------------------------------------------------------------------------

def _traffic(rng_seed=0):
    """The demo's mixed burst: 40 Robertson, 20 decay-chain requests."""
    rng = np.random.default_rng(rng_seed)
    rob = [{"k1": 0.04, "k2": 1e4 * (0.5 + rng.random()),
            "k3": 3e7 * 10.0 ** rng.uniform(-1, 1)} for _ in range(40)]
    dec = [{"k": rng.uniform(0.1, 5.0, 6)} for _ in range(20)]
    return rob, dec


def _serve(srv, rob, dec, to_y0, stream_params):
    """The burst, drained, then a four-leg warm stream."""
    futs = [srv.submit("robertson", [1.0, 0.0, 0.0], 0.0, 0.4, params=p)
            for p in rob]
    futs += [srv.submit("decay6", np.ones(6), 0.0, 1.0, params=p)
             for p in dec]
    srv.drain()
    burst = [f.result(timeout=60) for f in futs]
    sol, legs = None, []
    for leg in range(4):
        fut = srv.submit(
            "robertson", [1.0, 0.0, 0.0] if sol is None else to_y0(sol.y),
            0.0 if sol is None else float(sol.t), 0.3 * (leg + 1),
            params=stream_params,
            session=None if sol is None else sol.session)
        srv.drain()
        sol = fut.result(timeout=60)
        legs.append(sol)
    return burst, legs


@pytest.fixture(scope="module")
def reference_run():
    fr, fd = rprob.robertson_family(), rprob.decay_chain_family(6)
    srv = rsolver.SolverServer(
        [rsolver.ProblemFamily("robertson", 3, *fr),
         rsolver.ProblemFamily("decay6", 6, *fd)],
        bucket_sizes=(16, 32), max_batch=32, max_wait=2e-3)
    rob, dec = _traffic()
    rp = [{k: jnp.asarray(v) for k, v in p.items()} for p in rob]
    dp = [{k: jnp.asarray(v) for k, v in p.items()} for p in dec]
    burst, legs = _serve(srv, rp, dp, np.asarray, ROB_PARAMS)
    yield srv, burst, legs
    srv.stop()


def _hold(port_sols, ref_sols, steps=True, rtol=1e-6, atol=1e-9):
    """y within 10*(rtol*|y|+atol), retcodes equal, and (``steps``) the
    per-lane steps within 10 %."""
    for p, r in zip(port_sols, ref_sols):
        ry = np.asarray(r.y)
        bound = 10 * (rtol * np.abs(ry) + atol)
        assert (np.abs(p.y.numpy() - ry) <= bound).all()
        assert int(p.retcodes) == int(np.asarray(r.retcodes)) == 0
        ps, rs = int(p.stats.steps), int(np.asarray(r.stats.steps))
        assert not steps or abs(ps - rs) <= 0.1 * rs, (ps, rs)


def test_server_matches_the_reference_server(reference_run):
    rsrv, rburst, rlegs = reference_run
    srv = _server(bucket_sizes=(16, 32), max_batch=32, max_wait=2e-3)
    rob, dec = _traffic()
    burst, legs = _serve(srv, rob, dec, lambda y: y, ROB_PARAMS)
    _hold(burst, rburst)
    # a warm leg resumes at the step its previous leg exported, which was
    # cut to land on that leg's end (ROADMAP queue B): its step count
    # hinges on where the previous leg's last step fell, so the stream
    # is held per leg in y and retcodes and in its cumulative steps
    _hold(legs, rlegs, steps=False)
    got = int(legs[-1].session.steps)
    want = int(np.asarray(rlegs[-1].session.steps)[0])
    assert abs(got - want) <= 0.1 * want, (got, want)
    for sols in (legs, rlegs):
        first = int(np.asarray(sols[0].stats.steps))
        assert all(int(np.asarray(s.stats.steps)) < first for s in sols[1:])
    for p, r in zip(burst + legs, rburst + rlegs):
        assert set(p.timings) == set(r.timings)
        assert (p.method, p.lin_solver, p.nonlin_solver) == \
            (r.method, r.lin_solver, r.nonlin_solver)
    m, rm = srv.metrics(), rsrv.metrics()
    assert set(m) == set(rm)
    assert set(m["trace_cache"]) == set(rm["trace_cache"])
    for k in ("requests", "bundles", "live_lanes", "padded_lanes",
              "failures", "degraded", "steady_misses", "queue_depth"):
        assert m[k] == rm[k], k
    assert m["trace_cache"]["misses"] == rm["trace_cache"]["misses"]
    prom_names = {ln.split()[2] for ln in srv.metrics_prometheus()
                  .splitlines() if ln.startswith("# TYPE")}
    ref_names = {ln.split()[2] for ln in rsrv.metrics_prometheus()
                 .splitlines() if ln.startswith("# TYPE")}
    # the reference also exports its autotuner's gauges (ROADMAP A.8)
    assert prom_names == {n for n in ref_names
                          if not n.startswith("repro_autotune")}


def test_serve_solver_demo_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_solver_demo
    out = serve_solver_demo.main(["--device", "cpu", "--robertson", "6",
                                  "--decay", "3"])
    assert all(bool(s.success) for s in out["burst"])
    assert out["stream_steps"][1] < out["stream_steps"][0]
    assert out["metrics"]["failures"] == {}
    assert "bundle cache" in capsys.readouterr().out
