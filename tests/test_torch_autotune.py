"""The port's analysis layer against the JAX package's, on the CPU: the
cost model's signatures and flops/bytes (``repro_torch.analysis.opcost``
against ``repro.analysis.opcost``), the persisted cache and the resolver
(``repro_torch.core.autotune`` against ``repro.core.autotune``), and the
port's own: the roofline row, the plain versions' launch counts,
``"auto"`` on the CPU (its decisions recorded, the kernel wrapper run),
``Context.autotune`` / ``dispatch_report`` and the autotune gauges."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import opcost as ropcost
from repro.core import autotune as rautotune
from repro.core import dispatch as rdv
from repro_torch import kernels
from repro_torch.analysis import opcost, roofline
from repro_torch.analysis.lint import default_contract_sigs
from repro_torch.core import autotune, dispatch as dv, ivp, problems
from repro_torch.core.context import Context
from repro_torch.core.policies import ExecPolicy
from repro_torch.observability import MetricsRegistry, context_metrics

SHARED_OPS = sorted(rdv.OP_TABLE)
CPU = ExecPolicy(device="cpu")
CARD = ExecPolicy(device="cuda:0")
H100_NAME = "NVIDIA H100 80GB HBM3"


def _fake_card(monkeypatch, name=H100_NAME):
    """Make ``torch.cuda`` report one card named ``name`` (the policy's
    and the resolvers' view of a card; nothing is launched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)


def _sig(op="dot", n=4096, **kw):
    return opcost.OpSig(op=op, dtype="float64", n=n, **kw)


def _ref_sig(sig):
    return ropcost.OpSig(**{f: getattr(sig, f) for f in
                            ("op", "dtype", "n", "nsys", "b", "k", "nnz")})


@functools.lru_cache(maxsize=1)
def _reference_grid_keys():
    """(op, reference key, port key) for every case of the reference
    tuner's grid (``benchmarks/autotune_bench.py`` ``_cases``): the
    reference's signature of its jnp arguments, the port's of torch
    tensors of the same shapes and dtypes (on the ``meta`` device) and
    the same numbers and patterns.  The grid's values are replaced by a
    constant (only shapes matter here), which keeps it to seconds."""
    from benchmarks import autotune_bench

    def to_torch(a):
        if isinstance(a, jax.Array):
            dtype = getattr(torch, str(a.dtype))
            return torch.empty(a.shape, dtype=dtype, device="meta")
        if isinstance(a, list):
            return [to_torch(x) for x in a]
        if isinstance(a, tuple):
            return tuple(to_torch(x) for x in a)
        return a

    normal = jax.random.normal
    jax.random.normal = lambda key, shape, *a, **k: jnp.full(shape, 0.5)
    try:
        out = []
        for op, args in autotune_bench._cases():
            out.append((op, ropcost.signature(op, args).key(),
                        opcost.signature(op, to_torch(args)).key()))
    finally:
        jax.random.normal = normal
    return tuple(out)


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", SHARED_OPS)
def test_signature_keys_equal_the_references_on_its_tuner_grid(op):
    rows = [r for r in _reference_grid_keys() if r[0] == op]
    assert rows
    for _, ref_key, port_key in rows:
        assert port_key == ref_key


def test_reference_grid_is_the_references_tuner_grid():
    assert [s.key() for s in autotune.reference_grid()] == \
        [r[1] for r in _reference_grid_keys()]
    # tune_grid measures it first, then the port's additions
    keys = [s.key() for s in autotune.tune_grid()]
    assert keys[:len(autotune.reference_grid())] == \
        [s.key() for s in autotune.reference_grid()]
    assert len(set(keys)) == len(keys)


@pytest.mark.parametrize("op", SHARED_OPS)
def test_op_cost_flops_and_bytes_equal_the_references(op):
    sigs = [s for s in autotune.reference_grid() if s.op == op] + \
        default_contract_sigs()[op]
    for sig in sigs:
        mine, ref = opcost.op_cost(sig), ropcost.op_cost(_ref_sig(sig))
        assert mine.flops == ref.flops, sig.key()
        assert mine.hbm_bytes == ref.hbm_bytes, sig.key()


def _twin_caches(tmp_path, seed=0):
    """A reference cache and a port cache of the same measurements over
    the reference's tuner grid (jnp <-> torch, pallas <-> cuda)."""
    rng = np.random.default_rng(seed)
    ref = rautotune.AutotuneCache("interpret", path=tmp_path / "ref.json")
    mine = autotune.AutotuneCache("h100_sxm", path=tmp_path / "port.json")
    for sig in autotune.reference_grid():
        a, b = rng.uniform(1e-5, 1e-3, size=2)
        ref.put(rautotune.Entry(sig=_ref_sig(sig), t_jnp=a, t_pallas=b))
        mine.put(autotune.Entry(sig=sig, t_torch=a, t_cuda=b))
    return ref, mine


BACKEND = {"jnp": "torch", "pallas": "cuda"}


def _queries():
    """Each grid signature as is, along its long axis x2 and /2 (within
    the nearest-entry range) and x32 (beyond it)."""
    out = []
    for sig in autotune.reference_grid():
        field = "nsys" if sig.op in opcost.BATCHED_OPS else "n"
        v = getattr(sig, field)
        for f in (1, 2, 0.5, 32):
            out.append((f, opcost.OpSig(**{**sig.__dict__,
                                           field: max(1, int(v * f))})))
    return out


@pytest.mark.parametrize("source", ["override", "cache", "near"])
def test_resolver_sources_resolve_as_the_references(tmp_path, source):
    ref_cache, port_cache = _twin_caches(tmp_path)
    ref = rautotune.Resolver("interpret", cache=ref_cache)
    mine = autotune.Resolver("h100_sxm", cache=port_cache)
    seen = 0
    for factor, sig in _queries():
        if source == "override":
            for be in ("jnp", "pallas"):
                r = ref.decide(_ref_sig(sig), override=be)
                m = mine.decide(sig, override=BACKEND[be])
                assert (m.source, m.backend) == (r.source, BACKEND[r.backend])
                seen += 1
            continue
        r, m = ref.decide(_ref_sig(sig)), mine.decide(sig)
        assert m.source == r.source, sig.key()
        if r.source == source:
            seen += 1
            assert m.backend == BACKEND[r.backend], sig.key()
            assert m.cached_winner == BACKEND[r.cached_winner]
        if source == "near":
            rn = ref_cache.nearest(_ref_sig(sig))
            mn = port_cache.nearest(sig)
            assert (rn is None) == (mn is None)
            if rn is not None:
                assert mn.sig.key() == rn.sig.key()
    assert seen > 0
    # the reference and the port memoize alike: one decision a signature
    assert {d.sig.key() for d in mine.decisions.values()} == \
        {d.sig.key() for d in ref.decisions.values()}


def test_model_audit_counts_as_the_references(tmp_path, monkeypatch):
    """Both audits over the twin caches, with one shared predictor in
    place of the two models (they model different devices): the same
    counts, agreement and mispredicted signatures."""
    ref_cache, port_cache = _twin_caches(tmp_path, seed=1)

    class Pred:
        def __init__(self, key, names):
            fast = sum(map(ord, key)) % 3 != 0
            self.winner = names[1] if fast else names[0]
            self.ratio = 2.0 if fast else 0.5

    monkeypatch.setattr(ropcost, "predict", lambda sig, dev, *a:
                        Pred(sig.key(), ("jnp", "pallas")))
    monkeypatch.setattr(opcost, "predict", lambda sig, dev:
                        Pred(sig.key(), ("torch", "cuda")))
    ra = rautotune.model_audit(ref_cache)
    pa = autotune.model_audit(port_cache)
    for k in ("model_agreement", "model_agree", "model_total"):
        assert pa[k] == ra[k]
    assert 0 < pa["model_agree"] < pa["model_total"]
    assert [(m["sig"], BACKEND[m["measured"]], BACKEND[m["predicted"]])
            for m in ra["mispredictions"]] == \
        [(m["sig"], m["measured"], m["predicted"])
         for m in pa["mispredictions"]]


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def _entry(sig, t_torch=1e-3, t_cuda=2e-3):
    return autotune.Entry(sig=sig, t_torch=t_torch, t_cuda=t_cuda)


def test_cache_round_trip(tmp_path):
    path = tmp_path / "h100_sxm.json"
    cache = autotune.AutotuneCache("h100_sxm", path=path)
    e1 = _entry(_sig(), t_torch=1e-4, t_cuda=9e-4)               # plain wins
    e2 = _entry(_sig(op="block_solve_soa", n=3, nsys=512, b=3),
                t_torch=5e-3, t_cuda=1e-4)                       # kernel wins
    cache.put(e1)
    cache.put(e2)
    assert cache.save() == path
    fresh = autotune.AutotuneCache("h100_sxm", path=path).load()
    assert not fresh.stale
    assert set(fresh.entries) == {e1.sig.key(), e2.sig.key()}
    assert fresh.get(e2.sig).winner == "cuda" and fresh.get(e2.sig).sig == e2.sig
    assert fresh.get(e1.sig).winner == "torch"
    assert json.loads(path.read_text())["device"] == "h100_sxm"


def test_cache_schema_bump_invalidates(tmp_path):
    path = tmp_path / "h100_sxm.json"
    cache = autotune.AutotuneCache("h100_sxm", path=path)
    cache.put(_entry(_sig()))
    cache.save()
    payload = json.loads(path.read_text())
    payload["schema"] = autotune.SCHEMA_VERSION + 1
    path.write_text(json.dumps(payload))
    stale = autotune.AutotuneCache("h100_sxm", path=path).load()
    assert stale.entries == {} and stale.stale
    payload["schema"] = autotune.SCHEMA_VERSION
    payload["device"] = "another_row"
    path.write_text(json.dumps(payload))
    wrong = autotune.AutotuneCache("h100_sxm", path=path).load()
    assert wrong.entries == {} and wrong.stale


def test_cache_corrupt_entries_dropped_not_fatal(tmp_path):
    path = tmp_path / "h100_sxm.json"
    cache = autotune.AutotuneCache("h100_sxm", path=path)
    good = _entry(_sig())
    cache.put(good)
    cache.save()
    payload = json.loads(path.read_text())
    payload["entries"]["mismatched-key"] = good.to_json()
    payload["entries"]["garbage"] = {"no": "fields"}
    path.write_text(json.dumps(payload))
    loaded = autotune.AutotuneCache("h100_sxm", path=path).load()
    assert loaded.stale and set(loaded.entries) == {good.sig.key()}
    path.write_text("{not json")
    broken = autotune.AutotuneCache("h100_sxm", path=path).load()
    assert broken.entries == {} and not broken.stale
    cold = autotune.AutotuneCache("h100_sxm",
                                  path=tmp_path / "nope.json").load()
    assert cold.entries == {} and not cold.stale


def test_resolver_model_fallback_memo_and_nearest_range(tmp_path):
    empty = autotune.AutotuneCache("h100_sxm", path=tmp_path / "no.json")
    res = autotune.Resolver("h100_sxm", cache=empty)
    dec = res.decide(_sig())
    assert (dec.source, dec.backend) == ("model", "cuda")
    assert dec.cached_winner is None and dec.agree is None
    assert res.decide(_sig()) is dec and dec.hits == 2
    cache = autotune.AutotuneCache("h100_sxm", path=tmp_path / "c.json")
    cache.put(_entry(_sig(op="wrms_soa", n=3, nsys=4096), 1e-4, 5e-4))
    res = autotune.Resolver("h100_sxm", cache=cache)
    hit = res.decide(_sig(op="wrms_soa", n=3, nsys=4096))
    assert (hit.source, hit.backend, hit.agree) == ("cache", "torch", False)
    near = res.decide(_sig(op="wrms_soa", n=3, nsys=4096 * 8))
    assert (near.source, near.backend) == ("near", "torch")
    far = res.decide(_sig(op="wrms_soa", n=3, nsys=4096 * 9))
    assert (far.source, far.backend) == ("model", "cuda")
    other = res.decide(_sig(op="wrms_soa", n=4, nsys=4096 * 8))
    assert other.source == "near"       # the state length is not structure
    rep = res.report()
    assert rep["cache_entries"] == 1 and rep["model_total"] == 1
    assert rep["model_agreement"] == 0.0 and len(rep["mispredictions"]) == 1


def test_cpu_resolver_records_the_plain_version():
    res = autotune.Resolver(autotune.CPU)
    dec = res.decide(_sig(op="wrms_soa", n=3, nsys=64))
    assert (dec.source, dec.backend, dec.model_winner) == \
        ("cpu", "torch", "torch")
    assert res.report()["model_agreement"] is None
    with pytest.raises(ValueError, match="unknown roofline device"):
        autotune.get_resolver("tpu_v5e")


class _Census(TorchDispatchMode):
    """Counts the aten calls that launch a kernel: not a view, not an
    allocation, not a scalar read, not a profiler range."""

    SILENT = {"aten.empty.memory_format", "aten.empty_like.default",
              "aten.empty_strided.default", "aten.new_empty.default",
              "aten._local_scalar_dense.default", "aten.lift_fresh.default",
              "aten.promote_types.default", "aten._unsafe_view.default"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not func.is_view and name not in self.SILENT and \
                not name.startswith("profiler."):
            self.calls.append(name)
        return func(*args, **(kwargs or {}))


#: ops whose plain version reads the host in its control flow (the CSR
#: SpMV sizes its ELL slots from the longest row)
DATA_DEPENDENT = {"csr_spmv"}


@pytest.mark.parametrize("op", sorted(set(dv.OP_TABLE) - DATA_DEPENDENT))
def test_plain_launch_counts_equal_the_aten_calls(op):
    gen = torch.Generator().manual_seed(0)
    sigs = default_contract_sigs()[op] + [
        s for s in autotune.reference_grid() if s.op == op
        and (s.nsys or s.n) <= 4096]
    for sig in sigs:
        args = autotune.args_for(sig, "cpu", gen)
        plain = dv.OP_TABLE[op]["torch"]
        plain(*args)                        # cached constants made once
        with _Census() as census:
            plain(*args)
        assert len(census.calls) == opcost.op_cost(sig).plain_launches, \
            (sig.key(), census.calls)


def test_window_pattern_has_the_entries_and_the_diagonal():
    for n, nnz in ((4, 10), (133, 659), (40, 160), (7, 23), (5, 25)):
        indptr, indices = autotune.window_pattern(n, nnz)
        assert indptr[-1] == nnz == len(indices)
        for i in range(n):
            row = indices[indptr[i]:indptr[i + 1]]
            assert i in row and len(set(row)) == len(row)
            assert list(row) == sorted(row)
    band = autotune.window_pattern(133, 5 * 133 - 6)
    assert all(abs(i - j) <= 2 for i in range(133)
               for j in band[1][band[0][i]:band[0][i + 1]])
    with pytest.raises(ValueError):
        autotune.window_pattern(3, 10)


#: the port's own ops, in their port_grid order
PORT_OWN = ("lagrange_rescale_soa", "newton_residual_lsolve_soa",
            "newton_update_soa", "newton_block_inverse_soa")


def test_tune_grid_covers_every_op_and_gives_back_its_keys():
    grid = autotune.tune_grid()
    assert {s.op for s in grid} == set(dv.OP_TABLE)
    assert [s.key() for s in autotune.port_grid()] == \
        [s.key() for s in grid if s.op in PORT_OWN]
    for sig in grid:
        args = autotune.args_for(sig, "meta")
        assert opcost.signature(sig.op, args) == sig


def test_the_model_picks_the_kernel_at_every_grid_shape():
    """The model's advice over the tuner's default grid: the kernels
    everywhere (what the card measured there: PERF.md's tuned winners)."""
    for sig in autotune.tune_grid():
        pred = opcost.predict(sig, "h100_sxm")
        assert pred.winner == "cuda" and pred.ratio >= 1.0, sig.key()


def test_roofline_row_and_device_for(monkeypatch):
    assert set(roofline.DEVICES) == {"h100_sxm"}
    row = roofline.get_device("h100_sxm")
    assert (row.peak_flops, row.hbm_bw) == (34e12, 3.35e12)
    assert row.smem_optin_bytes == 232448 and row.max_block_threads == 1024
    assert 0 < row.kernel_launch < 1e-4 and 0 < row.plain_launch < 1e-4
    assert row.bw("cuda") == row.cuda_bw and row.bw("torch") == row.torch_bw
    for gone in ("vmem_bytes", "pallas_step", "interp_op", "interpret"):
        assert not hasattr(row, gone)
    with pytest.raises(ValueError, match="unknown roofline device"):
        roofline.get_device("tpu_v5e")
    with pytest.raises(ValueError, match="not a CUDA device"):
        roofline.device_for("cpu")
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA A100-SXM4-80GB"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: names[i])
    assert roofline.device_for("cuda:0") == "h100_sxm"
    assert roofline.device_for(0) == "h100_sxm"
    with pytest.raises(ValueError, match="h100_sxm"):
        roofline.device_for("cuda:1")


def test_policy_roofline_field_and_device_name(monkeypatch):
    """The policy names no row: its context reports the resolver of its
    device's card (``"cpu"`` off the card, ``"no-row"`` for a card with
    no row), and a default one needs CUDA."""
    assert not hasattr(ExecPolicy(), "roofline")
    assert CPU.device_name() == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExecPolicy().device_name()
    _fake_card(monkeypatch)
    assert CARD.device_name() == "h100_sxm"
    _fake_card(monkeypatch, "NVIDIA H100 PCIe")
    assert CARD.device_name() == autotune.NO_ROW
    with pytest.raises(ValueError, match="no roofline row"):
        roofline.device_for("cuda:0")


def test_auto_dispatch_memoizes_per_call_shape():
    autotune.reset_resolver()
    x, y = torch.ones(16, dtype=torch.float64), torch.ones(32,
                                                           dtype=torch.float64)
    for v in (x, x, y, x):
        dv.dot(v, v, CPU)
    res = autotune.get_resolver(autotune.CPU)
    hits = {d.sig.n: d.hits for d in res.decisions.values()}
    assert hits == {16: 3, 32: 1}
    # one callable an op, whatever the policy's device
    fn = dv.dispatch("dot", CPU)
    assert fn is dv.dispatch("dot") and fn is dv.dispatch("dot", CARD)
    # a tuple vector of 16 elements keys apart, and hits the same decision
    parts = (x[:8], x[8:])
    assert float(fn(parts, parts)) == 16.0
    assert res.decisions[_sig(n=16, k=1).key()].hits == 4
    autotune.reset_resolver()
    assert not any(autotune._MEMO.values()) and autotune._RESOLVERS == {}


def test_auto_runs_the_kernel_wrapper_whatever_the_decision(tmp_path,
                                                           monkeypatch):
    """A cache in which the plain version wins makes the decision
    ``torch`` (source ``cache``), reported; the call still goes to the
    kernel wrapper: only a pin reaches the plain version on the card."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path))
    sig = _sig(op="wrms_soa", n=3, nsys=64)
    cache = autotune.AutotuneCache("h100_sxm")
    cache.put(_entry(sig, 1e-6, 2e-6))
    cache.save()
    autotune.reset_resolver()
    monkeypatch.setattr(autotune, "row_of", lambda device: "h100_sxm")
    ran = []
    kernel = dv.OP_TABLE["wrms_soa"]["cuda"]
    monkeypatch.setitem(dv.OP_TABLE["wrms_soa"], "cuda",
                        lambda *a: ran.append("cuda") or kernel(*a))
    monkeypatch.setitem(dv.OP_TABLE["wrms_soa"], "torch",
                        lambda *a: ran.append("torch"))
    auto = dv._auto("wrms_soa")
    v = torch.rand(3, 64, dtype=torch.float64)
    for _ in range(3):
        auto(v, v)
    assert ran == ["cuda"] * 3
    dec = autotune.get_resolver("h100_sxm").decisions[sig.key()]
    assert (dec.backend, dec.source, dec.hits) == ("torch", "cache", 3)
    autotune.reset_resolver()


def test_a_card_without_a_row_runs_its_kernels_and_reports(monkeypatch):
    """A Hopper card the table has no row of (an H100 PCIe) records
    ``no-row`` decisions that take the kernel, and its context reports
    and exports them; ``device_for`` still raises for it."""
    autotune.reset_resolver()
    _fake_card(monkeypatch, "NVIDIA H100 PCIe")
    res = autotune.get_resolver(autotune.NO_ROW)
    dec = res.decide(_sig(op="wrms_soa", n=3, nsys=64))
    assert (dec.backend, dec.source, dec.model_winner, dec.agree) == \
        ("cuda", "no-row", None, None)
    ctx = Context(policy=CARD)
    assert ctx.autotune is res
    rep = ctx.dispatch_report()
    assert rep["device"] == "no-row" and rep["cache_entries"] == 0
    assert rep["model_agreement"] is None
    reg = MetricsRegistry()
    context_metrics(reg, ctx)
    assert "repro_autotune_decisions_total 1" in reg.render()
    autotune.reset_resolver()


def _key_args(sig):
    return autotune.args_for(sig, "meta")


@pytest.mark.parametrize("op", sorted(dv.OP_TABLE))
def test_call_keys_determine_the_signature(op):
    """Dispatch memoizes a decision under a call's key: over the
    contract grid and the tuner's, equal keys come with equal
    signatures and distinct signatures with distinct keys."""
    sigs = default_contract_sigs()[op] + [
        s for s in autotune.tune_grid() if s.op == op]
    by_key = {}
    for sig in sigs:
        key = dv._CALL_KEYS[op](_key_args(sig))
        assert key == dv._CALL_KEYS[op](_key_args(sig))
        assert by_key.setdefault(key, sig) == sig, (key, sig)
    assert len(by_key) == len({s.key() for s in sigs})


def test_auto_main_path_on_the_cpu_is_the_torch_run_bit_for_bit():
    autotune.reset_resolver()
    nsys = 16
    rates = problems.robertson_rates(nsys, seed=0)
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    prob = ivp.IVP(f=f, jac=jac, y0=y0)
    ctx = Context(policy=CPU)
    kernels.reset_counts()
    sol = ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf", ctx=ctx)
    plain_calls = sum(c for _, c in kernels.counts().values())
    ref = ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf",
                        ctx=Context(policy=ExecPolicy(device="cpu",
                                                      backend="torch")))
    assert torch.equal(sol.y, ref.y)
    for a, b in zip(sol.stats, ref.stats):
        assert (a is None and b is None) or torch.equal(a, b)
    rep = ctx.dispatch_report()
    assert rep["device"] == "cpu" and rep["cache_entries"] == 0
    decs = rep["decisions"]
    assert {d["op"] for d in decs} == {
        "newton_update_soa", "lagrange_rescale_soa", "wrms_soa",
        "newton_block_inverse_soa"}
    assert all((d["source"], d["backend"]) == ("cpu", "torch") for d in decs)
    assert sum(d["hits"] for d in decs) == plain_calls > 0


def test_context_autotune_and_dispatch_report(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Context().dispatch_report()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset_resolver()
    cache = autotune.AutotuneCache("h100_sxm")
    assert cache.path == tmp_path / "h100_sxm.json"
    cache.put(_entry(_sig(op="wrms_soa", n=3, nsys=4096), 5e-4, 1e-4))
    cache.save()
    _fake_card(monkeypatch)
    ctx = Context(policy=CARD)
    assert ctx.autotune is autotune.get_resolver("h100_sxm")
    dec = ctx.autotune.decide(_sig(op="wrms_soa", n=3, nsys=4096))
    assert (dec.source, dec.backend, dec.agree) == ("cache", "cuda", True)
    rep = ctx.dispatch_report()
    assert rep["device"] == "h100_sxm" and rep["cache_entries"] == 1
    assert rep["cache_path"] == str(cache.path)
    assert rep["model_agreement"] == 1.0 and rep["mispredictions"] == []
    assert "trace_cache" not in rep

    class Cache:
        def stats(self):
            return {"hits": 3, "misses": 1}
    ctx.trace_cache = Cache()
    assert ctx.dispatch_report()["trace_cache"] == {"hits": 3, "misses": 1}
    assert Context(policy=CPU).autotune is autotune.get_resolver("cpu")
    autotune.reset_resolver()


def test_context_metrics_exports_the_autotune_gauges(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset_resolver()
    cache = autotune.AutotuneCache("h100_sxm")
    for n in (4096, 8192):
        cache.put(_entry(_sig(n=n), 3e-5, 2e-5))
    cache.save()
    _fake_card(monkeypatch)
    ctx = Context(policy=CARD)
    ctx.autotune.decide(_sig(n=4096))
    reg = MetricsRegistry()
    context_metrics(reg, ctx)
    text = reg.render()
    assert "repro_autotune_cache_entries 2" in text
    assert "repro_autotune_decisions_total 1" in text
    assert "repro_autotune_model_agreement 1" in text
    autotune.reset_resolver()


def test_tune_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.tune(cases=[_sig()])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.main(["--tune", "--reps", "1"])
