"""The port's multi-device layer against the JAX package, on the CPU.

``MeshVector`` in gspmd mode in one process; in explicit mode, and as a
``DTensor``, across 2 and 4 gloo ranks; ``ensemble_bdf_integrate_sharded``
across 4 gloo ranks and as a world of one; ``make_ensemble_mesh``.

The ranks are processes of their own (``python -c``), which meet through
a ``file://`` store under the test's ``tmp_path`` (no TCP port, so tests
running side by side never collide), run only PyTorch and the port, and
save what they computed for the test, which holds it to the reference.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batched as ref_batched
from repro.core import vector as ref_vector
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch.core import batched, vector
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.policies import ExecPolicy
from repro_torch.launch import mesh as lmesh

ROOT = Path(__file__).resolve().parents[1]
TORCH = ExecPolicy(backend="torch")
#: seconds a multi-rank test may take, its ranks' start included
RANK_TIMEOUT = 120

PRELUDE = """
import sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{TMP}/store",
                        rank=RANK, world_size=WORLD)
OUT = {}
"""
#: a rank saves its record after the last collective, then tears its
#: groups down (``collectives.close``: the groups of several mesh axes
#: first, then the default group with the rest)
EPILOGUE = """
dist.barrier()
torch.save(OUT, f"{TMP}/rank{RANK}.pt")
from repro_torch.parallel import collectives as _coll
_coll.close()
"""


def _run_ranks(tmp_path, world: int, body: str) -> list:
    """Run ``body`` in ``world`` gloo ranks (``RANK``, ``WORLD``, ``OUT``
    and ``dist`` defined); returns each rank's ``OUT``."""
    script = PRELUDE + textwrap.dedent(body) + EPILOGUE
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def _np(t):
    return np.asarray(t.detach().cpu() if torch.is_tensor(t) else t)


# ---------------------------------------------------------------------------
# MeshVector, gspmd mode, one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tensor", "tuple"])
def test_mesh_vector_gspmd_mode_matches_reference(kind):
    """The reference test's numbers (``tests/test_vector.py:85``) and
    every method, tensor and tuple data, under both backends."""
    rng = np.random.default_rng(0)
    a, b = np.arange(4.0), rng.normal(size=5)
    w1, w2 = np.abs(rng.normal(size=4)) + 0.5, np.abs(rng.normal(size=5)) + 0.5
    if kind == "tensor":
        data, wd = (a,), (w1,)
    else:
        data, wd = (a, b), (w1, w2)

    def ours(leaves, policy):
        ts = tuple(torch.from_numpy(x) for x in leaves)
        return vector.MeshVector(ts if kind == "tuple" else ts[0],
                                 vector.MeshVectorSpec(policy=policy))

    def ref(leaves):
        js = tuple(jnp.asarray(x) for x in leaves)
        return ref_vector.MeshVector(js if kind == "tuple" else js[0])

    def leaves(v):
        return [_np(x) for x in (v if isinstance(v, tuple) else (v,))]

    r, rw = ref(data), ref(wd)
    for policy in (None, TORCH):
        mv, mw = ours(data, policy), ours(wd, policy)
        for got, want in (
                (mv.linear_sum(2.0, 1.0, mv), r.linear_sum(2.0, 1.0, r)),
                (mv.scale(-3.0), r.scale(-3.0)), (mv.const(1.5), r.const(1.5)),
                (mv.prod(mw), r.prod(rw)), (mv.div(mw), r.div(rw)),
                (mv.abs(), r.abs()), (mw.inv(), rw.inv()),
                (mv.add_const(0.25), r.add_const(0.25))):
            for g, x in zip(leaves(got.data), leaves(want.data)):
                np.testing.assert_allclose(g, x, rtol=1e-12, atol=0)
        for got, want in ((mv.dot(mv), r.dot(r)), (mv.l1_norm(), r.l1_norm()),
                          (mv.max_norm(), r.max_norm()), (mv.min(), r.min()),
                          (mv.wrms_norm(mw), r.wrms_norm(rw)),
                          (mv.wrms_norm(mw, global_size=7),
                           r.wrms_norm(rw, global_size=7))):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12)
    # the reference test's own numbers
    mv = vector.MeshVector(torch.arange(4.0, dtype=torch.float64))
    assert torch.equal(mv.linear_sum(2.0, 1.0, mv).data,
                       3 * torch.arange(4.0, dtype=torch.float64))
    assert float(mv.dot(mv)) == 14.0
    assert np.isclose(float(mv.wrms_norm(mv.const(1.0))), np.sqrt(3.5))


def test_mesh_vector_spec_and_many_vector(monkeypatch):
    with pytest.raises(ValueError, match="unknown MeshVector mode"):
        vector.MeshVectorSpec(mode="shard_map")
    x = torch.ones(3)
    mv = vector.many_vector(x, (x, x))
    assert isinstance(mv, tuple) and mv[0] is x and mv[1][1] is x
    assert vector.many_vector_num_subvectors(mv) == \
        ref_vector.many_vector_num_subvectors(ref_vector.many_vector(1, 2)) \
        == 2
    # no communicator: explicit mode issues no collective
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: calls.append(a))
    spec = vector.MeshVectorSpec(mode="explicit")
    assert float(vector.MeshVector(x, spec).dot(vector.MeshVector(x, spec))) \
        == 3.0
    assert calls == []


# ---------------------------------------------------------------------------
# MeshVector, explicit mode and DTensors, across gloo ranks
# ---------------------------------------------------------------------------

N_VEC = 1003
#: uneven splits of the N_VEC elements over 2 and 4 ranks
SPLITS = {2: (0, 620, N_VEC), 4: (0, 100, 550, 551, N_VEC)}

EXPLICIT = """
from repro_torch.core import dispatch, vector
from repro_torch.core.policies import ExecPolicy
from repro_torch.launch.mesh import make_ensemble_mesh
cuts = %r
rng = np.random.default_rng(5)
x = torch.from_numpy(rng.normal(size=%d))
w = torch.from_numpy(np.abs(rng.normal(size=x.numel())) + 0.1)
lo, hi = cuts[RANK], cuts[RANK + 1]
calls = []
real = dist.all_reduce
def counted(*a, **k):
    calls.append(1)
    return real(*a, **k)
dist.all_reduce = counted
mesh = make_ensemble_mesh(device_type="cpu")
OUT["mesh"] = (type(mesh).__name__, mesh.mesh_dim_names, mesh.size())
for comm_name, comm in (("group", dist.group.WORLD), ("mesh", mesh)):
    for pol_name, pol in (("auto", None), ("torch", ExecPolicy(backend="torch"))):
        spec = vector.MeshVectorSpec(comm=comm, mode="explicit", policy=pol)
        mx = vector.MeshVector(x[lo:hi].clone(), spec)
        mw = vector.MeshVector(w[lo:hi].clone(), spec)
        res = {"linear_sum": mx.linear_sum(0.5, -2.0, mw).data}
        for name, fn in (("dot", lambda: mx.dot(mw)),
                         ("l1_norm", mx.l1_norm), ("max_norm", mx.max_norm),
                         ("min", mx.min),
                         ("wrms_norm", lambda: mx.wrms_norm(
                             mw, global_size=x.numel()))):
            before = len(calls)
            res[name] = fn()
            res[name + "_collectives"] = len(calls) - before
        OUT[comm_name, pol_name] = res
# gspmd mode over a DTensor sharded Shard(0)
from torch.distributed.tensor import Shard, distribute_tensor
dx = distribute_tensor(x, mesh, [Shard(0)])
dw = distribute_tensor(w, mesh, [Shard(0)])
torch_spec = vector.MeshVectorSpec(policy=ExecPolicy(backend="torch"))
mx, mw = vector.MeshVector(dx, torch_spec), vector.MeshVector(dw, torch_spec)
OUT["dtensor"] = {
    "dot": mx.dot(mw).full_tensor(), "l1_norm": mx.l1_norm().full_tensor(),
    "max_norm": mx.max_norm().full_tensor(), "min": mx.min().full_tensor(),
    "wrms_norm": mx.wrms_norm(mw).full_tensor(),
    "linear_sum": mx.linear_sum(0.5, -2.0, mw).data.full_tensor()}
errors = []
for pol in (None, ExecPolicy(backend="cuda")):
    spec = vector.MeshVectorSpec(policy=pol)
    for op in ("dot", "wrms_norm", "linear_sum"):
        mx, mw = vector.MeshVector(dx, spec), vector.MeshVector(dw, spec)
        try:
            {"dot": lambda: mx.dot(mw), "wrms_norm": lambda: mx.wrms_norm(mw),
             "linear_sum": lambda: mx.linear_sum(1.0, 1.0, mw)}[op]()
            errors.append((op, None))
        except (TypeError, ValueError) as e:
            errors.append((op, str(e)))
OUT["dtensor_errors"] = errors
"""


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_vector_explicit_mode_across_gloo_ranks(tmp_path, world):
    """Each reduction of the shards (split unevenly) equals the reference
    ``MeshVector`` on the whole vector within 1e-13 relative (max and
    min exactly) and issues exactly one collective; the shards' linear
    sum is the whole vector's bit for bit.  A ``DTensor`` in gspmd mode
    matches under ``backend="torch"`` and raises under the kernel
    backends."""
    outs = _run_ranks(tmp_path, world, EXPLICIT % (SPLITS[world], N_VEC))
    rng = np.random.default_rng(5)
    x = rng.normal(size=N_VEC)
    w = np.abs(rng.normal(size=N_VEC)) + 0.1
    r, rw = ref_vector.MeshVector(jnp.asarray(x)), \
        ref_vector.MeshVector(jnp.asarray(w))
    want = {"dot": r.dot(rw), "l1_norm": r.l1_norm(),
            "max_norm": r.max_norm(), "min": r.min(),
            "wrms_norm": r.wrms_norm(rw)}
    whole_sum = 0.5 * torch.from_numpy(x) + -2.0 * torch.from_numpy(w)
    np.testing.assert_allclose(_np(whole_sum),
                               np.asarray(r.linear_sum(0.5, -2.0, rw).data),
                               rtol=1e-15, atol=0)
    cuts = SPLITS[world]
    for rank, out in enumerate(outs):
        assert out["mesh"] == ("DeviceMesh", ("systems",), world)
        for key in (("group", "auto"), ("group", "torch"), ("mesh", "auto"),
                    ("mesh", "torch")):
            res = out[key]
            assert torch.equal(res["linear_sum"],
                               whole_sum[cuts[rank]:cuts[rank + 1]]), key
            for name, v in want.items():
                assert res[name + "_collectives"] == 1, (key, name)
                if name in ("max_norm", "min"):
                    assert float(res[name]) == float(v), (key, name)
                else:
                    np.testing.assert_allclose(float(res[name]), float(v),
                                               rtol=1e-13, err_msg=str(key))
        dt = out["dtensor"]
        for name, v in want.items():
            np.testing.assert_allclose(float(dt[name]), float(v), rtol=1e-13)
        assert torch.equal(dt["linear_sum"], whole_sum)
        for op, err in out["dtensor_errors"]:
            assert err is not None, f"{op} ran a DTensor on a kernel backend"
        assert any("DTensor" in err for _, err in out["dtensor_errors"])


# ---------------------------------------------------------------------------
# The sharded ensemble BDF
# ---------------------------------------------------------------------------

NSYS, N = 10, 3         # not divisible by 4 -> exercises the padding
RATES = np.linspace(10.0, 80.0, NSYS)
RTOL, ATOL = 1e-6, 1e-10


def _torch_problem():
    def f(t, y, prm):
        return -prm[:, None] * (y - torch.cos(t)[:, None])

    def jac(t, y, prm):
        return (-prm[:, None, None] * torch.eye(N, dtype=y.dtype)) \
            .expand(y.shape[0], N, N).contiguous()

    return f, jac


SHARDED = """
from repro_torch.core import batched
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.linsol import SPGMR
from repro_torch.launch.mesh import make_ensemble_mesh
nsys, n = %d, %d
rates = torch.from_numpy(np.linspace(10.0, 80.0, nsys))
def f(t, y, prm):
    return -prm[:, None] * (y - torch.cos(t)[:, None])
def jac(t, y, prm):
    return (-prm[:, None, None] * torch.eye(n, dtype=y.dtype)).expand(
        y.shape[0], n, n).contiguous()
y0 = torch.zeros((nsys, n), dtype=torch.float64)
opts = ODEOptions(rtol=%r, atol=%r)
mesh = make_ensemble_mesh(device_type="cpu")
local = []
real = batched.ensemble_bdf_integrate
def spy(*a, **k):
    out = real(*a, **k)
    local.append(out[1])
    return out
batched.ensemble_bdf_integrate = spy
y, st = batched.ensemble_bdf_integrate_sharded(
    f, jac, y0, 0.0, 2.0, params=rates, opts=opts, mesh=mesh)
OUT["direct"] = (y, tuple(st))       # (tensors only: torch.load's default)
y, st = batched.ensemble_bdf_integrate_sharded(
    f, jac, y0, 0.0, 2.0, params=rates, opts=opts, mesh=mesh,
    linear_solver=SPGMR(tol=1e-12, restart=30, max_restarts=6))
OUT["krylov"] = (y, tuple(st))
OUT["krylov_local"] = (int(local[-1].nli[0]), int(local[-1].npsolves[0]),
                       int(local[-1].nli.numel()))
"""


def _ref_run(**kw):
    rates = jnp.asarray(RATES)

    def f(t, y):
        return -rates[:, None] * (y - jnp.cos(t)[:, None])

    def jac(t, y):
        return jnp.broadcast_to(-rates[:, None, None] * jnp.eye(N),
                                (y.shape[0], N, N))

    return ref_batched.ensemble_bdf_integrate(
        f, jac, jnp.zeros((NSYS, N)), 0.0, 2.0,
        opts=RefOptions(rtol=RTOL, atol=ATOL), **kw)


def _unsharded_shards(world: int):
    """The port's unsharded runs of each rank's shard, padded as the
    sharded call pads (dummy lanes: the last row, tf = t0), joined: the
    sharded call's answer, bit for bit."""
    f, jac = _torch_problem()
    pad = (-NSYS) % world
    shard = (NSYS + pad) // world
    rates = torch.from_numpy(np.concatenate([RATES, RATES[-1:].repeat(pad)]))
    tf = torch.cat([torch.full((NSYS,), 2.0, dtype=torch.float64),
                    torch.zeros(pad, dtype=torch.float64)])
    ys, sts = [], []
    for lo in range(0, NSYS + pad, shard):
        p = rates[lo:lo + shard]
        y, st = batched.ensemble_bdf_integrate(
            lambda t, y: f(t, y, p), lambda t, y: jac(t, y, p),
            torch.zeros((shard, N), dtype=torch.float64), 0.0,
            tf[lo:lo + shard], opts=ODEOptions(rtol=RTOL, atol=ATOL))
        ys.append(y)
        sts.append(st)
    return torch.cat(ys)[:NSYS], [torch.cat(v)[:NSYS] for v in zip(*sts)]


def test_sharded_ensemble_bdf_on_four_gloo_ranks(tmp_path):
    """The reference test's problem (``tests/test_ensemble_bdf.py:229``)
    on 4 ranks, padded 10 -> 12.  y and every per-lane stat equal the
    port's unsharded runs of the same shards bit for bit; y lies within
    10*(rtol*|y|+atol) of the port's whole-batch run and of the
    reference, with equal success; under SPGMR every lane's nli is one
    global total, > 0, the sum of the ranks' own.

    (On the CPU the port's BDF rounds a lane by the batch's vector tail,
    so shards of 3 lanes leave the 10-lane run's bits: 4.5e-8 here.  On
    the card a lane's bits do not depend on the batch, and
    ``chip_smoke.py``'s path N holds the sharded run to the unsharded
    one bit for bit.)"""
    outs = _run_ranks(tmp_path, 4, SHARDED % (NSYS, N, RTOL, ATOL))
    f, jac = _torch_problem()
    rates = torch.from_numpy(RATES)
    y1, st1 = batched.ensemble_bdf_integrate(
        lambda t, y: f(t, y, rates), lambda t, y: jac(t, y, rates),
        torch.zeros((NSYS, N), dtype=torch.float64), 0.0, 2.0,
        opts=ODEOptions(rtol=RTOL, atol=ATOL))
    y_shards, st_shards = _unsharded_shards(4)
    y_ref, st_ref = _ref_run()
    bound = 10 * (RTOL * np.abs(np.asarray(y_ref)) + ATOL)
    for rank, out in enumerate(outs):
        y, st = out["direct"][0], batched.EnsembleStats(*out["direct"][1])
        assert y.shape == (NSYS, N) and st.steps.shape == (NSYS,)
        assert bool(st.success.all()) and bool(st.ok.all())
        assert torch.equal(y, y_shards)
        for name, a, b in zip(st._fields, st, st_shards):
            if name not in ("nli", "npsolves"):
                assert torch.equal(a, b), name
        assert np.all(np.abs(_np(y) - _np(y1))
                      <= 10 * (RTOL * np.abs(_np(y1)) + ATOL))
        assert np.all(np.abs(_np(y) - np.asarray(y_ref)) <= bound)
        np.testing.assert_array_equal(_np(st.success),
                                      np.asarray(st_ref.success))
        for other in outs:
            for a, b in zip(out["direct"][1], other["direct"][1]):
                assert (a is None and b is None) or torch.equal(a, b)
        yk, stk = out["krylov"][0], batched.EnsembleStats(*out["krylov"][1])
        nli = _np(stk.nli)
        assert len(np.unique(nli)) == 1 and nli[0] > 0
        assert nli[0] == sum(o["krylov_local"][0] for o in outs)
        assert _np(stk.npsolves)[0] == sum(o["krylov_local"][1] for o in outs)
        assert out["krylov_local"][2] == 3          # lanes a shard
        np.testing.assert_allclose(_np(yk), _np(y1), rtol=0, atol=1e-6)
        assert bool(stk.success.all())


def test_sharded_ensemble_bdf_world_of_one_is_the_unsharded_call():
    f, jac = _torch_problem()
    rates = torch.from_numpy(RATES)
    y0 = torch.zeros((NSYS, N), dtype=torch.float64)
    opts = ODEOptions(rtol=RTOL, atol=ATOL)
    mesh = lmesh.make_ensemble_mesh(device_type="cpu")
    assert isinstance(mesh, lmesh.WorldOfOne) and mesh.size() == 1
    y, st = batched.ensemble_bdf_integrate_sharded(
        f, jac, y0, 0.0, 2.0, params=rates, opts=opts, mesh=mesh)
    y1, st1 = batched.ensemble_bdf_integrate(
        lambda t, y: f(t, y, rates), lambda t, y: jac(t, y, rates), y0,
        0.0, 2.0, opts=opts)
    assert torch.equal(y, y1)
    for a, b in zip(st, st1):
        assert (a is None and b is None) or torch.equal(a, b)
    y_ref, st_ref = _ref_run()
    assert np.all(np.abs(_np(y) - np.asarray(y_ref))
                  <= 10 * (RTOL * np.abs(np.asarray(y_ref)) + ATOL))


#: a problem with no per-system data, for the calls without ``params``:
#: the lanes differ only in y0
K_DECAY = 40.0
Y0_FREE = np.linspace(0.0, 1.0, NSYS)[:, None] * np.arange(1.0, N + 1.0)

NO_PARAMS = """
from repro_torch.core import batched
from repro_torch.core.arkode import ODEOptions
from repro_torch.launch.mesh import make_ensemble_mesh
k, n = %r, %d
def f(t, y):
    return -k * (y - torch.cos(t)[:, None])
def jac(t, y):
    return (-k * torch.eye(n, dtype=y.dtype)).expand(
        y.shape[0], n, n).contiguous()
y, st = batched.ensemble_bdf_integrate_sharded(
    f, jac, torch.from_numpy(np.array(%r)), 0.0, 2.0,
    opts=ODEOptions(rtol=%r, atol=%r), mesh=make_ensemble_mesh(device_type="cpu"))
OUT["y"], OUT["st"] = y, tuple(st)
"""


def _no_params_problem():
    def f(t, y):
        return -K_DECAY * (y - torch.cos(t)[:, None])

    def jac(t, y):
        return (-K_DECAY * torch.eye(N, dtype=y.dtype)) \
            .expand(y.shape[0], N, N).contiguous()

    return f, jac


def _no_params_ref():
    return ref_batched.ensemble_bdf_integrate(
        lambda t, y: -K_DECAY * (y - jnp.cos(t)[:, None]),
        lambda t, y: jnp.broadcast_to(-K_DECAY * jnp.eye(N),
                                      (y.shape[0], N, N)),
        jnp.asarray(Y0_FREE), 0.0, 2.0,
        opts=RefOptions(rtol=RTOL, atol=ATOL))


def _assert_near_reference(y, st, y_ref, st_ref):
    y_ref = np.asarray(y_ref)
    assert y.shape == (NSYS, N)
    assert np.all(np.abs(_np(y) - y_ref)
                  <= 10 * (RTOL * np.abs(y_ref) + ATOL))
    np.testing.assert_array_equal(_np(st.success), np.asarray(st_ref.success))


def test_sharded_ensemble_bdf_without_params_on_four_gloo_ranks(tmp_path):
    """No ``params`` (the reference's default, as ``tests/test_chaos.py``
    calls it) on 4 ranks, padded 10 -> 12: every rank gathers the same
    y and stats, within 10*(rtol*|y|+atol) of the reference's
    ``ensemble_bdf_integrate`` and of the port's unsharded run, with
    equal success."""
    outs = _run_ranks(tmp_path, 4, NO_PARAMS % (K_DECAY, N, Y0_FREE.tolist(),
                                                RTOL, ATOL))
    y_ref, st_ref = _no_params_ref()
    f, jac = _no_params_problem()
    y1, st1 = batched.ensemble_bdf_integrate(
        f, jac, torch.from_numpy(Y0_FREE), 0.0, 2.0,
        opts=ODEOptions(rtol=RTOL, atol=ATOL))
    for out in outs:
        y, st = out["y"], batched.EnsembleStats(*out["st"])
        _assert_near_reference(y, st, y_ref, st_ref)
        _assert_near_reference(y, st, y1, st1)
        assert st.steps.shape == (NSYS,) and bool(st.ok.all())
        assert torch.equal(y, outs[0]["y"])


def test_sharded_ensemble_bdf_world_of_one_without_params():
    """No ``params`` in a world of one: exactly the unsharded call, and
    within 10*(rtol*|y|+atol) of the reference with equal success."""
    f, jac = _no_params_problem()
    y0 = torch.from_numpy(Y0_FREE)
    opts = ODEOptions(rtol=RTOL, atol=ATOL)
    y, st = batched.ensemble_bdf_integrate_sharded(
        f, jac, y0, 0.0, 2.0, opts=opts,
        mesh=lmesh.make_ensemble_mesh(device_type="cpu"))
    y1, st1 = batched.ensemble_bdf_integrate(f, jac, y0, 0.0, 2.0, opts=opts)
    assert torch.equal(y, y1)
    for a, b in zip(st, st1):
        assert (a is None and b is None) or torch.equal(a, b)
    _assert_near_reference(y, st, *_no_params_ref())


def test_sharded_ensemble_bdf_raises_the_reference_errors():
    f, jac = _torch_problem()
    y0 = torch.zeros((NSYS, N), dtype=torch.float64)
    mesh = lmesh.make_ensemble_mesh(device_type="cpu")
    ref_f = lambda t, y, p: y
    for kw, match in (({"f_soa": ref_f}, "takes the AoS f/jac only"),
                      ({"jac_soa": ref_f}, "takes the AoS f/jac only"),
                      ({"session": object()}, "takes no session="),
                      ({"return_session": True}, "takes no session=")):
        with pytest.raises(ValueError, match=match) as ours:
            batched.ensemble_bdf_integrate_sharded(
                f, jac, y0, 0.0, 1.0, params=torch.ones(NSYS), mesh=mesh, **kw)
        with pytest.raises(ValueError, match=match) as ref:
            ref_batched.ensemble_bdf_integrate_sharded(
                lambda t, y, p: y, lambda t, y, p: y, jnp.zeros((NSYS, N)),
                0.0, 1.0, **kw)
        assert str(ours.value) == str(ref.value)
    # f_soa=None is the unsharded API's documented default, not an error
    y, _ = batched.ensemble_bdf_integrate_sharded(
        f, jac, y0, 0.0, 0.1, params=torch.from_numpy(RATES), mesh=mesh,
        f_soa=None, jac_soa=None)
    assert y.shape == (NSYS, N)


def test_make_ensemble_mesh_without_a_group():
    m = lmesh.make_ensemble_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("systems",) and m.get_group() is None
    assert lmesh.mesh_device(m) == torch.device("cpu")
    with pytest.raises(ValueError, match="n_devices"):
        lmesh.make_ensemble_mesh(2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lmesh.make_ensemble_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            batched.ensemble_bdf_integrate_sharded(
                *_torch_problem(), torch.zeros((NSYS, N)), 0.0, 1.0,
                params=torch.ones(NSYS))


def test_the_multi_device_layer_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.launch.mesh, repro_torch.core.vector, "
            "repro_torch.core.batched, repro_torch.core.dispatch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                   timeout=RANK_TIMEOUT)
