"""``moe_ep_apply`` across 8 gloo ranks against the JAX package's.

The reference's EP test (``tests/test_distribution.py:82``): mesh
(data 2, model 4), dbrx-132b-smoke in float32.  The same numpy inputs go
through the reference's ``moe_ep_apply`` (a subprocess with 8 XLA host
devices) and through the port's in 8 gloo ranks, each rank with its
batch rows; all four token-layout x EP-axis cases (``split`` /
``replicated`` over ``model`` / ``('model', 'data')``), at cap factor
8.0 (no drops; also against the port's dense ``moe_dense_apply``) and
at 1.25 with routing skewed so that items drop (the same items must
drop: the bucket ranks follow the reference's item order); and the
``split`` layout with ``REPRO_MOE_FP8=1`` (the dispatch leg in
float8_e4m3fn in both packages).  Gate 2e-4, the reference's own
EP-against-dense gate.  One rank run and one reference run serve every
case (a module fixture).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distribution import _run_ranks

from repro_torch import configs
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
CASES = [(lay, ax, cap) for cap in (8.0, 1.25)
         for lay in ("split", "replicated")
         for ax in ("model", "model,data")] + [("fp8", "model", 8.0)]
GATE = 2e-4


def _case(lay, ax, cap):
    return f"{lay}-{ax.replace(',', '+')}-{cap}"


def _inputs(tmp):
    """x (4, 64, d) with a shared direction u; routers for 4 experts
    (single-axis EP) and 8 (multi-axis), plain and skewed towards expert
    0 along u."""
    cfg = configs.get("dbrx-132b-smoke")
    d, f = cfg.d_model, cfg.moe_d_ff
    rng = np.random.default_rng(0)
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    x = (0.1 * rng.normal(size=(4, 64, d)) + 0.3 * u).astype(np.float32)
    arrs = {"x": x}
    for E in (4, 8):
        r = 0.1 * rng.normal(size=(d, E))
        arrs[f"router{E}"] = r.astype(np.float32)
        skew = r.copy()
        skew[:, 0] += 5.0 * u
        arrs[f"skew{E}"] = skew.astype(np.float32)
        for n, shape in (("w1", (E, d, f)), ("w3", (E, d, f)),
                         ("w2", (E, f, d))):
            arrs[f"{n}_{E}"] = (rng.normal(size=shape) /
                                np.sqrt(shape[1])).astype(np.float32)
    np.savez(tmp / "inputs.npz", **arrs)
    return arrs


REF = """
import os
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models import moe_ep
a = dict(np.load(sys.argv[1] + "/inputs.npz"))
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for key in sys.argv[2:]:
    lay, ax, cap = key.split("-")
    os.environ["REPRO_MOE_FP8"] = "1" if lay == "fp8" else "0"
    lay = "split" if lay == "fp8" else lay
    E = 4 if ax == "model" else 8
    cfg = configs.get("dbrx-132b-smoke").replace(
        n_experts=E, moe_cap_factor=float(cap), dtype=jnp.float32)
    p = {"router": jnp.asarray(a[("router" if cap == "8.0" else "skew")
                                 + str(E)]),
         "w1": jnp.asarray(a[f"w1_{E}"]), "w3": jnp.asarray(a[f"w3_{E}"]),
         "w2": jnp.asarray(a[f"w2_{E}"])}
    ep = "model" if ax == "model" else ("model", "data")
    out[key] = np.asarray(jax.jit(lambda x: moe_ep.moe_ep_apply(
        p, cfg, x, mesh, dp_axes=("data",), ep_axis=ep,
        token_layout=lay))(jnp.asarray(a["x"])))
np.savez(sys.argv[1] + "/ref.npz", **out)
"""

RANKS = """
import os
import numpy as np
from repro_torch import configs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe_ep
a = {k: torch.from_numpy(v) for k, v in np.load(TMP + "/inputs.npz").items()}
mesh = make_debug_mesh(2, 4, device_type="cpu")
di = mesh.get_local_rank("data")
x = a["x"][2 * di:2 * di + 2]
for key in KEYS:
    lay, ax, cap = key.split("-")
    os.environ["REPRO_MOE_FP8"] = "1" if lay == "fp8" else "0"
    lay = "split" if lay == "fp8" else lay
    E = 4 if ax == "model" else 8
    cfg = configs.get("dbrx-132b-smoke").replace(
        n_experts=E, moe_cap_factor=float(cap), dtype=torch.float32)
    p = {"router": a[("router" if cap == "8.0" else "skew") + str(E)],
         "w1": a[f"w1_{E}"], "w3": a[f"w3_{E}"], "w2": a[f"w2_{E}"]}
    ep = "model" if ax == "model" else ("model", "data")
    stats = {}
    y = moe_ep.moe_ep_apply(p, cfg, x, mesh, dp_axes=("data",), ep_axis=ep,
                            token_layout=lay, stats=stats)
    OUT[key] = (y, torch.as_tensor(stats["dropped"]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    arrs = _inputs(tmp)
    keys = [_case(*c) for c in CASES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(tmp), *keys],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ranks = _run_ranks(tmp, 8, f"TMP = {str(tmp)!r}\nKEYS = {keys!r}\n"
                           + textwrap.dedent(RANKS))
        log = ref.communicate(timeout=300)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    want = dict(np.load(tmp / "ref.npz"))
    return arrs, ranks, want


def _gathered(ranks, key):
    """The (4, 64, d) output from the ranks' row blocks; every model
    replica of a block equal."""
    blocks = []
    for di in range(2):
        reps = [ranks[di * 4 + mi][key][0] for mi in range(4)]
        assert all(torch.equal(r, reps[0]) for r in reps[1:]), key
        blocks.append(reps[0])
    return torch.cat(blocks).numpy()


@pytest.mark.parametrize("lay,ax,cap", CASES)
def test_moe_ep_matches_reference(runs, lay, ax, cap):
    arrs, ranks, want = runs
    key = _case(lay, ax, cap)
    got = _gathered(ranks, key)
    err = float(np.max(np.abs(got - want[key])))
    assert err < GATE, (key, err)
    dropped = sum(int(r[key][1]) for r in ranks)
    if lay == "fp8":                     # the quantised leg is taken
        assert np.max(np.abs(got - _gathered(ranks, "split-model-8.0"))) \
            > 1e-3, key
    if cap == 1.25 and lay == "split":
        assert dropped > 0, key          # the skewed routing drops items
    if cap == 8.0 and lay != "fp8":
        assert dropped == 0, key
        E = 4 if ax == "model" else 8
        cfg = configs.get("dbrx-132b-smoke").replace(
            n_experts=E, dtype=torch.float32)
        p = {"router": torch.from_numpy(arrs[f"router{E}"])}
        p.update({n: torch.from_numpy(arrs[f"{n}_{E}"])
                  for n in ("w1", "w3", "w2")})
        dense = layers.moe_dense_apply(p, cfg, torch.from_numpy(arrs["x"]))
        assert float(np.max(np.abs(got - dense.numpy()))) < GATE, key
