"""The scalar stack's N_Vector kernels' plain versions and dispatch ops
against the JAX reference.

``scale_add_multi`` (PERF.md row 13), ``wrms_ss`` (row 14),
``wrms_mask_ss`` (row 15) and ``dot_prod_multi`` (row 17): what the
port's wrappers run for CPU tensors, held to the reference's Pallas
kernels in interpret mode (``repro.kernels.ops``) and to its oracles
(``repro.kernels.ref``) on the same float64 inputs from a numpy seed, at
ragged lengths.  Then the five dispatch ops ``wrms_norm``, ``wrms_ss``,
``wrms_norm_mask``, ``scale_add_multi`` and ``dot_prod_multi`` against
the reference's ``repro.core.dispatch`` (jnp and Pallas-interpret
policies) over one tensor and over a tuple of tensors.  Sums are held
to 1e-10 of the sum of their terms' magnitudes (the two packages sum in
different orders), streaming results to 1e-10 absolutely on O(1) data.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import dispatch as rdv
from repro.core.policies import ExecPolicy as RefPolicy
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro_torch import kernels
from repro_torch.core import dispatch as dv
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import vecops

PALLAS = RefPolicy(backend="pallas", interpret=True)
NS = [130, 8193, 3 * 4099]
KS = [1, 2, 3, 5]
#: |port - reference| <= REL * sum |terms| for the reductions
REL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _vectors(n, K, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=n), "w": np.abs(rng.normal(size=n)) + 0.1,
            "m": (rng.uniform(size=n) > 0.3).astype(float),
            "Y": rng.normal(size=(K, n)), "c": rng.normal(size=K)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", NS)
def test_wrms_sums_match_reference(n, masked):
    v = _vectors(n, 1, n)
    terms = v["x"] * v["w"] * (v["m"] if masked else 1.0)
    scale = float((terms * terms).sum())
    t = {k: torch.from_numpy(v[k]) for k in ("x", "w", "m")}
    j = {k: jnp.asarray(v[k]) for k in ("x", "w", "m")}
    if masked:
        got = vecops.wrms_mask_ss(t["x"], t["w"], t["m"])
        wants = (kops.wrms_mask_ss(j["x"], j["w"], j["m"], interpret=True),
                 kref.wrms_mask_partial_ref(j["x"], j["w"], j["m"]))
    else:
        got = vecops.wrms_ss(t["x"], t["w"])
        wants = (kops.wrms_ss(j["x"], j["w"], interpret=True),
                 kref.wrms_partial_ref(j["x"], j["w"]))
    assert got.shape == ()
    for want in wants:
        assert abs(float(got) - float(want)) <= REL * scale


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("n", NS)
def test_scale_add_multi_matches_reference(n, K):
    v = _vectors(n, K, 10 * n + K)
    c, x, Y = v["c"], v["x"], v["Y"]
    want_pl = kops.scale_add_multi(jnp.asarray(c), jnp.asarray(x),
                                   jnp.asarray(Y), interpret=True)
    want_ref = kref.scale_add_multi_ref(jnp.asarray(c), jnp.asarray(x),
                                        jnp.asarray(Y))
    ys = [torch.from_numpy(y) for y in Y]
    # the coefficients as a (K,) tensor, as 0-d tensors and as numbers
    for form in (torch.from_numpy(c), [torch.tensor(a) for a in c],
                 c.tolist()):
        got = vecops.scale_add_multi(form, torch.from_numpy(x), ys)
        assert got.shape == (K, n)
        for want in (want_pl, want_ref):
            np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                       atol=1e-10)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("n", NS)
def test_dot_prod_multi_matches_reference(n, K):
    v = _vectors(n, K, 20 * n + K)
    x, Y = v["x"], v["Y"]
    scale = np.abs(Y * x[None, :]).sum(axis=1)
    got = vecops.dot_prod_multi(torch.from_numpy(x),
                                [torch.from_numpy(y) for y in Y])
    assert got.shape == (K,)
    for want in (kops.dot_prod_multi(jnp.asarray(x), jnp.asarray(Y),
                                     interpret=True),
                 kref.dot_prod_multi_ref(jnp.asarray(x), jnp.asarray(Y))):
        assert np.all(np.abs(_np(got) - _np(want)) <= REL * scale)


def test_multi_vector_ops_refuse_more_than_the_kernel_takes():
    """The kernels take at most MULTI_MAX_K vectors; the wrappers refuse
    more on every device, so a CPU run accepts only what the card does."""
    x = torch.ones(4)
    ys = [torch.ones(4)] * (vecops.MULTI_MAX_K + 1)
    with pytest.raises(ValueError, match="1 to 8"):
        vecops.dot_prod_multi(x, ys)
    with pytest.raises(ValueError, match="1 to 8"):
        vecops.scale_add_multi([1.0] * len(ys), x, ys)
    assert torch.equal(vecops.dot_prod_multi(x, ys[:8]), torch.full((8,), 4.))


def _structure(kind, arrays, conv):
    """One vector as a single (5, 26) array or as a tuple of a (3, 10)
    and a (70,) leaf, from 130 numbers."""
    if kind == "tensor":
        return conv(arrays.reshape(5, 26))
    return (conv(arrays[:30].reshape(3, 10)), conv(arrays[30:]))


def _flat(v):
    return np.concatenate([_np(leaf).ravel() for leaf in
                           (v if isinstance(v, tuple) else (v,))])


@pytest.mark.parametrize("policy", ["jnp", "pallas"])
@pytest.mark.parametrize("kind", ["tensor", "tuple"])
@pytest.mark.parametrize("op", ["wrms_norm", "wrms_ss", "wrms_norm_mask",
                                "scale_add_multi", "dot_prod_multi"])
def test_dispatch_ops_match_reference_dispatch(op, kind, policy):
    """The port's dispatch ops (plain and kernel-wrapper backends on the
    CPU) against the reference's, leaf by leaf over tuples."""
    v = _vectors(130, 3, 7)
    ref_pol = PALLAS if policy == "pallas" else None

    def vec(name, conv):
        return _structure(kind, v[name], conv)

    def ys(conv):
        return [_structure(kind, y, conv) for y in v["Y"]]

    def call(mod, conv, pol):
        if op == "wrms_norm_mask":
            return mod.wrms_norm_mask(vec("x", conv), vec("w", conv),
                                      vec("m", conv), pol)
        if op in ("wrms_norm", "wrms_ss"):
            return getattr(mod, op)(vec("x", conv), vec("w", conv), pol)
        if op == "scale_add_multi":
            return mod.scale_add_multi(list(v["c"]), vec("x", conv),
                                       ys(conv), pol)
        return mod.dot_prod_multi(vec("x", conv), ys(conv), pol)

    want = call(rdv, jnp.asarray, ref_pol)
    for backend in ("torch", "auto"):
        kernels.reset_counts()
        got = call(dv, torch.from_numpy, ExecPolicy(backend=backend))
        if op == "scale_add_multi":
            assert len(got) == 3
            for g, w in zip(got, want):
                assert isinstance(g, tuple) == (kind == "tuple")
                np.testing.assert_allclose(_flat(g), _flat(w), rtol=0,
                                           atol=1e-10)
        else:
            assert _np(got).shape == np.shape(want)
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12,
                                       atol=0)
        # on the CPU both backends run the plain versions
        assert all(c[0] == 0 for c in kernels.counts().values())


def test_wrms_norm_mask_divides_by_every_entry():
    """N counts the masked entries too (the reference's vector.py:202),
    over every leaf of a tuple."""
    x = (torch.full((3,), 2.0, dtype=torch.float64),
         torch.full((5,), 2.0, dtype=torch.float64))
    w = tuple(torch.ones_like(leaf) for leaf in x)
    m = (torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64),
         torch.zeros(5, dtype=torch.float64))
    got = dv.wrms_norm_mask(x, w, m)
    assert float(got) == pytest.approx(np.sqrt(4.0 / 8))
    assert float(dv.wrms_norm(x, w)) == pytest.approx(2.0)


def test_reductions_follow_the_leaves_result_type():
    """A float32 leaf beside a float64 one: every leaf is cast to the
    result type, as the reference's Pallas wrappers do."""
    x = (torch.ones(4, dtype=torch.float32), torch.ones(3, dtype=torch.float64))
    w = (torch.full((4,), 0.5, dtype=torch.float32),
         torch.full((3,), 0.5, dtype=torch.float64))
    assert dv.wrms_ss(x, w).dtype == torch.float64
    assert float(dv.wrms_ss(x, w)) == pytest.approx(7 * 0.25)
    got = dv.dot_prod_multi(x, [w, w])
    assert got.dtype == torch.float64 and got.shape == (2,)
    assert np.allclose(_np(got), 3.5)


def test_long_linear_combinations_chain_in_the_reference_order():
    """More terms than one launch takes (ARK324's 9-term stage sum)
    chain with the partial sum carried in at coefficient 1: the same
    bits as the plain sequential sum."""
    rng = np.random.default_rng(3)
    c, X = rng.normal(size=9), rng.normal(size=(9, 50))
    xs = [torch.from_numpy(x) for x in X]
    got = dv.linear_combination(list(c), xs, ExecPolicy(backend="torch"))
    acc = c[0] * X[0]
    for k in range(1, 9):
        acc = acc + c[k] * X[k]
    assert np.array_equal(_np(got), acc)
    want = rdv.linear_combination(list(c), [jnp.asarray(x) for x in X])
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-12)
