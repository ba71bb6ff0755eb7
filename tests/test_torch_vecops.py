"""The port's vector kernels' plain versions against the JAX reference.

``linear_combination`` (PERF.md row 12) and ``dot`` (row 16): what the
port's wrappers run for CPU tensors, held to the reference's Pallas
kernels in interpret mode (``repro.kernels.ops``) and to its oracles
(``repro.kernels.ref``) on the same float64 inputs from a numpy seed,
at ragged lengths.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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
TORCH = ExecPolicy(backend="torch")
NS = [1, 1000, 8193]
KS = [1, 2, 3, 5]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("n", NS)
def test_linear_combination_matches_reference(n, K):
    rng = np.random.default_rng(10 * n + K)
    c, X = rng.normal(size=K), rng.normal(size=(K, n))
    want_pl = kops.linear_combination(jnp.asarray(c), jnp.asarray(X),
                                      interpret=True)
    want_ref = kref.linear_combination_ref(jnp.asarray(c), jnp.asarray(X))
    xs = [torch.from_numpy(x) for x in X]
    # the coefficients as a (K,) tensor, as 0-d tensors and as numbers
    for form in (torch.from_numpy(c), [torch.tensor(v) for v in c],
                 c.tolist()):
        got = vecops.linear_combination(form, xs)
        for want in (want_pl, want_ref):
            np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                       atol=1e-10)


@pytest.mark.parametrize("n", NS)
def test_dot_matches_reference(n):
    rng = np.random.default_rng(n)
    x, y = rng.normal(size=n), rng.normal(size=n)
    scale = np.abs(x * y).sum()
    got = vecops.dot(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == ()
    for want in (kops.dot(jnp.asarray(x), jnp.asarray(y), interpret=True),
                 kref.dot_ref(jnp.asarray(x), jnp.asarray(y))):
        assert abs(float(got) - float(want)) <= 1e-10 * scale


@pytest.mark.parametrize("op", ["linear_sum", "axpy", "linear_combination",
                                "dot"])
def test_dispatch_vector_ops_match_reference_dispatch(op):
    """The port's dispatch ops against the reference's, on 2-D vectors
    (the Krylov solvers' (n, nsys) form), both backends."""
    rng = np.random.default_rng(7)
    x, y, z = (rng.normal(size=(5, 130)) for _ in range(3))
    a, b = 0.75, -1.25
    args = {"linear_sum": (a, "x", b, "y"), "axpy": (a, "x", "y"),
            "linear_combination": ([a, b, 2.0], ["x", "y", "z"]),
            "dot": ("x", "y")}[op]
    vecs = {"x": x, "y": y, "z": z}

    def build(conv):
        return [[conv(vecs[v]) for v in arg] if isinstance(arg, list)
                and isinstance(arg[0], str) else
                conv(vecs[arg]) if isinstance(arg, str) else arg
                for arg in args]

    want = getattr(rdv, op)(*build(jnp.asarray), policy=PALLAS)
    for policy in (None, TORCH):
        got = getattr(dv, op)(*build(torch.from_numpy), policy)
        atol = 1e-10 * (np.abs(x * y).sum() if op == "dot" else 1.0)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.mark.parametrize("op", ["linear_sum", "axpy"])
def test_linear_sum_and_axpy_route_through_the_lincomb_wrapper(op,
                                                               monkeypatch):
    """``linear_sum`` and ``axpy`` reach the row-12 wrapper with K = 2
    under the default backend, and its plain version under "torch"."""
    seen = []
    wrapper = vecops.linear_combination

    def spy(coeffs, xs):
        seen.append(len(xs))
        return wrapper(coeffs, xs)

    monkeypatch.setattr(vecops, "linear_combination", spy)
    x, y = torch.ones(4, 3), torch.full((4, 3), 2.0)
    args = (3.0, x, -1.0, y) if op == "linear_sum" else (3.0, x, y)
    want = torch.full((4, 3), 1.0 if op == "linear_sum" else 5.0)
    kernels.reset_counts()
    assert torch.equal(getattr(dv, op)(*args), want)
    assert seen == [2]
    assert kernels.counts()["linear_combination"] == (0, 1)
    assert torch.equal(getattr(dv, op)(*args, TORCH), want)
    assert seen == [2]                      # the torch backend skips it
    assert kernels.counts()["linear_combination"] == (0, 2)


def test_coefficient_forms_keep_the_vectors_dtype():
    x = torch.ones(6, dtype=torch.float32)
    for coeffs in ([0.5, torch.tensor(2.0, dtype=torch.float64)],
                   torch.tensor([0.5, 2.0], dtype=torch.float64)):
        z = vecops.linear_combination(coeffs, [x, x])
        assert z.dtype == torch.float32
        assert torch.equal(z, torch.full((6,), 2.5))
    assert dv.dot(x, x).dtype == torch.float32


def test_linear_combination_refuses_more_terms_than_the_kernel_takes():
    """The kernel takes at most LINCOMB_MAX_K terms; the wrapper refuses
    more on every device, so a CPU run accepts only what the card does."""
    xs = [torch.ones(4)] * (vecops.LINCOMB_MAX_K + 1)
    with pytest.raises(ValueError, match="at most 8"):
        vecops.linear_combination([1.0] * len(xs), xs)
    z = vecops.linear_combination([1.0] * 8, xs[:8])
    assert torch.equal(z, torch.full((4,), 8.0))
