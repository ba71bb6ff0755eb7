"""The port's sparse ensemble pieces against the JAX reference.

* ``bsr_spmv_soa`` (PERF.md row 10): its plain version (what the port's
  wrapper runs for CPU tensors) against the reference's Pallas kernel in
  interpret mode and its oracle, at b = 1, 2, 3 on the ensemble
  Brusselator's pattern (nx = 4) and the Robertson pattern;
* ``bsr_block_jacobi_inverse_soa`` against the reference's op;
* ``spsolve``: the symbolic ``LUPlan`` equals the reference's field by
  field (host numpy, so exactly), and the numeric LU, the triangular
  sweeps and the gathers agree to 1e-10.

Float64 inputs from a numpy seed, ragged batches (130, 516).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import dispatch as rdv
from repro.core import spsolve as rsp
from repro.core.policies import ExecPolicy as RefPolicy
from repro.core.policies import XLA_FUSED
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro_torch.core import dispatch as dv
from repro_torch.core import spsolve
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import sparse

PALLAS = RefPolicy(backend="pallas", interpret=True, batch_tile=128)
TORCH = ExecPolicy(backend="torch")
NBS = [130, 516]

ROBERTSON = np.array([[1, 1, 1], [1, 1, 1], [0, 1, 0]], bool)


def _brusselator(nx):
    n = 2 * nx
    P = np.zeros((n, n), bool)
    for i in range(nx):
        P[2 * i:2 * i + 2, 2 * i:2 * i + 2] = True
        for j in (i - 1, i + 1):
            if 0 <= j < nx:
                P[2 * i, 2 * j] = P[2 * i + 1, 2 * j + 1] = True
    return P


PATTERNS = {"brusselator": _brusselator(4), "robertson": ROBERTSON}


def _block_pattern(name):
    """The element pattern (diagonal forced in) read as a block pattern
    (brows, bcols, nblk), entries in CSR order."""
    indptr, indices = spsolve.encode_pattern(PATTERNS[name])
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return (tuple(int(r) for r in rows), tuple(int(c) for c in indices),
            len(indptr) - 1)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_bsr_spmv_matches_reference(name, b, nb):
    pattern = _block_pattern(name)
    brows, bcols, nblk = pattern
    rng = np.random.default_rng(b * nb)
    values = rng.normal(size=(len(brows), b, b, nb))
    x = rng.normal(size=(nblk, b, nb))
    got = sparse.bsr_spmv_soa(torch.from_numpy(values), torch.from_numpy(x),
                              pattern)
    assert got.shape == (nblk, b, nb)
    want_pl = kops.bsr_spmv_soa(jnp.asarray(values), jnp.asarray(x),
                                brows=brows, bcols=bcols, nblk=nblk,
                                batch_tile=128, interpret=True)
    want_ref = kref.bsr_spmv_soa_ref(jnp.asarray(values), jnp.asarray(x),
                                     brows, bcols, nblk)
    for want in (want_pl, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-10)
    # the dispatch op, both backends, and the reference's dispatch op
    want_dv = rdv.bsr_spmv_soa(jnp.asarray(values), jnp.asarray(x), pattern,
                               PALLAS)
    for policy in (None, TORCH):
        port = dv.bsr_spmv_soa(torch.from_numpy(values), torch.from_numpy(x),
                               pattern, policy)
        np.testing.assert_allclose(_np(port), _np(want_dv), rtol=0,
                                   atol=1e-10)


def test_bsr_spmv_unordered_pattern_and_empty_row():
    """Entries out of row order, a repeated block, and a block row with
    no entries (which is zero), as the reference's segment sum gives."""
    pattern = ((3, 0, 1, 0, 3, 1, 0), (0, 1, 1, 0, 3, 1, 3), 4)
    rng = np.random.default_rng(3)
    values = rng.normal(size=(7, 2, 2, 9))
    x = rng.normal(size=(4, 2, 9))
    got = sparse.bsr_spmv_soa(torch.from_numpy(values), torch.from_numpy(x),
                              pattern)
    want = kref.bsr_spmv_soa_ref(jnp.asarray(values), jnp.asarray(x),
                                 *pattern)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-12)
    assert not got[2].any()


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("b", [2, 3])
def test_block_jacobi_inverse_matches_reference(b, nb):
    pattern = _block_pattern("brusselator")
    rng = np.random.default_rng(b + nb)
    values = rng.normal(size=(len(pattern[0]), b, b, nb)) \
        + 2 * b * np.eye(b)[None, :, :, None]
    for policy in (None, TORCH):
        got = dv.bsr_block_jacobi_inverse_soa(torch.from_numpy(values),
                                              pattern, policy)
        assert got.shape == (b, b, pattern[2] * nb)
        for pol in (XLA_FUSED, PALLAS):
            want = rdv.bsr_block_jacobi_inverse_soa(jnp.asarray(values),
                                                    pattern, pol)
            np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                       atol=1e-10)


def test_block_jacobi_inverse_needs_every_diagonal_block():
    values = torch.ones((1, 1, 1, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="diagonal block"):
        dv.bsr_block_jacobi_inverse_soa(values, ((0,), (1,), 2))


def _plans(name):
    enc = spsolve.encode_pattern(PATTERNS[name])
    assert enc == rsp.encode_pattern(PATTERNS[name])
    for order in (True, False):
        for fill in (True, False):
            yield enc, fill, (spsolve.symbolic_lu(*enc, order=order,
                                                  fill=fill),
                              rsp.symbolic_lu(*enc, order=order, fill=fill))


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_symbolic_lu_plan_equals_reference_field_by_field(name):
    for _, _, (port, ref) in _plans(name):
        assert port._fields == ref._fields
        for field in ref._fields:
            a, b = getattr(port, field), getattr(ref, field)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field
            else:
                assert a == b, field
        assert port.nnz_factored == ref.nnz_factored


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_numeric_lu_and_solve_match_reference(name):
    P = PATTERNS[name]
    n, nb = P.shape[0], 130
    rng = np.random.default_rng(n)
    # diagonally dominant Newton-like matrices on the pattern (diagonal
    # forced in), system axis last
    A = np.where((P | np.eye(n, dtype=bool))[:, :, None],
                 rng.normal(size=(n, n, nb)), 0.0)
    A += 2 * n * np.eye(n)[:, :, None]
    rhs = rng.normal(size=(n, nb))
    for enc, fill, (port, ref) in _plans(name):
        vals = spsolve.gather_filled(port, torch.from_numpy(A))
        vals_ref = rsp.gather_filled(ref, jnp.asarray(A))
        np.testing.assert_array_equal(_np(vals), _np(vals_ref))
        fact = spsolve.numeric_lu(port, vals)
        fact_ref = rsp.numeric_lu(ref, vals_ref)
        np.testing.assert_allclose(_np(fact), _np(fact_ref), rtol=0,
                                   atol=1e-10)
        x = spsolve.lu_solve(port, fact, torch.from_numpy(rhs))
        np.testing.assert_allclose(_np(x), _np(rsp.lu_solve(ref, fact_ref,
                                                            jnp.asarray(rhs))),
                                   rtol=0, atol=1e-10)
        # the CSR values placed into the factored layout
        indptr, indices = enc
        rows = np.repeat(np.arange(n), np.diff(indptr))
        csr = A[rows, np.asarray(indices)]
        np.testing.assert_array_equal(
            _np(spsolve.scatter_from_csr(port, indptr, indices,
                                         torch.from_numpy(csr))),
            _np(rsp.scatter_from_csr(ref, indptr, indices,
                                     jnp.asarray(csr))))
        if fill:    # the exact LU: the solve inverts A itself
            back = np.einsum("ijs,js->is", A, _np(x))
            np.testing.assert_allclose(back, rhs, rtol=0, atol=1e-10)


def test_encode_pattern_refuses_a_non_square_pattern():
    with pytest.raises(ValueError, match="square"):
        spsolve.encode_pattern(np.ones((2, 3), bool))
