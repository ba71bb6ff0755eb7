"""The port's sparse matrices (``repro_torch.core.sunmatrix``) and its
``csr_spmv`` (PERF.md row 11) against the JAX reference.

The same matrices, made from numpy seeds, go through both packages:
``SparseCSR`` construction, ``to_dense``, ``scale_add`` and
``scale_addI`` are held to the reference exactly (same values, same
pattern); ``csr_spmv``'s plain version to the reference's jnp oracle
(``csr_spmv_ref``) and to its Pallas ELL kernel in interpret mode, as
``tests/test_sparse.py`` runs it, within 1e-10; ``EnsembleBSR``'s
matvec and per-system ``scale_addI`` at nsys 130 within 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import dispatch as rdv
from repro.core import sunmatrix as rsm
from repro.core.policies import ExecPolicy as RefPolicy
from repro.kernels import ref as kref
from repro_torch import interop, kernels
from repro_torch.core import dispatch as dv
from repro_torch.core import sunmatrix as sm
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import sparse

PALLAS = RefPolicy(backend="pallas", interpret=True)


def _random_sparse(n, density, key=0, diag_boost=6.0, empty_row=None):
    rng = np.random.default_rng(key)
    A = rng.normal(size=(n, n)) * (rng.random((n, n)) < density)
    A += np.diag(diag_boost + rng.random(n))
    if empty_row is not None:
        A[empty_row] = 0.0
    return A


def _tuples(csr):
    return (tuple(int(i) for i in csr.indptr),
            tuple(int(i) for i in csr.indices))


def test_sparse_csr_matches_reference_roundtrip_and_scale_addi():
    A = _random_sparse(13, 0.25)
    ref = rsm.SparseCSR.from_dense(A)
    csr = sm.SparseCSR.from_dense(A, device="cpu")
    assert csr.nnz == ref.nnz == int((np.abs(A) > 0).sum())
    assert _tuples(csr) == ref.pattern
    np.testing.assert_array_equal(csr.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(csr.to_dense().numpy(), A)
    M = csr.scale_addI(-0.37)
    np.testing.assert_array_equal(M.to_dense().numpy(),
                                  np.asarray(ref.scale_addI(-0.37)
                                             .to_dense()))
    assert M.pattern == csr.pattern and M.pattern is csr.pattern
    assert sm.csr_pattern_from_dense(A) == rsm.csr_pattern_from_dense(A)
    assert sm.csr_diag_positions(*ref.pattern) == \
        rsm.csr_diag_positions(*ref.pattern)


def test_sparse_csr_scale_addi_requires_diagonal():
    A = np.zeros((3, 3))
    A[0, 1], A[1, 0], A[2, 2] = 1.0, 2.0, 3.0
    with pytest.raises(ValueError, match="diagonal entry \\(0,0\\)"):
        sm.SparseCSR.from_dense(A, device="cpu").scale_addI(-1.0)
    csr2 = sm.SparseCSR.from_dense(A, ensure_diag=True, device="cpu")
    np.testing.assert_array_equal(csr2.scale_addI(-1.0).to_dense().numpy(),
                                  np.eye(3) - A)
    assert _tuples(csr2) == rsm.SparseCSR.from_dense(
        A, ensure_diag=True).pattern


def test_sparse_csr_scale_add_and_pattern_arrays():
    A = _random_sparse(17, 0.3, key=4)
    B = 0.5 * A + np.diag(np.arange(17.0))
    ref = rsm.SparseCSR.from_dense(A).scale_add(
        2.5, rsm.SparseCSR.from_pattern(*rsm.SparseCSR.from_dense(A).pattern,
                                        (17, 17),
                                        data=rsm.SparseCSR.from_dense(B)
                                        .data))
    csr = sm.SparseCSR.from_dense(A, device="cpu")
    # a pattern given as numpy integer arrays is accepted as tuples are
    other = sm.SparseCSR.from_pattern(np.asarray(csr.indptr),
                                      np.asarray(csr.indices, np.int32),
                                      (17, 17),
                                      data=sm.SparseCSR.from_dense(
                                          B, device="cpu").data)
    got = csr.scale_add(2.5, other)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    with pytest.raises(ValueError, match="patterns differ"):
        csr.scale_add(1.0, sm.SparseCSR.from_dense(np.eye(17),
                                                        device="cpu"))


@pytest.mark.parametrize("n", [1, 133, 516])
def test_csr_spmv_plain_matches_reference(n):
    """csr_spmv's plain version against the reference's jnp oracle and
    its Pallas ELL kernel (interpret mode), within 1e-10; past n = 1 the
    pattern has a row with no entries (the reference's kernels take no
    matrix without entries)."""
    A = _random_sparse(n, 0.1, key=n, empty_row=n // 2 if n > 1 else None)
    x = np.random.default_rng(n + 1).normal(size=n)
    ref = rsm.SparseCSR.from_dense(A)
    csr = interop.csr_from_reference(np.asarray(ref.data), ref.indptr,
                                     ref.indices, ref.shape, device="cpu")
    y_ref = np.asarray(kref.csr_spmv_ref(ref.data, jnp.asarray(x),
                                         ref.indptr, ref.indices))
    y_pal = np.asarray(rdv.csr_spmv(ref.data, jnp.asarray(x), ref.pattern,
                                    PALLAS))
    kernels.reset_counts()
    y = sparse.csr_spmv_plain(csr.data, torch.from_numpy(x),
                              *csr.pattern.kernel_plan(csr.data.device))
    assert kernels.counts()["csr_spmv"] == (0, 1)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(y.numpy(), y_pal, rtol=0, atol=1e-10)
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=0, atol=1e-10)
    if n > 1:
        assert y[n // 2] == 0.0


def test_csr_spmv_dispatch_routes_and_checks():
    A = _random_sparse(40, 0.2, key=7)
    csr = sm.SparseCSR.from_dense(A, device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).normal(size=40))
    kernels.reset_counts()
    a = csr.matvec(x)                                   # "auto" on the CPU
    b = csr.matvec(x, ExecPolicy(backend="torch"))
    c = dv.csr_spmv(csr.data, x, _tuples(csr))          # a tuple pattern
    assert kernels.counts()["csr_spmv"] == (0, 3)
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
        csr.matvec(x, ExecPolicy(backend="cuda"))
    with pytest.raises(ValueError, match="x has shape"):
        csr.matvec(x[:-1])
    with pytest.raises(ValueError, match="column lies outside"):
        sm.CSRPattern((0, 1), (5,), 3)


def test_ensemble_bsr_matches_reference():
    """EnsembleBSR over a block-tridiagonal pattern at nsys 130:
    construction, per-system scale_addI and matvec (the shared-pattern
    ``bsr_spmv_soa``, row 10) against the reference within 1e-12."""
    nblk, b, nsys = 5, 2, 130
    n = nblk * b
    P = np.zeros((n, n), bool)
    for i in range(nblk):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nblk:
                P[i * b:(i + 1) * b, j * b:(j + 1) * b] = True
    rng = np.random.default_rng(3)
    J = rng.normal(size=(nsys, n, n)) * P
    c = -np.abs(rng.normal(size=nsys))
    x = rng.normal(size=(nsys, n))
    ref = rsm.EnsembleBSR.from_dense(jnp.asarray(J), b, pattern=P)
    bsr = sm.EnsembleBSR.from_dense(torch.from_numpy(J), b, pattern=P)
    assert bsr.block_pattern == ref.block_pattern
    assert sm.block_pattern_from_element(P, b) == \
        rsm.block_pattern_from_element(P, b)
    np.testing.assert_array_equal(bsr.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(bsr.values_soa.numpy(),
                                  np.asarray(ref.values_soa))
    M_ref = ref.scale_addI(jnp.asarray(c))
    M = bsr.scale_addI(torch.from_numpy(c))
    np.testing.assert_allclose(M.to_dense().numpy(),
                               np.asarray(M_ref.to_dense()), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(M.to_dense().numpy(),
                               c[:, None, None] * J + np.eye(n), rtol=0,
                               atol=1e-12)
    y_ref = np.asarray(M_ref.matvec(jnp.asarray(x)))
    y = M.matvec(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-12)
    scalar = bsr.scale_addI(-0.5)
    np.testing.assert_allclose(scalar.to_dense().numpy(),
                               np.asarray(ref.scale_addI(-0.5).to_dense()),
                               rtol=0, atol=1e-12)
    empty = sm.EnsembleBSR.from_sparsity(P, b, 4, device="cpu")
    assert empty.values.shape == (4, len(ref.brows), b, b)
    assert empty.shape == (4, n, n) and empty.nnz_blocks == len(ref.brows)


def test_interop_csr_from_reference():
    A = _random_sparse(21, 0.2, key=11)
    ref = rsm.SparseCSR.from_dense(A, ensure_diag=True)
    csr = interop.csr_from_reference(np.asarray(ref.data), ref.indptr,
                                     ref.indices, ref.shape, device="cpu")
    assert csr.shape == ref.shape and csr.nnz == ref.nnz
    assert _tuples(csr) == ref.pattern
    assert csr.data.dtype == torch.float64
    np.testing.assert_array_equal(csr.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    x = np.random.default_rng(12).normal(size=21)
    np.testing.assert_allclose(csr.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
