"""Sparse SpMV kernels (counterpart of ``repro/kernels/sparse.py``),
each beside its plain PyTorch version; the CUDA kernels are
``csrc/sparse.cu``.

* :func:`bsr_spmv_soa` — ensemble block-sparse SpMV with one shared
  pattern, SoA layout: ``values (nnzb, b, b, NB), x (nblk, b, NB) -> y
  (nblk, b, NB)`` with ``y_I = sum_{e: brows[e] = I} A_e x_{bcols[e]}``,
  the matvec of the sparse ensemble's Krylov solvers (1x1 blocks over
  the Jacobian pattern).  The pattern ``(brows, bcols, nblk)`` is a
  tuple of ints, as in the reference.  The kernel reads it from three
  small int32 device arrays and the plain version from per-position
  index tensors; both are built once per (pattern, device) and cached.
  Both sum in the reference's order: per entry the inner j sum, then
  added to the row's running total, entries in pattern order; a block
  row with no entries is zero.
* :func:`csr_spmv` — ``y = A x`` for one CSR matrix, ``data (nnz,)``,
  ``x (ncols,)`` -> ``y (nrows,)`` (``SparseCSR.matvec``), given the
  int32 row pointer and columns on the device (the matrix layer,
  :mod:`repro_torch.core.sunmatrix`, builds them once per pattern).
  Both versions sum each row in pattern order, slot 0 first, then
  ``acc + d*x`` (the reference's ELL kernel's order); a row with no
  entries is zero in the kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

_FLOATS = tuple(_build.SUFFIX)


def _rows_sorted(pattern):
    """(entries stably sorted by block row, block-row pointer)."""
    brows, bcols, nblk = pattern
    br = np.asarray(brows, np.int64)
    bc = np.asarray(bcols, np.int64)
    if br.shape != bc.shape or br.ndim != 1:
        raise ValueError("bsr_spmv_soa: brows and bcols differ in length")
    if br.size and (br.min() < 0 or br.max() >= nblk or bc.min() < 0
                    or bc.max() >= nblk):
        raise ValueError(f"bsr_spmv_soa: a block index lies outside "
                         f"0..{nblk - 1}")
    order = np.argsort(br, kind="stable")
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(br, minlength=nblk))])
    return order, row_ptr


@functools.lru_cache(maxsize=64)
def _row_plan(pattern: tuple, device: torch.device):
    """The kernel's int32 ``(row_ptr (nblk+1,), cols (nnzb,), slots
    (nnzb,))`` on ``device``: entries stably sorted by block row, each
    with its block column and its index into ``values``."""
    order, row_ptr = _rows_sorted(pattern)
    cols = np.asarray(pattern[1], np.int64)[order]
    return tuple(torch.as_tensor(a.astype(np.int32), device=device)
                 for a in (row_ptr, cols, order))


@functools.lru_cache(maxsize=64)
def _position_plan(pattern: tuple, device: torch.device):
    """For each position p within a block row: ``(rows, slots, cols)``,
    the rows with more than p entries, their p-th entry and its block
    column, as int64 tensors on ``device``."""
    order, row_ptr = _rows_sorted(pattern)
    counts = np.diff(row_ptr)
    cols = np.asarray(pattern[1], np.int64)
    plan = []
    for p in range(int(counts.max()) if counts.size else 0):
        rows = np.nonzero(counts > p)[0]
        slots = order[row_ptr[rows] + p]
        plan.append(tuple(torch.as_tensor(a, device=device)
                          for a in (rows, slots, cols[slots])))
    return tuple(plan)


def bsr_spmv_soa_plain(values, x, pattern):
    bsr_spmv_soa_plain.calls += 1
    b, nb = values.shape[1], values.shape[3]
    y = torch.zeros((pattern[2], b, nb), dtype=values.dtype,
                    device=values.device)
    for p, (rows, slots, cols) in enumerate(
            _position_plan(pattern, values.device)):
        V, X = values[slots], x[cols]           # (m, b, b, NB), (m, b, NB)
        c = V[:, :, 0] * X[:, None, 0]
        for j in range(1, b):
            c = c + V[:, :, j] * X[:, None, j]
        y[rows] = c if p == 0 else y[rows] + c
    return y


def bsr_spmv_soa(values, x, pattern):
    """y_I = sum_{e: brows[e]=I} values[e] @ x[bcols[e]] for every
    system; pattern = (brows, bcols, nblk)."""
    if _build.on_cpu("bsr_spmv_soa", values):
        return bsr_spmv_soa_plain(values, x, pattern)
    nnzb, b, _, nb = values.shape
    nblk = pattern[2]
    if len(pattern[0]) != nnzb:
        raise ValueError(f"bsr_spmv_soa: {nnzb} value blocks for a pattern "
                         f"of {len(pattern[0])}")
    if not 1 <= nblk <= 65535:
        raise ValueError(f"bsr_spmv_soa: nblk={nblk} outside 1..65535")
    _build.check("bsr_spmv_soa", values.device,
                 values=(values, (nnzb, b, b, nb), _FLOATS),
                 x=(x, (nblk, b, nb), (values.dtype,)))
    row_ptr, cols, slots = _row_plan(pattern, values.device)
    y = torch.empty((nblk, b, nb), dtype=values.dtype, device=values.device)
    _build.launch("sparse", "bsr_spmv_" + _build.SUFFIX[values.dtype],
                  "ppppppiilp", values.data_ptr(), x.data_ptr(), y.data_ptr(),
                  row_ptr.data_ptr(), cols.data_ptr(), slots.data_ptr(), b,
                  nblk, nb, _build.stream(values.device))
    bsr_spmv_soa.launches += 1
    return y


bsr_spmv_soa.launches = 0
bsr_spmv_soa_plain.calls = 0


def _check_csr(data, x, indptr, indices) -> None:
    if data.dim() != 1 or indices.shape != data.shape:
        raise ValueError(f"csr_spmv: data has shape {tuple(data.shape)}, "
                         f"the columns {tuple(indices.shape)}")
    if indptr.dim() != 1 or indptr.numel() < 1 or x.dim() != 1:
        raise ValueError("csr_spmv: indptr and x must be vectors")


def csr_spmv_plain(data, x, indptr, indices):
    """kmax elementwise passes over the rows' slots (ELL form), slot 0
    first, then ``acc + d*x[c]``; a padded slot adds ``0*x[0]``."""
    csr_spmv_plain.calls += 1
    _check_csr(data, x, indptr, indices)
    ip, ci = indptr.long(), indices.long()
    lens = ip[1:] - ip[:-1]
    if ci.numel() == 0:
        return torch.zeros(lens.shape, dtype=data.dtype, device=data.device)
    k = torch.arange(int(lens.max()), device=data.device)[:, None]
    valid = k < lens[None, :]
    src = torch.where(valid, ip[:-1][None, :] + k, 0)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    d = torch.where(valid, data[src], zero)
    xs = x[torch.where(valid, ci[src], 0)]
    acc = d[0] * xs[0]
    for j in range(1, d.shape[0]):
        acc = acc + d[j] * xs[j]
    return acc


def csr_spmv(data, x, indptr, indices):
    """y = A @ x for CSR A: data (nnz,), x (ncols,) -> y (nrows,), with
    the int32 row pointer and columns on data's device (built once per
    pattern by :class:`repro_torch.core.sunmatrix.CSRPattern`, which
    also checks the columns against ``ncols``)."""
    if _build.on_cpu("csr_spmv", data):
        return csr_spmv_plain(data, x, indptr, indices)
    _check_csr(data, x, indptr, indices)
    _build.check("csr_spmv", data.device, data=(data, data.shape, _FLOATS),
                 x=(x, x.shape, (data.dtype,)),
                 indptr=(indptr, indptr.shape, (torch.int32,)),
                 indices=(indices, indices.shape, (torch.int32,)))
    nrows = indptr.numel() - 1
    y = torch.empty((nrows,), dtype=data.dtype, device=data.device)
    if nrows == 0:
        return y
    _build.launch("sparse", "csr_spmv_" + _build.SUFFIX[data.dtype],
                  "ppppplp", data.data_ptr(), x.data_ptr(), y.data_ptr(),
                  indptr.data_ptr(), indices.data_ptr(), nrows,
                  _build.stream(data.device))
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
csr_spmv_plain.calls = 0
