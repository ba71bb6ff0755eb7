"""Sparse SUNMatrix analogs: scalar CSR and ensemble shared-pattern BSR.

Counterpart of ``repro.core.sunmatrix``:

* :class:`SparseCSR` — one sparse matrix: ``data (nnz,)`` on the device
  and its :class:`CSRPattern`.  The reference keeps the pattern as
  hashable tuples compiled into its program; here the pattern object
  does the host work once, vectorised in numpy (the kernel's int32 row
  pointer and columns on the device, the diagonal slots), and every
  matrix made from a matrix (``scale_add``, ``scale_addI``) shares it,
  so neither an update nor a ``matvec`` repeats O(nnz) host work.
* :class:`EnsembleBSR` — ``nsys`` block-sparse matrices sharing one
  block pattern, values ``(nsys, nnzb, b, b)``; :attr:`values_soa` is
  the lane-major kernel layout ``(nnzb, b, b, nsys)``.

Both implement ``scale_addI`` (``SUNMatScaleAddI``, ``A <- c*A + I`` on
values with the pattern reused; the diagonal must be in the pattern).
SpMV routes through :mod:`repro_torch.core.dispatch` (``csr_spmv``,
``bsr_spmv_soa``), so the ExecPolicy picks the kernel or its plain
version as for the vector ops.  Patterns may be given as tuples or as
numpy integer arrays.  The constructors put a matrix on the card
unless the caller names a device (or hands in a tensor, whose device
is kept).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .policies import resolve_device


def _host(A) -> np.ndarray:
    return A.detach().cpu().numpy() if torch.is_tensor(A) else np.asarray(A)


def _diag_slots(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The slot of entry (i, i) in each row i (the first, if the pattern
    repeats it); raises if a row lacks it (the ``SUNMatScaleAddI``
    contract)."""
    n = indptr.size - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    hits = np.nonzero(indices == rows)[0]
    found, first = np.unique(rows[hits], return_index=True)
    if found.size < n:
        have = np.zeros(n, bool)
        have[found] = True
        i = int(np.argmin(have))
        raise ValueError(f"CSR pattern lacks diagonal entry ({i},{i}); "
                         "build with ensure_diag=True for SUNMatScaleAddI "
                         "use")
    return hits[first]


class CSRPattern:
    """A CSR sparsity pattern and the per-device arrays derived from it.

    ``indptr (nrows+1,)`` and ``indices (nnz,)`` are held as int64 numpy
    arrays, checked once; ``ncols`` is the column count.  The kernel's
    int32 ``(indptr, indices)`` and the diagonal slots are built once
    per device and cached on the object.
    """

    def __init__(self, indptr, indices, ncols: int):
        ip = np.asarray(indptr, dtype=np.int64).reshape(-1)
        ci = np.asarray(indices, dtype=np.int64).reshape(-1)
        if ip.size < 1 or ip[0] != 0 or ip[-1] != ci.size or \
                np.any(np.diff(ip) < 0):
            raise ValueError("CSRPattern: indptr must rise from 0 to nnz")
        if ci.size and (ci.min() < 0 or ci.max() >= ncols):
            raise ValueError(f"CSRPattern: a column lies outside "
                             f"0..{ncols - 1}")
        self.indptr, self.indices, self.ncols = ip, ci, int(ncols)
        self._cache: dict = {}

    @property
    def nrows(self) -> int:
        return self.indptr.size - 1

    @property
    def nnz(self) -> int:
        return self.indices.size

    @property
    def shape(self) -> tuple:
        return (self.nrows, self.ncols)

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        return isinstance(other, CSRPattern) and \
            self.ncols == other.ncols and \
            np.array_equal(self.indptr, other.indptr) and \
            np.array_equal(self.indices, other.indices)

    __hash__ = object.__hash__

    def _cached(self, key, build):
        out = self._cache.get(key)
        if out is None:
            out = self._cache[key] = build()
        return out

    def rows(self) -> np.ndarray:
        """The row of every slot, int64."""
        return self._cached("rows", lambda: np.repeat(
            np.arange(self.nrows), np.diff(self.indptr)))

    def kernel_plan(self, device: torch.device) -> tuple:
        """The int32 ``(indptr, indices)`` on ``device`` that
        :func:`repro_torch.kernels.sparse.csr_spmv` takes."""
        if self.nnz >= 2 ** 31:
            raise ValueError(f"csr_spmv: nnz={self.nnz} needs 64-bit "
                             "indices")
        return self._cached(("kernel", device), lambda: tuple(
            torch.as_tensor(a.astype(np.int32), device=device)
            for a in (self.indptr, self.indices)))

    def diag_slots(self, device: torch.device) -> torch.Tensor:
        """The slot of each row's diagonal entry, int64 on ``device``."""
        return self._cached(("diag", device), lambda: torch.as_tensor(
            _diag_slots(self.indptr, self.indices), device=device))


def csr_pattern_from_dense(A, tol: float = 0.0,
                           ensure_diag: bool = False) -> Tuple[tuple, tuple]:
    """(indptr, indices) tuples of the entries with |A_ij| > tol."""
    keep = np.abs(_host(A)) > tol
    if ensure_diag:
        d = np.arange(min(keep.shape))
        keep[d, d] = True
    cols = np.nonzero(keep)[1]                    # row-major order
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    return (tuple(int(i) for i in indptr), tuple(int(c) for c in cols))


def csr_diag_positions(indptr, indices) -> tuple:
    """The nnz slot of entry (i, i) per row of a CSR pattern; raises if
    a diagonal entry is absent (the Newton/ScaleAddI contract)."""
    return tuple(int(k) for k in _diag_slots(
        np.asarray(indptr, np.int64), np.asarray(indices, np.int64)))


def block_pattern_from_element(pattern, block_size: int,
                               ensure_diag: bool = True
                               ) -> Tuple[tuple, tuple, int]:
    """Collapse an elementwise (n, n) sparsity pattern to a block pattern
    ``(brows, bcols, nblk)`` of ``b = block_size`` blocks: a block is
    nonzero iff any of its b*b entries is; row-major block order."""
    P = _host(pattern).astype(bool)
    n = P.shape[0]
    if P.shape != (n, n) or n % block_size:
        raise ValueError(f"pattern {P.shape} is not square in blocks of "
                         f"{block_size}")
    nblk = n // block_size
    Pb = P.reshape(nblk, block_size, nblk, block_size).any(axis=(1, 3))
    if ensure_diag:
        np.fill_diagonal(Pb, True)
    br, bc = np.nonzero(Pb)
    return (tuple(int(i) for i in br), tuple(int(j) for j in bc), nblk)


@dataclass(frozen=True)
class SparseCSR:
    """CSR matrix: ``data (nnz,)`` on the device, the pattern shared."""

    data: torch.Tensor
    pattern: CSRPattern

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(cls, A, tol: float = 0.0,
                   ensure_diag: bool = False, device=None) -> "SparseCSR":
        """Compress a dense matrix: a tensor stays on its device, an
        array goes to ``device`` (default the card); the pattern is read
        from ``A``."""
        At = A if torch.is_tensor(A) else torch.as_tensor(
            np.asarray(A), device=resolve_device(device))
        indptr, indices = csr_pattern_from_dense(At, tol, ensure_diag)
        pat = CSRPattern(indptr, indices, At.shape[1])
        rows = torch.as_tensor(pat.rows(), device=At.device)
        cols = torch.as_tensor(pat.indices, device=At.device)
        return cls(At[rows, cols], pat)

    @classmethod
    def from_pattern(cls, indptr, indices, shape, data=None,
                     dtype=torch.float64, device=None) -> "SparseCSR":
        """A matrix over a given pattern (tuples or integer arrays); zero
        values unless ``data`` is given.  A ``data`` tensor stays on its
        device; otherwise the values go to ``device`` (default the
        card)."""
        pat = CSRPattern(indptr, indices, shape[1])
        if pat.nrows != shape[0]:
            raise ValueError(f"indptr gives {pat.nrows} rows, shape "
                             f"{tuple(shape)}")
        if torch.is_tensor(data) and device is None:
            return cls(data, pat)
        dev = resolve_device(device)
        if data is None:
            return cls(torch.zeros((pat.nnz,), dtype=dtype, device=dev), pat)
        return cls(torch.as_tensor(data, device=dev), pat)

    # -- structure ---------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.pattern.nnz

    @property
    def shape(self) -> tuple:
        return self.pattern.shape

    @property
    def indptr(self) -> np.ndarray:
        return self.pattern.indptr

    @property
    def indices(self) -> np.ndarray:
        return self.pattern.indices

    # -- ops (SUNMatScaleAdd / ScaleAddI / Matvec) -------------------------
    def scale_add(self, c, B: "SparseCSR") -> "SparseCSR":
        """A <- c*A + B; B shares the pattern (the fast path of
        SUNMatScaleAdd, the only one a shared pattern permits)."""
        if B.pattern != self.pattern:
            raise ValueError("scale_add: the patterns differ")
        return SparseCSR(c * self.data + B.data, self.pattern)

    def scale_addI(self, c) -> "SparseCSR":
        """A <- c*A + I on values, pattern reused: the Newton matrix
        ``M = I - gamma*J`` is ``J.scale_addI(-gamma)``."""
        diag = self.pattern.diag_slots(self.data.device)
        data = c * self.data
        data[diag] += 1.0
        return SparseCSR(data, self.pattern)

    def matvec(self, x: torch.Tensor, policy=None) -> torch.Tensor:
        from . import dispatch as dv
        return dv.csr_spmv(self.data, x, self.pattern, policy)

    def to_dense(self) -> torch.Tensor:
        dev = self.data.device
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=dev)
        out[torch.as_tensor(self.pattern.rows(), device=dev),
            torch.as_tensor(self.pattern.indices, device=dev)] = self.data
        return out


@dataclass(frozen=True)
class EnsembleBSR:
    """``nsys`` block-sparse matrices sharing ONE block pattern.

    values : (nsys, nnzb, b, b), only the nonzero blocks
    brows / bcols : the block pattern (row-major block order)
    nblk   : block rows per system (n = nblk * b)
    """

    values: torch.Tensor
    brows: tuple
    bcols: tuple
    nblk: int

    # -- construction ------------------------------------------------------
    @classmethod
    def from_sparsity(cls, pattern, block_size: int, nsys: int,
                      dtype=torch.float64, device=None) -> "EnsembleBSR":
        """Zero values over an elementwise ``jac_sparsity`` pattern, on
        ``device`` (default the card); the diagonal blocks are always
        included (for scale_addI)."""
        brows, bcols, nblk = block_pattern_from_element(pattern, block_size)
        values = torch.zeros((nsys, len(brows), block_size, block_size),
                             dtype=dtype, device=resolve_device(device))
        return cls(values, brows, bcols, nblk)

    @classmethod
    def from_dense(cls, J: torch.Tensor, block_size: int,
                   pattern=None) -> "EnsembleBSR":
        """Compress dense per-system Jacobians ``J (nsys, n, n)``;
        without ``pattern`` the union pattern over the systems."""
        if pattern is None:
            pattern = (J != 0).any(dim=0).cpu().numpy()
        brows, bcols, nblk = block_pattern_from_element(pattern, block_size)
        return cls(cls._gather_blocks(J, brows, bcols, block_size), brows,
                   bcols, nblk)

    @staticmethod
    def _gather_blocks(J: torch.Tensor, brows, bcols, b: int) -> torch.Tensor:
        """(nsys, n, n) -> (nsys, nnzb, b, b) at the pattern's blocks."""
        nsys, n, _ = J.shape
        nblk = n // b
        Jb = J.reshape(nsys, nblk, b, nblk, b).permute(0, 1, 3, 2, 4)
        return Jb[:, torch.as_tensor(brows, device=J.device),
                  torch.as_tensor(bcols, device=J.device)]

    # -- structure ---------------------------------------------------------
    @property
    def nnz_blocks(self) -> int:
        return len(self.brows)

    @property
    def block_size(self) -> int:
        return self.values.shape[-1]

    @property
    def nsys(self) -> int:
        return self.values.shape[0]

    @property
    def shape(self) -> tuple:
        n = self.nblk * self.block_size
        return (self.nsys, n, n)

    @property
    def values_soa(self) -> torch.Tensor:
        """Lane-major kernel layout: (nnzb, b, b, nsys), contiguous."""
        return self.values.permute(1, 2, 3, 0).contiguous()

    @property
    def block_pattern(self) -> Tuple[tuple, tuple, int]:
        return (self.brows, self.bcols, self.nblk)

    def _diag_block_positions(self) -> torch.Tensor:
        br, bc = np.asarray(self.brows), np.asarray(self.bcols)
        on = np.nonzero(br == bc)[0]
        found, first = np.unique(br[on], return_index=True)
        if found.size < self.nblk:
            have = np.zeros(self.nblk, bool)
            have[found] = True
            i = int(np.argmin(have))
            raise ValueError(f"block pattern lacks diagonal block ({i},{i})")
        return torch.as_tensor(on[first], device=self.values.device)

    # -- ops ---------------------------------------------------------------
    def scale_addI(self, c) -> "EnsembleBSR":
        """A_s <- c_s * A_s + I for every system, values only; ``c`` is a
        number, a 0-d tensor or per-system ``(nsys,)``."""
        c = torch.as_tensor(c, dtype=self.values.dtype,
                            device=self.values.device)
        cexp = c.reshape((-1, 1, 1, 1)) if c.dim() else c
        vals = cexp * self.values
        b = self.block_size
        eye = torch.eye(b, dtype=vals.dtype, device=vals.device)
        vals[:, self._diag_block_positions()] += eye
        return EnsembleBSR(vals, self.brows, self.bcols, self.nblk)

    def matvec(self, x: torch.Tensor, policy=None) -> torch.Tensor:
        """y_s = A_s @ x_s for every system; x (nsys, n) -> (nsys, n)."""
        from . import dispatch as dv
        nsys, n, _ = self.shape
        b = self.block_size
        x_soa = x.reshape(nsys, self.nblk, b).permute(1, 2, 0).contiguous()
        y = dv.bsr_spmv_soa(self.values_soa, x_soa, self.block_pattern,
                            policy)
        return y.permute(2, 0, 1).reshape(nsys, n)

    def to_dense(self) -> torch.Tensor:
        nsys, n, _ = self.shape
        b = self.block_size
        dev = self.values.device
        out = torch.zeros((nsys, self.nblk, self.nblk, b, b),
                          dtype=self.values.dtype, device=dev)
        out[:, torch.as_tensor(self.brows, device=dev),
            torch.as_tensor(self.bcols, device=dev)] = self.values
        return out.permute(0, 1, 3, 2, 4).reshape(nsys, n, n)
