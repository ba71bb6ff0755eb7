"""Static-pattern sparse LU: the symbolic/numeric split of the
SUNLINSOL_CUSOLVERSP_BATCHQR analog.

Counterpart of ``repro.core.spsolve`` (``spsolve.py:43-202``).  Every
system of the ensemble shares one sparsity pattern, so the symbolic
phase runs once per pattern on the HOST (numpy, cached): the fill
ordering (reverse Cuthill-McKee), the symbolic factorization (fill-in
for ``fill=True``, ILU(0) for ``fill=False``) and the flat elimination
and triangular-sweep schedules.  :func:`encode_pattern`,
:func:`_rcm_order`, :class:`LUPlan` and :func:`symbolic_lu` are the
reference's code as it is, so a plan equals the reference's field by
field.

The numeric phase works on values ``(nnzf, *batch)`` whose trailing
axes are the ensemble lanes; every op is elementwise across them.  As
in the reference it is plain tensor code, unrolled over the schedule
(no kernel: the reference has no Pallas body for it), so on the card
each update is a few small launches over the lanes.  The static index
tensors it gathers with are built once per (plan, device) and cached.
No pivoting: Newton matrices ``I - gamma*J`` are strongly diagonally
dominant for acceptable gamma.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch


def encode_pattern(pattern) -> Tuple[tuple, tuple]:
    """(n, n) boolean/0-1 array -> hashable CSR (indptr, indices) with
    the diagonal forced in (Newton matrices need it)."""
    P = np.asarray(pattern).astype(bool).copy()
    n = P.shape[0]
    if P.shape != (n, n):
        raise ValueError(f"a sparsity pattern is square, got {P.shape}")
    np.fill_diagonal(P, True)
    indptr, indices = [0], []
    for i in range(n):
        cols = np.nonzero(P[i])[0]
        indices.extend(int(c) for c in cols)
        indptr.append(len(indices))
    return tuple(indptr), tuple(indices)


def _rcm_order(P: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized pattern — the 'fill
    ordering' of the symbolic setup (BFS from a min-degree peripheral
    vertex, neighbors by ascending degree, order reversed)."""
    S = P | P.T
    n = S.shape[0]
    deg = S.sum(axis=1)
    visited = np.zeros(n, bool)
    order = []
    while len(order) < n:
        rest = np.nonzero(~visited)[0]
        start = rest[np.argmin(deg[rest])]
        queue = [int(start)]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = [int(u) for u in np.nonzero(S[v])[0] if not visited[u]]
            for u in sorted(nbrs, key=lambda u: deg[u]):
                visited[u] = True
                queue.append(u)
    return np.asarray(order[::-1], np.int64)


class LUPlan(NamedTuple):
    """Host-side symbolic product: everything the numeric phase unrolls
    over.  All fields are static (numpy / tuples)."""

    n: int
    perm: np.ndarray          # row/col permutation (fill ordering)
    rows: np.ndarray          # (nnzf,) filled-pattern row of each slot
    cols: np.ndarray          # (nnzf,) filled-pattern col of each slot
    diag: np.ndarray          # (n,) slot index of (k, k)
    schedule: tuple           # ((f_slot, piv_k, ((tgt, src), ...)), ...)
    lower: tuple              # per row i: ((slot_ij, j), ...) for j < i
    upper: tuple              # per row i (reversed): ((slot_ij, j), ...) j > i

    @property
    def nnz_factored(self) -> int:
        return len(self.rows)


@functools.lru_cache(maxsize=64)
def symbolic_lu(indptr: tuple, indices: tuple, *, order: bool = True,
                fill: bool = True) -> LUPlan:
    """Symbolic factorization of the static CSR pattern (cached)."""
    n = len(indptr) - 1
    P = np.zeros((n, n), bool)
    for i in range(n):
        P[i, list(indices[indptr[i]:indptr[i + 1]])] = True
    np.fill_diagonal(P, True)
    perm = _rcm_order(P) if order else np.arange(n)
    F = P[perm][:, perm].copy()
    if fill:                       # simulate elimination, record fill-in
        for k in range(n):
            below = np.nonzero(F[k + 1:, k])[0] + k + 1
            right = np.nonzero(F[k, k + 1:])[0] + k + 1
            for i in below:
                F[i, right] = True
    rows, cols = np.nonzero(F)
    slot = {(int(i), int(j)): s for s, (i, j) in enumerate(zip(rows, cols))}
    diag = np.asarray([slot[(k, k)] for k in range(n)], np.int64)
    # Doolittle schedule: for k, for i > k with (i,k) present:
    #   f = A[i,k] / A[k,k];  A[i,k] = f;  A[i,j] -= f * A[k,j]  (j > k)
    schedule = []
    for k in range(n):
        right = [j for j in range(k + 1, n) if F[k, j]]
        for i in range(k + 1, n):
            if not F[i, k]:
                continue
            ups = tuple((slot[(i, j)], slot[(k, j)]) for j in right
                        if F[i, j])   # always true when fill=True
            schedule.append((slot[(i, k)], int(diag[k]), ups))
    lower = tuple(tuple((slot[(i, j)], j) for j in range(i) if F[i, j])
                  for i in range(n))
    upper = tuple(tuple((slot[(i, j)], j) for j in range(i + 1, n)
                        if F[i, j])
                  for i in range(n))
    return LUPlan(n=n, perm=perm, rows=rows, cols=cols, diag=diag,
                  schedule=tuple(schedule), lower=lower, upper=upper)


_TENSORS: dict = {}


def _cached(key, build):
    """The static tensors of ``key``, built once.  A key starts with a
    plan, which the entry keeps alive, so its ``id`` stays unique."""
    hit = _TENSORS.get(key)
    if hit is None:
        hit = _TENSORS[key] = build()
    return hit[1]


def _gather_index(plan: LUPlan, device):
    def build():
        return plan, tuple(torch.as_tensor(plan.perm[a], device=device)
                           for a in (plan.rows, plan.cols))
    return _cached((id(plan), "gather", str(device)), build)


def diag_index(plan: LUPlan, device) -> torch.Tensor:
    """``plan.diag`` as an int64 tensor on ``device``."""
    def build():
        return plan, torch.as_tensor(plan.diag, device=device)
    return _cached((id(plan), "diag", str(device)), build)


def gather_filled(plan: LUPlan, M: torch.Tensor) -> torch.Tensor:
    """Extract the (permuted) filled-pattern values from a dense SoA
    Newton matrix ``M: (n, n, *batch)`` -> ``(nnzf, *batch)``."""
    pr, pc = _gather_index(plan, M.device)
    return M[pr, pc]


def scatter_from_csr(plan: LUPlan, indptr: tuple, indices: tuple,
                     vals: torch.Tensor) -> torch.Tensor:
    """Place original-pattern CSR values ``(nnz, *batch)`` into the
    factored layout ``(nnzf, *batch)`` (fill slots start at zero)."""
    def build():
        n = plan.n
        ip = np.asarray(indptr)
        orig = {}
        for i in range(n):
            for s in range(ip[i], ip[i + 1]):
                orig[(i, int(indices[s]))] = s
        src, mask = [], []
        for i, j in zip(plan.rows, plan.cols):
            key = (int(plan.perm[i]), int(plan.perm[j]))
            src.append(orig.get(key, 0))
            mask.append(key in orig)
        return plan, (torch.as_tensor(src, dtype=torch.int64, device=vals.device),
                      torch.as_tensor(mask, device=vals.device))
    src, mask = _cached((id(plan), "scatter", indptr, indices,
                         str(vals.device)), build)
    out = vals[src]
    m = mask.reshape((-1,) + (1,) * (vals.dim() - 1))
    return torch.where(m, out, torch.zeros_like(out))


def numeric_lu(plan: LUPlan, vals: torch.Tensor) -> torch.Tensor:
    """Factor on the filled values ``(nnzf, *batch)``; every update is
    elementwise across the trailing batch (lane) axes.  The schedule is
    unrolled: straight-line code, no pivoting.  Runs under a profiler
    range of its name, so a trace can sum its device time."""
    with torch.profiler.record_function("spsolve.numeric_lu"):
        v = list(vals.unbind(0))
        for f_slot, piv, ups in plan.schedule:
            f = v[f_slot] / v[piv]
            v[f_slot] = f
            for tgt, src in ups:
                v[tgt] = v[tgt] - f * v[src]
        return torch.stack(v)


def lu_solve(plan: LUPlan, fvals: torch.Tensor,
             rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = rhs`` from the factored values: two unrolled
    triangular sweeps.  ``rhs: (n, *batch)`` -> ``x: (n, *batch)``.
    Runs under a profiler range of its name."""
    with torch.profiler.record_function("spsolve.lu_solve"):
        v = fvals.unbind(0)
        r = rhs.unbind(0)
        b = [r[int(plan.perm[i])] for i in range(plan.n)]
        y = [None] * plan.n
        for i in range(plan.n):                 # L y = b (unit lower)
            acc = b[i]
            for s, j in plan.lower[i]:
                acc = acc - v[s] * y[j]
            y[i] = acc
        x = [None] * plan.n
        for i in range(plan.n - 1, -1, -1):     # U x = y
            acc = y[i]
            for s, j in plan.upper[i]:
                acc = acc - v[s] * x[j]
            x[i] = acc / v[int(plan.diag[i])]
        out = [None] * plan.n
        for i in range(plan.n):                 # undo the fill ordering
            out[int(plan.perm[i])] = x[i]
        return torch.stack(out)
