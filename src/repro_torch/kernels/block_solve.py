"""Batched small-block Gauss-Jordan inverse, SoA layout.

Counterpart of ``block_inverse_soa`` in ``repro/kernels/block_solve.py``:
``A (b,b,NB) -> A^{-1} (b,b,NB)``, the lsetup product of
``BlockDiagGJ(factor_once=True)``.  The reference's algorithm is kept:
no pivoting (Newton blocks ``I - gamma*J`` of kinetics are diagonally
dominant for acceptable gamma), row scaling by
``1/max(max_j |A_ij|, 1e-30)``, and for ``b <= 8`` the
augmented ``[A | I]`` elimination, for ``b > 8`` the in-place one with
column post-scaling.  The CUDA kernel is ``csrc/block_solve.cu``.

``block_solve_soa`` (the ``factor_once=False`` lsolve) waits for ROADMAP
queue B rows 8-9.
"""
from __future__ import annotations

import torch

from . import _build

#: largest b eliminated in the augmented form (the reference's
#: UNROLL_MAX_B); larger blocks invert in place
UNROLL_MAX_B = 8


def _row_scale(A):
    """1/max(max_j |A[i,j]|, 1e-30) per row and system: (b, NB)."""
    return 1.0 / torch.clamp(A.abs().amax(dim=1), min=1e-30)


def _inverse_augmented(A):
    b, _, nb = A.shape
    eye = torch.eye(b, dtype=A.dtype, device=A.device)[:, :, None]
    inv = _row_scale(A)[:, None, :]
    a, r = A * inv, eye * inv
    for k in range(b):
        inv_piv = 1.0 / a[k, k]
        a[k] = a[k] * inv_piv
        r[k] = r[k] * inv_piv
        f = a[:, k, None, :]
        a_new = a - f * a[k][None]
        r_new = r - f * r[k][None]
        a_new[k], r_new[k] = a[k], r[k]      # the pivot row is not updated
        a, r = a_new, r_new
    return r


def _inverse_inplace(A):
    inv_m = _row_scale(A)
    S = A * inv_m[:, None, :]
    for k in range(A.shape[0]):
        inv = 1.0 / S[k, k]
        rowk = S[k] * inv
        rowk[k] = inv
        f = S[:, k].clone()
        f[k] = 0.0
        S = S - f[:, None, :] * rowk[None]
        S[k] = rowk
        S[:, k] = -f * inv
        S[k, k] = inv
    # rows were pre-scaled by D: S = (D A)^-1 = A^-1 D^-1, so scale the
    # COLUMNS to recover A^-1
    return S * inv_m[None, :, :]


def block_inverse_soa_plain(A):
    block_inverse_soa_plain.calls += 1
    if A.shape[0] <= UNROLL_MAX_B:
        return _inverse_augmented(A)
    return _inverse_inplace(A)


def block_inverse_soa(A):
    """Invert every block: A (b,b,NB) -> A^{-1} (b,b,NB)."""
    if _build.on_cpu("block_inverse_soa", A):
        return block_inverse_soa_plain(A)
    b, _, nb = A.shape
    _build.check("block_inverse_soa", A.device,
                 A=(A, (b, b, nb), tuple(_build.SUFFIX)))
    X = torch.empty_like(A)
    _build.launch("block_solve", "block_inverse_" + _build.SUFFIX[A.dtype],
                  "ppilp", A.data_ptr(), X.data_ptr(), b, nb,
                  _build.stream(A.device))
    block_inverse_soa.launches += 1
    return X


block_inverse_soa.launches = 0
block_inverse_soa_plain.calls = 0
