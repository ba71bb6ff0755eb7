"""Block-diagonal SpMV, SoA layout (counterpart of
``repro/kernels/blockdiag_spmv.py``): ``A (b,b,NB), x (b,NB) -> y
(b,NB)``, the lsolve of ``BlockDiagGJ(factor_once=True)`` against the
saved inverse.  The CUDA kernel is ``csrc/blockdiag_spmv.cu``.
"""
from __future__ import annotations

import torch

from . import _build


def blockdiag_spmv_soa_plain(A, x):
    blockdiag_spmv_soa_plain.calls += 1
    acc = A[:, 0, :] * x[0]
    for j in range(1, A.shape[1]):
        acc = acc + A[:, j, :] * x[j]
    return acc


def blockdiag_spmv_soa(A, x):
    """y[:, s] = A[:, :, s] @ x[:, s] for every system s."""
    if _build.on_cpu("blockdiag_spmv_soa", A):
        return blockdiag_spmv_soa_plain(A, x)
    b, _, nb = A.shape
    _build.check("blockdiag_spmv_soa", A.device,
                 A=(A, (b, b, nb), tuple(_build.SUFFIX)),
                 x=(x, (b, nb), (A.dtype,)))
    y = torch.empty((b, nb), dtype=A.dtype, device=A.device)
    _build.launch("blockdiag_spmv", "blockdiag_spmv_" + _build.SUFFIX[A.dtype],
                  "pppilp", A.data_ptr(), x.data_ptr(), y.data_ptr(), b, nb,
                  _build.stream(A.device))
    blockdiag_spmv_soa.launches += 1
    return y


blockdiag_spmv_soa.launches = 0
blockdiag_spmv_soa_plain.calls = 0
