"""Block-diagonal SpMV, SoA layout (counterpart of
``repro/kernels/blockdiag_spmv.py``): ``A (b,b,NB), x (b,NB) -> y
(b,NB)``, the lsolve of ``BlockDiagGJ(factor_once=True)`` against the
saved inverse.  The CUDA kernel is ``csrc/blockdiag_spmv.cu``.
"""
from __future__ import annotations

import torch

from . import _build

#: the row form's launch (csrc/blockdiag_spmv.cu, 9 <= b <= SPMV_MAX_B):
#: warps a block (``SPMV_WARPS``), systems a block (``SPMV_SYSTEMS``)
#: and the widest block (``SPMV_MAX_B``); smaller b take the fixed form,
#: larger the one that reads x from device memory
SPMV_WARPS = 8
SPMV_SYSTEMS = 32
SPMV_MAX_B = 32
#: the b whose row-form kernel is compiled for that width; the others
#: up to SPMV_MAX_B run the run-time-width instance
SPMV_ROW_WIDTHS = (16, 24, 32)


def row_tile_bytes(b: int, itemsize: int) -> int:
    """Static shared memory of a row-form block at block size b: its x
    tile, ``WIDTH`` rows of SPMV_SYSTEMS values, WIDTH being b for a
    compiled width and SPMV_MAX_B otherwise."""
    width = b if b in SPMV_ROW_WIDTHS else SPMV_MAX_B
    return width * SPMV_SYSTEMS * itemsize


def block_products(A, x):
    """The plain version's arithmetic, uncounted: ``acc = A[:, 0] *
    x[0]``, then ``acc + A[:, j] * x[j]`` for j = 1..b-1."""
    acc = A[:, 0, :] * x[0]
    for j in range(1, A.shape[1]):
        acc = acc + A[:, j, :] * x[j]
    return acc


def blockdiag_spmv_soa_plain(A, x):
    blockdiag_spmv_soa_plain.calls += 1
    return block_products(A, x)


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
