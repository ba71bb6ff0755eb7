"""Batched small-block Gauss-Jordan inverse and solve, SoA layout.

Counterpart of ``repro/kernels/block_solve.py``:

* :func:`block_inverse_soa` — ``A (b,b,NB) -> A^{-1} (b,b,NB)``, the
  lsetup product of ``BlockDiagGJ(factor_once=True)``;
* :func:`newton_block_inverse_soa` — ``J (b,b,NB), gamma (NB,) ->
  (I - gamma*J)^{-1}``, that lsetup at b <= 8 in one launch: the Newton
  blocks (:func:`newton_blocks_soa`) formed inside the b <= 8 inverse;
* :func:`block_solve_soa` — ``A (b,b,NB), r (b,NB) -> x (b,NB)``, the
  lsolve of ``BlockDiagGJ(factor_once=False)`` and the DIRK stage
  Newton solve.

The reference's algorithm is kept: no pivoting (Newton blocks
``I - gamma*J`` of kinetics are diagonally dominant for acceptable
gamma), row scaling by ``1/max(max_j |A_ij|, 1e-30)``, and two kernel
bodies per entry: for ``b <= 8`` the augmented ``[A | I]`` or
``[A | r]`` elimination, for ``b > 8`` the inverse in place with column
post-scaling and the solve on a ``(b, b+1, NB)`` augmented array.  The
CUDA kernels are ``csrc/block_solve.cu``, in three forms by block size:

* ``b <= 8``: one thread per system, the augmented system in registers;
* ``9 <= b <= 32`` (``WARP_MAX_B``): one warp per system, row i in lane
  i, the block's systems staged through a shared-memory tile;
* ``b > 32``: one thread per system eliminating in device memory (the
  solve in a ``(b, b+1, NB)`` scratch tensor).

The last two are the same body (the reference's tiled one) for the
counts below, chosen by size.

Each body counts its own launches (``launches_unrolled`` for b <= 8,
``launches_tiled`` for b > 8) and each plain version its own calls
(``calls_unrolled``, ``calls_tiled``), so a run shows which of the
reference's four bodies it went through.
"""
from __future__ import annotations

import torch

from . import _build

#: largest b eliminated in the augmented form (the reference's
#: UNROLL_MAX_B); larger blocks run the tiled bodies
UNROLL_MAX_B = 8
#: largest b of the tiled bodies' warp-per-system CUDA form; larger
#: blocks take the form that works in device memory
WARP_MAX_B = 32
#: the warp form's launch (csrc/block_solve.cu): systems a block, one a
#: warp (``GJ_WARPS``), and a warp's pivot-row slots (``GJ_PIVOT_SLOTS``)
GJ_WARPS = 4
GJ_PIVOT_SLOTS = 34


def warp_smem_bytes(b: int, itemsize: int) -> int:
    """Dynamic shared memory a block of the warp form requests at block
    size b (``gj_smem_bytes``): GJ_WARPS systems of b rows, each row
    b + 1 values padded to odd, each system padded off the others'
    banks, then the warps' pivot rows, 16-byte aligned."""
    row = b + 1 + (b & 1)
    wave = 128 // itemsize
    n = b * row
    system = n + ((wave // GJ_WARPS - n) % wave + wave) % wave
    pivots = (GJ_WARPS * system + 3) & ~3
    return (pivots + GJ_WARPS * GJ_PIVOT_SLOTS) * itemsize


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


def newton_blocks_soa(J, gamma):
    """Dense SoA Newton blocks ``M = I - gamma*J``: J (b,b,NB), gamma
    (NB,) -> (b,b,NB); entry (i, j) is ``(i == j) - gamma*J[i, j]``, the
    product rounded alone."""
    eye = torch.eye(J.shape[0], dtype=J.dtype, device=J.device)
    return eye[:, :, None] - gamma[None, None, :] * J


def _body(b: int) -> str:
    """Which kernel body a block size runs: 'unrolled' or 'tiled'."""
    return "unrolled" if b <= UNROLL_MAX_B else "tiled"


def _count(fn, prefix: str, b: int) -> None:
    name = f"{prefix}_{_body(b)}"
    setattr(fn, name, getattr(fn, name) + 1)


def block_inverse_soa_plain(A):
    _count(block_inverse_soa_plain, "calls", A.shape[0])
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
    _count(block_inverse_soa, "launches", b)
    return X


def newton_block_inverse_soa_plain(J, gamma):
    newton_block_inverse_soa_plain.calls += 1
    return _inverse_augmented(newton_blocks_soa(J, gamma))


def newton_block_inverse_soa(J, gamma):
    """``block_inverse_soa(newton_blocks_soa(J, gamma))`` in one launch that
    never writes M, bit for bit the two: J (b,b,NB), gamma (NB,), b <=
    :data:`UNROLL_MAX_B`."""
    if _build.on_cpu("newton_block_inverse_soa", J):
        return newton_block_inverse_soa_plain(J, gamma)
    b, _, nb = J.shape
    if b > UNROLL_MAX_B:
        raise ValueError(f"newton_block_inverse_soa: b={b} > {UNROLL_MAX_B} "
                         f"is not supported")
    _build.check("newton_block_inverse_soa", J.device,
                 J=(J, (b, b, nb), tuple(_build.SUFFIX)),
                 gamma=(gamma, (nb,), (J.dtype,)))
    X = torch.empty_like(J)
    _build.launch("block_solve",
                  "newton_block_inverse_" + _build.SUFFIX[J.dtype], "pppilp",
                  J.data_ptr(), gamma.data_ptr(), X.data_ptr(), b, nb,
                  _build.stream(J.device))
    newton_block_inverse_soa.launches += 1
    return X


def _solve_augmented(A, r):
    """[A | r] eliminated row-vector by row-vector, as ``_gj_kernel``."""
    b = A.shape[0]
    inv = _row_scale(A)
    a, x = A * inv[:, None, :], r * inv
    for k in range(b):
        inv_piv = 1.0 / a[k, k]
        ak, xk = a[k] * inv_piv, x[k] * inv_piv
        f = a[:, k, :]
        a_new = a - f[:, None, :] * ak[None]
        x_new = x - f * xk[None]
        a_new[k], x_new[k] = ak, xk          # the pivot row is not updated
        a, x = a_new, x_new
    return x


def _solve_tiled(A, r):
    """The augmented (b, b+1, NB) array eliminated in place, as
    ``_gj_tiled_kernel``; column k is read as the factor at step k and
    never again, so each step updates only the columns right of k."""
    b = A.shape[0]
    inv = _row_scale(A)
    S = torch.cat([A * inv[:, None, :], (r * inv)[:, None, :]], dim=1)
    for k in range(b):
        rowk = S[k, k + 1:] * (1.0 / S[k, k])
        f = S[:, k].clone()
        f[k] = 0.0
        S[:, k + 1:] -= f[:, None, :] * rowk[None]
        S[k, k + 1:] = rowk
    return S[:, b]


def block_solve_soa_plain(A, r):
    _count(block_solve_soa_plain, "calls", A.shape[0])
    if A.shape[0] <= UNROLL_MAX_B:
        return _solve_augmented(A, r)
    return _solve_tiled(A, r)


def block_solve_soa(A, r):
    """Solve every block system: A (b,b,NB), r (b,NB) -> x (b,NB)."""
    if _build.on_cpu("block_solve_soa", A):
        return block_solve_soa_plain(A, r)
    b, _, nb = A.shape
    _build.check("block_solve_soa", A.device,
                 A=(A, (b, b, nb), tuple(_build.SUFFIX)),
                 r=(r, (b, nb), (A.dtype,)))
    X = torch.empty_like(r)
    # the b > 32 form eliminates in this scratch, system axis last (the
    # 9 <= b <= 32 form works in shared memory and needs none); it
    # returns to PyTorch's stream-ordered cache when the wrapper returns,
    # and a later use on this stream waits for the kernel
    S = torch.empty((b, b + 1, nb), dtype=A.dtype, device=A.device) \
        if b > WARP_MAX_B else None
    _build.launch("block_solve", "block_solve_" + _build.SUFFIX[A.dtype],
                  "ppppilp", A.data_ptr(), r.data_ptr(), X.data_ptr(),
                  0 if S is None else S.data_ptr(), b, nb,
                  _build.stream(A.device))
    _count(block_solve_soa, "launches", b)
    return X


newton_block_inverse_soa.launches = 0
newton_block_inverse_soa_plain.calls = 0
for _fn, _prefix in ((block_inverse_soa, "launches"),
                     (block_inverse_soa_plain, "calls"),
                     (block_solve_soa, "launches"),
                     (block_solve_soa_plain, "calls")):
    for _b in ("unrolled", "tiled"):
        setattr(_fn, f"{_prefix}_{_b}", 0)
