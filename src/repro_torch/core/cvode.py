"""BDF coefficient tables and the history rescale matrix.

Counterpart of ``repro.core.cvode`` lines 36-87: the uniform-grid BDF
coefficients and the Lagrange rebuild matrix the ensemble BDF uses.  The
reference builds one matrix per system under ``jax.vmap``; here the
system axis is written out and kept LAST, so the result feeds
``history_rescale_soa`` without a transpose.  The scalar
``bdf_integrate`` waits for ROADMAP queue A item 7.
"""
from __future__ import annotations

import math

import torch

QMAX = 5

# Uniform-grid BDF coefficients, normalized alpha_0 = 1:
#   sum_j alpha_j y_{n+1-j} = h * beta * f_{n+1}
_BDF_ALPHA = [
    [1.0, -1.0, 0.0, 0.0, 0.0, 0.0],
    [1.0, -4 / 3, 1 / 3, 0.0, 0.0, 0.0],
    [1.0, -18 / 11, 9 / 11, -2 / 11, 0.0, 0.0],
    [1.0, -48 / 25, 36 / 25, -16 / 25, 3 / 25, 0.0],
    [1.0, -300 / 137, 300 / 137, -200 / 137, 75 / 137, -12 / 137],
]
_BDF_BETA = [1.0, 2 / 3, 6 / 11, 12 / 25, 60 / 137]

# Extrapolation predictor coefficients on a uniform grid, by polynomial
# DEGREE p (row p uses Z[0..p]):  y_pred = sum_j (-1)^j C(p+1, j+1) y_{n-j}.
_PREDP = [[1.0] + [0.0] * QMAX]
for _p in range(1, QMAX + 1):
    _row = [((-1.0) ** j) * math.comb(_p + 1, j + 1) for j in range(_p + 1)]
    _PREDP.append(_row + [0.0] * (QMAX + 1 - len(_row)))


def bdf_tables(dtype, device):
    """``(alpha, beta, predp)`` as tensors, laid out for column gathers
    by a per-system index: alpha ``(QMAX+1, QMAX)`` (column ``q-1``),
    beta ``(QMAX,)``, predp ``(QMAX+1, QMAX+1)`` (column = degree)."""
    alpha = torch.tensor(_BDF_ALPHA, dtype=torch.float64).T
    beta = torch.tensor(_BDF_BETA, dtype=torch.float64)
    predp = torch.tensor(_PREDP, dtype=torch.float64).T
    return tuple(x.to(dtype=dtype, device=device).contiguous()
                 for x in (alpha, beta, predp))


def lagrange_matrix_soa(eta: torch.Tensor,
                        q_cur: torch.Tensor) -> torch.Tensor:
    """Per-system rebuild matrices ``W (QMAX+1, QMAX+1, nsys)`` with
    ``Z_new[j] = sum_i W[j,i] Z_old[i]``.

    Old nodes sit at x_i = -i (units of h_old); new nodes at -j*eta.
    Rows/cols beyond ``q_cur`` are masked to identity so stale history
    slots stay untouched.  The product over k runs as a loop of
    ``(j, i, nsys)`` updates, so no ``(j, i, k, nsys)`` temporary is
    ever held.  The work runs under a profiler range of the function's
    name, so a trace can sum its device time.
    """
    with torch.profiler.record_function("lagrange_matrix_soa"):
        q1 = QMAX + 1
        dtype, dev = eta.dtype, eta.device
        idx = torch.arange(q1, dtype=dtype, device=dev)
        pts = -idx[:, None] * eta[None, :]                  # (j, nsys)
        ii = torch.arange(q1, device=dev)
        W = torch.ones((q1, q1, eta.shape[0]), dtype=dtype, device=dev)
        for k in range(q1):
            # Lagrange basis L_i(p) = prod_{k != i} (p + k) / (k - i),
            # over k <= q_cur only
            den = (k - idx).clone()
            den[k] = 1.0
            ratio = (pts + k)[:, None, :] / den[None, :, None]
            skip = (ii == k)[None, :, None] | (k > q_cur)[None, None, :]
            W.mul_(torch.where(skip, torch.ones((), dtype=dtype, device=dev),
                               ratio))
        valid_i = ii[None, :, None] <= q_cur[None, None, :]
        W = torch.where(valid_i, W, torch.zeros((), dtype=dtype, device=dev))
        valid_j = ii[:, None, None] <= q_cur[None, None, :]
        eye = torch.eye(q1, dtype=dtype, device=dev)[:, :, None]
        return torch.where(valid_j, W, eye)
