"""Ensemble Newton hot-loop ops, SoA layout (system axis LAST).

Counterpart of ``repro/kernels/newton.py``.  Seven ops, each a CUDA
kernel in ``csrc/newton.cu`` with its plain PyTorch version beside it:

* :func:`newton_residual` — ``g = z - gamma*f - psi`` (``negate=True``
  returns ``-g``, the Newton right-hand side), every Newton iteration;
* :func:`newton_residual_lsolve` — the residual fused with the lsolve of
  ``BlockDiagGJ(factor_once=True)`` at b <= 8: ``dz = 2/(1+gamrat) *
  (Minv @ -g)`` per system, every Newton iteration of the BDF's default
  solver (one launch where the composition takes six);
* :func:`masked_update_wrms` — ``z' = where(mask, z+dz, z)`` fused with
  the per-system WRMS of ``dz``, every Newton iteration;
* :func:`newton_update` — the two above in one launch: the whole Newton
  iteration of ``BlockDiagGJ(factor_once=True)`` at b <= 8, ``dz`` never
  written (every Newton iteration of the BDF's default solver);
* :func:`history_rescale` — the history rebuild ``Z'[j] = sum_i
  W[j,i] Z[i]`` for active systems, a bit-exact copy for the others
  (the reference's op ``history_rescale_soa``);
* :func:`lagrange_rescale` — the same rebuild with W the Lagrange
  matrix of each system's step ratio and history count
  (:func:`lagrange_matrix_soa`), which the kernel forms in registers
  and never stores, twice a step;
* :func:`wrms_soa` — per-system WRMS ``(n, NB) -> (NB,)``, the BDF error
  test every step.

A wrapper launches its kernel for CUDA tensors (and raises if it cannot)
and runs the plain version for CPU tensors.  The plain versions
accumulate in the kernels' order, so on the card the two round alike
(both rescales and the fused residual and lsolve give the same bits;
:func:`newton_update` gives the bits of the fused residual and lsolve
and the masked update's kernel).
"""
from __future__ import annotations

import torch

from . import _build
from .blockdiag_spmv import block_products

_FLOATS = tuple(_build.SUFFIX)
_MASKS = (torch.bool, torch.uint8)
#: widest block of the fused residual and lsolve (``RESIDUAL_MAX_N`` in
#: csrc/newton.cu)
RESIDUAL_MAX_N = 8


def _residual(z, fval, psi, gamma, negate):
    g = z - gamma[None, :] * fval - psi
    return -g if negate else g


def newton_residual_plain(z, fval, psi, gamma, *, negate=False):
    newton_residual_plain.calls += 1
    return _residual(z, fval, psi, gamma, negate)


def newton_residual(z, fval, psi, gamma, *, negate=False):
    """g = z - gamma*f - psi; z/f/psi (n, NB), gamma (NB,)."""
    if _build.on_cpu("newton_residual", z):
        return newton_residual_plain(z, fval, psi, gamma, negate=negate)
    n, nb = z.shape
    dt = (z.dtype,)
    _build.check("newton_residual", z.device, z=(z, (n, nb), _FLOATS),
                 fval=(fval, (n, nb), dt), psi=(psi, (n, nb), dt),
                 gamma=(gamma, (nb,), dt))
    out = torch.empty_like(z)
    _build.launch("newton", "newton_residual_" + _build.SUFFIX[z.dtype],
                  "pppppilip", z.data_ptr(), fval.data_ptr(), psi.data_ptr(),
                  gamma.data_ptr(), out.data_ptr(), n, nb, int(negate),
                  _build.stream(z.device))
    newton_residual.launches += 1
    return out


def newton_residual_lsolve_plain(z, fval, psi, gamma, gamrat, Minv):
    newton_residual_lsolve_plain.calls += 1
    return _residual_lsolve(z, fval, psi, gamma, gamrat, Minv)


def newton_residual_lsolve(z, fval, psi, gamma, gamrat, Minv):
    """``dz = corr * (Minv @ -(z - gamma*f - psi))`` per system, corr =
    ``2/(1+gamrat)``: the residual (``newton_residual(..., negate=True)``),
    the SpMV of the saved inverse (``blockdiag_spmv_soa``) and CVODE's
    gamma-drift correction in one launch, equal to their composition bit
    for bit.  z/f/psi (b, NB), gamma/gamrat (NB,), Minv (b, b, NB), b <=
    :data:`RESIDUAL_MAX_N`."""
    if _build.on_cpu("newton_residual_lsolve", z):
        return newton_residual_lsolve_plain(z, fval, psi, gamma, gamrat, Minv)
    b, nb = z.shape
    if b > RESIDUAL_MAX_N:
        raise ValueError(f"newton_residual_lsolve: b={b} > {RESIDUAL_MAX_N} "
                         f"is not supported")
    dt = (z.dtype,)
    _build.check("newton_residual_lsolve", z.device,
                 z=(z, (b, nb), _FLOATS), fval=(fval, (b, nb), dt),
                 psi=(psi, (b, nb), dt), gamma=(gamma, (nb,), dt),
                 gamrat=(gamrat, (nb,), dt), Minv=(Minv, (b, b, nb), dt))
    dz = torch.empty_like(z)
    _build.launch("newton", "newton_residual_lsolve_" + _build.SUFFIX[z.dtype],
                  "pppppppilp", z.data_ptr(), fval.data_ptr(), psi.data_ptr(),
                  gamma.data_ptr(), gamrat.data_ptr(), Minv.data_ptr(),
                  dz.data_ptr(), b, nb, _build.stream(z.device))
    newton_residual_lsolve.launches += 1
    return dz


def _residual_lsolve(z, fval, psi, gamma, gamrat, Minv):
    corr = 2.0 / (1.0 + gamrat)
    return corr[None, :] * block_products(
        Minv, _residual(z, fval, psi, gamma, True))


def _masked_update(z, dz, w, mask):
    z_new = torch.where(mask.bool()[None, :], z + dz, z)
    t = dz * w
    return z_new, torch.sqrt(torch.mean(t * t, dim=0))


def masked_update_wrms_plain(z, dz, w, mask):
    masked_update_wrms_plain.calls += 1
    return _masked_update(z, dz, w, mask)


def masked_update_wrms(z, dz, w, mask):
    """``(where(mask, z+dz, z), dn)`` with dn[s] = sqrt(mean_k
    (dz[k,s]*w[k,s])^2) over ALL systems; z/dz/w (n, NB), mask (NB,)
    bool or uint8 (nonzero = update)."""
    if _build.on_cpu("masked_update_wrms", z):
        return masked_update_wrms_plain(z, dz, w, mask)
    n, nb = z.shape
    dt = (z.dtype,)
    _build.check("masked_update_wrms", z.device, z=(z, (n, nb), _FLOATS),
                 dz=(dz, (n, nb), dt), w=(w, (n, nb), dt),
                 mask=(mask, (nb,), _MASKS))
    z_new = torch.empty_like(z)
    dn = torch.empty((nb,), dtype=z.dtype, device=z.device)
    _build.launch("newton", "masked_update_wrms_" + _build.SUFFIX[z.dtype],
                  "ppppppilp", z.data_ptr(), dz.data_ptr(), w.data_ptr(),
                  mask.data_ptr(), z_new.data_ptr(), dn.data_ptr(), n, nb,
                  _build.stream(z.device))
    masked_update_wrms.launches += 1
    return z_new, dn


def newton_update_plain(z, fval, psi, gamma, gamrat, Minv, w, mask):
    newton_update_plain.calls += 1
    return _masked_update(z, _residual_lsolve(z, fval, psi, gamma, gamrat,
                                              Minv), w, mask)


def newton_update(z, fval, psi, gamma, gamrat, Minv, w, mask):
    """One Newton iteration of ``BlockDiagGJ(factor_once=True)``:
    ``masked_update_wrms(z, newton_residual_lsolve(z, fval, psi, gamma,
    gamrat, Minv), w, mask)`` in one launch that never writes dz ->
    ``(z_new, dn)``, bit for bit the two kernels.  z/f/psi/w (b, NB),
    gamma/gamrat (NB,), Minv (b, b, NB), mask (NB,) bool or uint8, b <=
    :data:`RESIDUAL_MAX_N`."""
    if _build.on_cpu("newton_update", z):
        return newton_update_plain(z, fval, psi, gamma, gamrat, Minv, w, mask)
    b, nb = z.shape
    if b > RESIDUAL_MAX_N:
        raise ValueError(f"newton_update: b={b} > {RESIDUAL_MAX_N} is not "
                         f"supported")
    dt = (z.dtype,)
    _build.check("newton_update", z.device, z=(z, (b, nb), _FLOATS),
                 fval=(fval, (b, nb), dt), psi=(psi, (b, nb), dt),
                 gamma=(gamma, (nb,), dt), gamrat=(gamrat, (nb,), dt),
                 Minv=(Minv, (b, b, nb), dt), w=(w, (b, nb), dt),
                 mask=(mask, (nb,), _MASKS))
    z_new = torch.empty_like(z)
    dn = torch.empty((nb,), dtype=z.dtype, device=z.device)
    _build.launch("newton", "newton_update_" + _build.SUFFIX[z.dtype],
                  "ppppppppppilp", z.data_ptr(), fval.data_ptr(),
                  psi.data_ptr(), gamma.data_ptr(), gamrat.data_ptr(),
                  Minv.data_ptr(), w.data_ptr(), mask.data_ptr(),
                  z_new.data_ptr(), dn.data_ptr(), b, nb,
                  _build.stream(z.device))
    newton_update.launches += 1
    return z_new, dn


#: rows of the BDF history (orders 1-5): the order of the Lagrange W
LAGRANGE_Q1 = 6


def lagrange_matrix_soa(eta: torch.Tensor,
                        q_cur: torch.Tensor) -> torch.Tensor:
    """Per-system rebuild matrices ``W (6, 6, nsys)`` with
    ``Z_new[j] = sum_i W[j,i] Z_old[i]``.

    Old nodes sit at x_i = -i (units of h_old); new nodes at -j*eta.
    Rows/cols beyond ``q_cur`` are masked to identity so stale history
    slots stay untouched.  The product over k runs as a loop of
    ``(j, i, nsys)`` updates, so no ``(j, i, k, nsys)`` temporary is
    ever held.  The work runs under a profiler range of the function's
    name, so a trace can sum its device time.  The plain tensor code of
    :func:`lagrange_rescale`'s W (some 60 launches on the card); the
    kernel forms each entry with this arithmetic in this order.
    """
    with torch.profiler.record_function("lagrange_matrix_soa"):
        q1 = LAGRANGE_Q1
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


def _rescale(W, Z, active):
    acc = W[:, 0, None, :] * Z[0][None]
    for i in range(1, W.shape[0]):
        acc = acc + W[:, i, None, :] * Z[i][None]
    return torch.where(active.bool()[None, None, :], acc, Z)


def history_rescale_plain(W, Z, active):
    history_rescale_plain.calls += 1
    return _rescale(W, Z, active)


def history_rescale(W, Z, active):
    """Z'[j,k,s] = sum_i W[j,i,s] Z[i,k,s] where active[s], else Z[j,k,s]
    bit-exactly; W (q1,q1,NB), Z (q1,n,NB), active (NB,) bool/uint8.
    The kernel takes q1 <= 8 (the BDF history has q1 = 6)."""
    if _build.on_cpu("history_rescale", Z):
        return history_rescale_plain(W, Z, active)
    q1, n, nb = Z.shape
    if q1 > 8:
        raise ValueError(f"history_rescale: q1={q1} > 8 is not supported")
    _build.check("history_rescale", Z.device, W=(W, (q1, q1, nb), (Z.dtype,)),
                 Z=(Z, (q1, n, nb), _FLOATS), active=(active, (nb,), _MASKS))
    out = torch.empty_like(Z)
    _build.launch("newton", "history_rescale_" + _build.SUFFIX[Z.dtype],
                  "ppppiilp", W.data_ptr(), Z.data_ptr(), active.data_ptr(),
                  out.data_ptr(), q1, n, nb, _build.stream(Z.device))
    history_rescale.launches += 1
    return out


def lagrange_rescale_plain(eta, q, Z, active):
    lagrange_rescale_plain.calls += 1
    return _rescale(lagrange_matrix_soa(eta, q), Z, active)


def lagrange_rescale(eta, q, Z, active):
    """``history_rescale(lagrange_matrix_soa(eta, q), Z, active)`` with
    W formed in the kernel: eta (NB,) step ratios, q (NB,) int32 valid
    history counts, Z (6,n,NB), active (NB,) bool/uint8.  Equal to the
    plain version bit for bit."""
    if _build.on_cpu("lagrange_rescale", Z):
        return lagrange_rescale_plain(eta, q, Z, active)
    q1, n, nb = Z.shape
    if q1 != LAGRANGE_Q1:
        raise ValueError(f"lagrange_rescale: Z has {q1} history rows, the "
                         f"Lagrange matrix {LAGRANGE_Q1}")
    _build.check("lagrange_rescale", Z.device, eta=(eta, (nb,), (Z.dtype,)),
                 q=(q, (nb,), (torch.int32,)), Z=(Z, (q1, n, nb), _FLOATS),
                 active=(active, (nb,), _MASKS))
    out = torch.empty_like(Z)
    _build.launch("newton", "lagrange_rescale_" + _build.SUFFIX[Z.dtype],
                  "pppppilp", eta.data_ptr(), q.data_ptr(), Z.data_ptr(),
                  active.data_ptr(), out.data_ptr(), n, nb,
                  _build.stream(Z.device))
    lagrange_rescale.launches += 1
    return out


def wrms_soa_plain(v, w):
    wrms_soa_plain.calls += 1
    t = v * w
    return torch.sqrt(torch.mean(t * t, dim=0))


def wrms_soa(v, w):
    """Per-system WRMS: v/w (n, NB) -> (NB,)."""
    if _build.on_cpu("wrms_soa", v):
        return wrms_soa_plain(v, w)
    n, nb = v.shape
    _build.check("wrms_soa", v.device, v=(v, (n, nb), _FLOATS),
                 w=(w, (n, nb), (v.dtype,)))
    out = torch.empty((nb,), dtype=v.dtype, device=v.device)
    _build.launch("newton", "wrms_soa_" + _build.SUFFIX[v.dtype], "pppilp",
                  v.data_ptr(), w.data_ptr(), out.data_ptr(), n, nb,
                  _build.stream(v.device))
    wrms_soa.launches += 1
    return out


for _fn in (newton_residual, newton_residual_lsolve, masked_update_wrms,
            newton_update, history_rescale, lagrange_rescale, wrms_soa):
    _fn.launches = 0
for _fn in (newton_residual_plain, newton_residual_lsolve_plain,
            masked_update_wrms_plain, newton_update_plain,
            history_rescale_plain, lagrange_rescale_plain, wrms_soa_plain):
    _fn.calls = 0
