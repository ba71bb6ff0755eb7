"""Ensemble Newton hot-loop ops, SoA layout (system axis LAST).

Counterpart of ``repro/kernels/newton.py``.  Four ops, each a CUDA
kernel in ``csrc/newton.cu`` with its plain PyTorch version beside it:

* :func:`newton_residual` — ``g = z - gamma*f - psi`` (``negate=True``
  returns ``-g``, the Newton right-hand side), every Newton iteration;
* :func:`masked_update_wrms` — ``z' = where(mask, z+dz, z)`` fused with
  the per-system WRMS of ``dz``, every Newton iteration;
* :func:`history_rescale` — the Lagrange history rebuild
  ``Z'[j] = sum_i W[j,i] Z[i]`` for active systems, a bit-exact copy
  for the others, twice a step;
* :func:`wrms_soa` — per-system WRMS ``(n, NB) -> (NB,)``, the BDF error
  test every step.

A wrapper launches its kernel for CUDA tensors (and raises if it cannot)
and runs the plain version for CPU tensors.  The plain versions
accumulate in the kernels' order, so on the card the two round alike.
"""
from __future__ import annotations

import torch

from . import _build

_FLOATS = tuple(_build.SUFFIX)
_MASKS = (torch.bool, torch.uint8)


def newton_residual_plain(z, fval, psi, gamma, *, negate=False):
    newton_residual_plain.calls += 1
    g = z - gamma[None, :] * fval - psi
    return -g if negate else g


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


def masked_update_wrms_plain(z, dz, w, mask):
    masked_update_wrms_plain.calls += 1
    z_new = torch.where(mask.bool()[None, :], z + dz, z)
    t = dz * w
    return z_new, torch.sqrt(torch.mean(t * t, dim=0))


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


def history_rescale_plain(W, Z, active):
    history_rescale_plain.calls += 1
    acc = W[:, 0, None, :] * Z[0][None]
    for i in range(1, W.shape[0]):
        acc = acc + W[:, i, None, :] * Z[i][None]
    return torch.where(active.bool()[None, None, :], acc, Z)


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


for _fn in (newton_residual, masked_update_wrms, history_rescale, wrms_soa):
    _fn.launches = 0
for _fn in (newton_residual_plain, masked_update_wrms_plain,
            history_rescale_plain, wrms_soa_plain):
    _fn.calls = 0
