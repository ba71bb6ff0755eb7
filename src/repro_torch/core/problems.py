"""Batched Robertson kinetics, the ensemble integrator's test problem.

Counterpart of ``repro.core.problems.batched_robertson`` and
``batched_robertson_soa``.  The reference draws its per-cell rate
constants with ``jax.random``, which PyTorch cannot reproduce, so here
they come from the caller (``rates=``) or from numpy with the
reference's distributions (:func:`robertson_rates`); a test hands the
same numpy arrays to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .policies import resolve_device


def robertson_rates(nsys: int, seed: int = 0) -> dict:
    """Per-cell rates ``{"k1","k2","k3"}`` as ``(nsys,)`` float64 numpy
    arrays: k1 = 0.04, k2 = 1e4*(0.5+U(0,1)), k3 = 3e7*10**U(-1,1) (k3
    spans two decades: the "large variations in stiffness" regime)."""
    rng = np.random.default_rng(seed)
    return {"k1": np.full((nsys,), 0.04),
            "k2": 1e4 * (0.5 + rng.uniform(size=nsys)),
            "k3": 3e7 * 10.0 ** rng.uniform(-1.0, 1.0, size=nsys)}


def _rate_tensors(nsys, rates, seed, device, dtype):
    dev = resolve_device(device)
    if rates is None:
        rates = robertson_rates(nsys, seed)
    out = {k: torch.as_tensor(rates[k], dtype=dtype, device=dev)
           for k in ("k1", "k2", "k3")}
    for k, v in out.items():
        if v.shape != (nsys,):
            raise ValueError(f"rate {k} has shape {tuple(v.shape)}, "
                             f"want ({nsys},)")
    return dev, out["k1"], out["k2"], out["k3"]


def batched_robertson(nsys: int, *, rates=None, seed: int = 0, device=None,
                      dtype=torch.float64):
    """``(f, jac, y0)``: ``f(t, y:(nsys,3)) -> (nsys,3)`` and
    ``jac(t, y) -> (nsys,3,3)`` with the rates closed over; ``y0`` is
    ``[1, 0, 0]`` per system.  ``device=None`` means the card."""
    dev, k1, k2, k3 = _rate_tensors(nsys, rates, seed, device, dtype)

    def f(t, y):  # y: (nsys, 3)
        a, b, c = y[:, 0], y[:, 1], y[:, 2]
        r1, r2, r3 = k1 * a, k2 * b * c, k3 * b * b
        return torch.stack([-r1 + r2, r1 - r2 - r3, r3], dim=1)

    def jac(t, y):
        a, b, c = y[:, 0], y[:, 1], y[:, 2]
        z = torch.zeros_like(a)
        return torch.stack([
            torch.stack([-k1, k2 * c, k2 * b], dim=1),
            torch.stack([k1, -k2 * c - 2 * k3 * b, -k2 * b], dim=1),
            torch.stack([z, 2 * k3 * b, z], dim=1)], dim=1)

    y0 = torch.zeros((nsys, 3), dtype=dtype, device=dev)
    y0[:, 0] = 1.0
    return f, jac, y0


def batched_robertson_soa(nsys: int, *, rates=None, seed: int = 0,
                          device=None, dtype=torch.float64):
    """Native SoA companions, system axis LAST: ``f_soa(t, y:(3,nsys))
    -> (3,nsys)`` and ``jac_soa -> (3,3,nsys)``; same rates as
    :func:`batched_robertson` for the same arguments."""
    _, k1, k2, k3 = _rate_tensors(nsys, rates, seed, device, dtype)

    def f_soa(t, y):  # y: (3, nsys)
        a, b, c = y[0], y[1], y[2]
        r1, r2, r3 = k1 * a, k2 * b * c, k3 * b * b
        return torch.stack([-r1 + r2, r1 - r2 - r3, r3], dim=0)

    def jac_soa(t, y):  # -> (3, 3, nsys)
        a, b, c = y[0], y[1], y[2]
        z = torch.zeros_like(a)
        return torch.stack([
            torch.stack([-k1, k2 * c, k2 * b], dim=0),
            torch.stack([k1, -k2 * c - 2 * k3 * b, -k2 * b], dim=0),
            torch.stack([z, 2 * k3 * b, z], dim=0)], dim=0)

    return f_soa, jac_soa
