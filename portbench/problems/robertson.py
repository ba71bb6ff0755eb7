"""Robertson kinetics, one independent 3-species system a group.

``y' = f(y)``: ``r1 = k1 y1``, ``r2 = k2 y2 y3``, ``r3 = k3 y2^2``,
``f = (-r1 + r2, r1 - r2 - r3, r3)``.  As in the configuration's
source, every group has the same rates ``(k1, k2, k3)`` and the same
start ``y0``; ``y1 + y2 + y3`` is conserved.

This file holds the benchmark's side of the problem: the inputs, the
plain reference right-hand side and Jacobian, and the call that hands
the same inputs to the program's own problem library.
"""
from __future__ import annotations

import torch


def draw(cfg, nsys, gen, device):
    """The inputs of ``nsys`` groups, in float64: ``{"params": {"k1",
    "k2", "k3"}, "y0": (nsys, 3)}``.  The source gives every group the
    same chemistry and start, so nothing is drawn from ``gen``."""
    params = {k: torch.full((nsys,), float(cfg[k]), dtype=torch.float64,
                            device=device) for k in ("k1", "k2", "k3")}
    y0 = torch.tensor(cfg["y0"], dtype=torch.float64,
                      device=device).expand(nsys, 3).contiguous()
    return {"params": params, "y0": y0}


def program_ivp(cfg, inputs):
    """The program's problem for these inputs: the port's own Robertson
    right-hand side and Jacobian (``core/problems.py``) with the given
    rates, as a code that links the port would build it."""
    from repro_torch.core import ivp, problems
    rates, y0 = inputs["params"], inputs["y0"]
    nsys = y0.shape[0]
    kw = dict(rates=rates, device=y0.device, dtype=y0.dtype)
    f, jac, _ = problems.batched_robertson(nsys, **kw)
    f_soa, jac_soa = problems.batched_robertson_soa(nsys, **kw)
    return ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa)


def rhs(t, y, p, cfg):
    """Plain reference right-hand side: (nsys, 3) -> (nsys, 3)."""
    a, b, c = y[:, 0], y[:, 1], y[:, 2]
    r1, r2, r3 = p["k1"] * a, p["k2"] * b * c, p["k3"] * b * b
    return torch.stack([-r1 + r2, r1 - r2 - r3, r3], dim=1)


def jac(t, y, p, cfg):
    """Plain reference Jacobian: (nsys, 3) -> (nsys, 3, 3)."""
    b, c = y[:, 1], y[:, 2]
    k1, k2, k3 = p["k1"], p["k2"], p["k3"]
    z = torch.zeros_like(b)
    return torch.stack([
        torch.stack([-k1, k2 * c, k2 * b], dim=1),
        torch.stack([k1, -k2 * c - 2.0 * k3 * b, -k2 * b], dim=1),
        torch.stack([z, 2.0 * k3 * b, z], dim=1)], dim=1)


def conserved(y):
    """The quantities the exact solution conserves, per lane: the mass
    ``y1 + y2 + y3``."""
    return {"mass": y.sum(dim=1)}
