"""The ensemble integrators' test problems.

Counterpart of ``repro.core.problems``: batched Robertson kinetics
(``batched_robertson``, ``batched_robertson_soa``), the serving tier's
parametric families (``robertson_family``, ``decay_chain_family``) and
the ensemble Brusselator (``ensemble_brusselator``).  The reference draws its
per-cell Robertson rates with ``jax.random``, which PyTorch cannot
reproduce, so here they come from the caller (``rates=``) or from numpy
with the reference's distributions (:func:`robertson_rates`); a test
hands the same numpy arrays to both packages.
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
    """``(device, {"k1", "k2", "k3"})``: the rates as ``(nsys,)``
    tensors, the params of :func:`robertson_family`."""
    dev = resolve_device(device)
    if rates is None:
        rates = robertson_rates(nsys, seed)
    out = {k: torch.as_tensor(rates[k], dtype=dtype, device=dev)
           for k in ("k1", "k2", "k3")}
    for k, v in out.items():
        if v.shape != (nsys,):
            raise ValueError(f"rate {k} has shape {tuple(v.shape)}, "
                             f"want ({nsys},)")
    return dev, out


def batched_robertson(nsys: int, *, rates=None, seed: int = 0, device=None,
                      dtype=torch.float64):
    """``(f, jac, y0)``: ``f(t, y:(nsys,3)) -> (nsys,3)`` and
    ``jac(t, y) -> (nsys,3,3)`` with the rates closed over (the
    arithmetic of :func:`robertson_family`); ``y0`` is ``[1, 0, 0]`` per
    system.  ``device=None`` means the card."""
    dev, p = _rate_tensors(nsys, rates, seed, device, dtype)
    f, jac, _, _ = robertson_family()
    y0 = torch.zeros((nsys, 3), dtype=dtype, device=dev)
    y0[:, 0] = 1.0
    return (lambda t, y: f(t, y, p)), (lambda t, y: jac(t, y, p)), y0


def batched_robertson_soa(nsys: int, *, rates=None, seed: int = 0,
                          device=None, dtype=torch.float64):
    """Native SoA companions, system axis LAST: ``f_soa(t, y:(3,nsys))
    -> (3,nsys)`` and ``jac_soa -> (3,3,nsys)``; same rates as
    :func:`batched_robertson` for the same arguments."""
    _, p = _rate_tensors(nsys, rates, seed, device, dtype)
    _, _, f_soa, jac_soa = robertson_family()
    return (lambda t, y: f_soa(t, y, p)), (lambda t, y: jac_soa(t, y, p))


def robertson_family():
    """Parametric Robertson kinetics for the serving tier (reference
    ``problems.py:82``): the problem of :func:`batched_robertson` with
    the rates as per-request data, ``params = {"k1", "k2", "k3"}`` each
    of shape (nsys,), so requests with other chemistry share one bundle.

    Returns ``(f, jac, f_soa, jac_soa)``: ``f(t:(nsys,), y:(nsys,3),
    params) -> (nsys,3)``, ``jac -> (nsys,3,3)``, and the SoA forms
    (``y:(3,nsys)``, ``jac_soa -> (3,3,nsys)``); n = 3.  The arithmetic
    is the one :func:`batched_robertson` closes its rates into.
    """

    def f(t, y, p):  # y: (nsys, 3)
        a, b, c = y[:, 0], y[:, 1], y[:, 2]
        r1, r2, r3 = p["k1"] * a, p["k2"] * b * c, p["k3"] * b * b
        return torch.stack([-r1 + r2, r1 - r2 - r3, r3], dim=1)

    def jac(t, y, p):
        a, b, c = y[:, 0], y[:, 1], y[:, 2]
        k1, k2, k3 = p["k1"], p["k2"], p["k3"]
        z = torch.zeros_like(a)
        return torch.stack([
            torch.stack([-k1, k2 * c, k2 * b], dim=1),
            torch.stack([k1, -k2 * c - 2 * k3 * b, -k2 * b], dim=1),
            torch.stack([z, 2 * k3 * b, z], dim=1)], dim=1)

    def f_soa(t, y, p):  # y: (3, nsys)
        a, b, c = y[0], y[1], y[2]
        r1, r2, r3 = p["k1"] * a, p["k2"] * b * c, p["k3"] * b * b
        return torch.stack([-r1 + r2, r1 - r2 - r3, r3], dim=0)

    def jac_soa(t, y, p):  # -> (3, 3, nsys)
        a, b, c = y[0], y[1], y[2]
        k1, k2, k3 = p["k1"], p["k2"], p["k3"]
        z = torch.zeros_like(a)
        return torch.stack([
            torch.stack([-k1, k2 * c, k2 * b], dim=0),
            torch.stack([k1, -k2 * c - 2 * k3 * b, -k2 * b], dim=0),
            torch.stack([z, 2 * k3 * b, z], dim=0)], dim=0)

    return f, jac, f_soa, jac_soa


def decay_chain_family(n: int = 6):
    """Parametric linear decay chain of ``n`` species, the serving tier's
    second shape (reference ``problems.py:127``): ``dy_0/dt = -k_0 y_0``,
    ``dy_i/dt = k_{i-1} y_{i-1} - k_i y_i``, with per-request rates
    ``params = {"k": (nsys, n)}``.  The Jacobian is lower bidiagonal.

    Returns ``(f, jac, f_soa, jac_soa)`` in the conventions of
    :func:`robertson_family`.
    """

    def f(t, y, p):  # y: (nsys, n)
        r = p["k"] * y
        return -r + torch.cat([torch.zeros_like(r[:, :1]), r[:, :-1]], dim=1)

    def jac(t, y, p):  # -> (nsys, n, n)
        k = p["k"]
        return torch.diag_embed(-k) + torch.diag_embed(k[:, :-1], offset=-1)

    def f_soa(t, y, p):  # y: (n, nsys)
        # the kernels take contiguous SoA tensors: transpose k once
        r = p["k"].T.contiguous() * y
        return -r + torch.cat([torch.zeros_like(r[:1]), r[:-1]], dim=0)

    def jac_soa(t, y, p):  # -> (n, n, nsys)
        return jac(t, y.T, p).permute(1, 2, 0).contiguous()

    return f, jac, f_soa, jac_soa


def _brusselator(nsys, nx, du, dv, a, device, dtype):
    """The shared pieces of :func:`ensemble_brusselator`: device, the
    per-member ``b`` (nsys,), the grid factor and the SoA pair."""
    dev = resolve_device(device)
    bpar = torch.linspace(1.8, 3.2, nsys, dtype=dtype, device=dev)
    h2 = 1.0 / ((1.0 / max(nx, 2)) ** 2)
    n = 2 * nx

    def lap(w):                       # (nx, nsys), no-flux (reflecting)
        wl = torch.cat([w[:1], w[:-1]], dim=0)
        wr = torch.cat([w[1:], w[-1:]], dim=0)
        return (wl - 2.0 * w + wr) * h2

    def f_soa(t, y):                  # y: (2*nx, nsys)
        u, v = y[0::2], y[1::2]
        uv2 = u * u * v
        fu = a - (bpar + 1.0) * u + uv2 + du * lap(u)
        fv = bpar * u - uv2 + dv * lap(v)
        return torch.stack([fu, fv], dim=1).reshape(n, y.shape[1])

    # d(lap)/dw_i: -2, plus 1 at each reflecting boundary
    c = torch.full((nx, 1), -2.0, dtype=dtype, device=dev)
    c[0] += 1.0
    c[-1] += 1.0
    iu = torch.arange(0, n, 2, device=dev)
    iv = iu + 1

    def jac_soa(t, y):                # -> (2*nx, 2*nx, nsys), banded
        u, v = y[0::2], y[1::2]
        J = torch.zeros((n, n, y.shape[1]), dtype=dtype, device=dev)
        J[iu, iu] = -(bpar + 1.0) + 2.0 * u * v + du * c * h2
        J[iu, iv] = u * u
        J[iv, iu] = bpar - 2.0 * u * v
        J[iv, iv] = -(u * u) + dv * c * h2
        for i, d in ((iu, du), (iv, dv)):
            J[i[1:], i[:-1]] = d * h2             # w_i <- w_{i-1}
            J[i[:-1], i[1:]] = d * h2             # w_i <- w_{i+1}
        return J

    return dev, bpar, f_soa, jac_soa


def ensemble_brusselator(nsys: int, nx: int = 16, du: float = 0.02,
                         dv: float = 0.02, a: float = 1.0, *, device=None,
                         dtype=torch.float64):
    """An ensemble of 1-D Brusselator reaction-diffusion systems, the
    banded-Jacobian submodel workload.

    Each of the ``nsys`` members is the 2-species Brusselator on ``nx``
    cells with no-flux boundaries and its own reaction parameter
    ``b = linspace(1.8, 3.2, nsys)``.  The state is interleaved
    ``[u_0, v_0, u_1, v_1, ...]`` (n = 2*nx).

    Returns ``(f, jac, jac_sparsity, y0)`` as the reference does: the
    batched RHS ``(t:(nsys,), y:(nsys, n)) -> (nsys, n)``, the Jacobian
    ``-> (nsys, n, n)`` (written out analytically; the reference takes
    ``jax.jacfwd``), the static ``(n, n)`` boolean pattern and a
    perturbed near-steady start.  ``f``/``jac`` are views of the native
    SoA pair of :func:`ensemble_brusselator_soa`, so the integrators'
    boundary transposes cost nothing.  ``device=None`` means the card.
    """
    dev, bpar, f_soa, jac_soa = _brusselator(nsys, nx, du, dv, a, device,
                                             dtype)
    n = 2 * nx

    def f(t, y):                      # y: (nsys, n)
        return f_soa(t, y.T).T

    def jac(t, y):
        return jac_soa(t, y.T).permute(2, 0, 1)

    P = np.zeros((n, n), bool)
    for i in range(nx):
        P[2 * i:2 * i + 2, 2 * i:2 * i + 2] = True    # reaction block
        for j in (i - 1, i + 1):                      # Laplacian coupling
            if 0 <= j < nx:
                P[2 * i, 2 * j] = True                # u_i <- u_j
                P[2 * i + 1, 2 * j + 1] = True        # v_i <- v_j
    x = torch.linspace(0.0, 1.0, nx, dtype=dtype, device=dev)
    u0 = a + 0.1 * torch.sin(2 * torch.pi * x)
    v0 = (bpar / a)[:, None] + 0.1 * torch.cos(2 * torch.pi * x)[None, :]
    y0 = torch.stack([u0.expand(nsys, nx), v0], dim=2).reshape(nsys, n)
    return f, jac, P, y0


def ensemble_brusselator_soa(nsys: int, nx: int = 16, du: float = 0.02,
                             dv: float = 0.02, a: float = 1.0, *,
                             device=None, dtype=torch.float64):
    """Native SoA companions of :func:`ensemble_brusselator` for the same
    arguments, system axis LAST: ``f_soa(t, y:(n,nsys)) -> (n,nsys)``
    and ``jac_soa -> (n,n,nsys)``."""
    _, _, f_soa, jac_soa = _brusselator(nsys, nx, du, dv, a, device, dtype)
    return f_soa, jac_soa
