"""A plain batched stiff integrator: the benchmark's reference solution.

Extrapolated linearly implicit Euler (Deuflhard's method; Hairer and
Wanner, *Solving ODEs II*, §IV.9) at a fixed order, with a step size of
its own for every system.  One step of size ``H`` from ``y0``:

* ``J = jac(t0, y0)``, held for the whole step;
* for ``j = 1..K``, ``n_j = j`` substeps of ``h = H / n_j``:
  ``(I - h J) d = h f(t, y)``, ``y <- y + d``, giving ``T[j, 1]``;
* Aitken-Neville: ``T[j, k+1] = T[j, k] + (T[j, k] - T[j-1, k]) /
  (n_j / n_{j-k} - 1)``; ``T[K, K]`` is the result (order ``K``), and
  ``T[K, K] - T[K, K-1]`` its error estimate.

Every substep keeps a linear invariant ``e`` of ``f`` (``e . f = 0``,
so ``e . J = 0``) exactly in exact arithmetic, and the extrapolation
weights sum to one: the reference solution of a kinetics ensemble
conserves mass to rounding.

It is written in plain PyTorch with no code of the program under test:
the linear algebra is ``torch.linalg.lu_factor`` / ``lu_solve``.  The
systems ride as a batch, each with its own ``t`` and ``H``; a system
that has reached its next output time waits (``H = 0``) until all have.
"""
from __future__ import annotations

import torch

#: extrapolation depth: order K, K(K+1)/2 RHS evaluations and K LU
#: factorisations a step
K = 6
SAFETY, FAC_MIN, FAC_MAX = 0.9, 0.2, 4.0


def _wrms(err, y0, y1, rtol, atol):
    sc = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return torch.sqrt(torch.mean((err / sc) ** 2, dim=1))


def _step(f, jac, t, y, H, params):
    """One extrapolated step of size ``H`` (per system) from ``(t, y)``:
    ``(T[K, K], T[K, K-1])``."""
    nsys, n = y.shape
    J = jac(t, y, params)
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    T = []
    for j in range(1, K + 1):
        h = (H / j)[:, None]
        lu, piv = torch.linalg.lu_factor(eye - h[:, :, None] * J)
        yj, tj = y, t
        for _ in range(j):
            d = torch.linalg.lu_solve(lu, piv, (h * f(tj, yj, params))
                                      [:, :, None])[:, :, 0]
            yj = yj + d
            tj = tj + h[:, 0]
        row = [yj]
        for k in range(1, j):
            prev = T[j - 2][k - 1]
            row.append(row[k - 1] + (row[k - 1] - prev) / (j / (j - k) - 1))
        T.append(row)
    return T[K - 1][K - 1], T[K - 1][K - 2]


def integrate(f, jac, y0, params, t_out, *, rtol, atol, h0=1e-6,
              max_steps=200_000):
    """Integrate ``y' = f(t, y, params)`` from ``t = 0`` for a batch
    ``y0`` of shape (nsys, n), and return the states at the increasing
    output times ``t_out`` as a tensor (len(t_out), nsys, n).

    ``f(t, y, params)`` and ``jac(t, y, params)`` take ``t`` of shape
    (nsys,) and ``y`` of shape (nsys, n) and return (nsys, n) and
    (nsys, n, n).  Raises ``RuntimeError`` when a system makes no
    progress: the step size underflows or ``max_steps`` is reached."""
    dtype, dev = y0.dtype, y0.device
    nsys = y0.shape[0]
    y = y0.clone()
    t = torch.zeros((nsys,), dtype=dtype, device=dev)
    H = torch.full((nsys,), h0, dtype=dtype, device=dev)
    out = []
    steps = 0
    for t_end in t_out:
        t_end_t = torch.full((nsys,), float(t_end), dtype=dtype, device=dev)
        while True:
            left = t_end_t - t
            active = left > 0
            if not bool(active.any()):
                break
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"reference: more than {max_steps} steps")
            Hs = torch.where(active, torch.minimum(H, left), 0.0)
            last = Hs >= left
            y_hi, y_lo = _step(f, jac, t, y, Hs, params)
            err = _wrms(y_hi - y_lo, y, y_hi, rtol, atol)
            err = torch.where(torch.isfinite(err), err, torch.inf)
            ok = active & (err <= 1.0)
            y = torch.where(ok[:, None], y_hi, y)
            t = torch.where(ok, torch.where(last, t_end_t, t + Hs), t)
            fac = SAFETY * torch.clamp(err, min=1e-10) ** (-1.0 / K)
            fac = torch.clamp(fac, FAC_MIN, FAC_MAX)
            fac = torch.where(ok, fac, torch.minimum(fac, torch.ones_like(
                fac)))
            # a step cut to reach t_end keeps the size it had before
            H = torch.where(active, torch.where(ok & last,
                                                torch.maximum(H, Hs * fac),
                                                Hs * fac), H)
            if bool((active & (H <= 1e-14 * t_end_t.abs().clamp(min=1.0))
                     ).any()):
                raise RuntimeError("reference: step size underflow")
        out.append(y.clone())
    return torch.stack(out)
