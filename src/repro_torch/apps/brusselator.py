"""The paper's demonstration problem (§7): 1D advection-reaction Brusselator.

    u_t = -c u_x + A - (w+1) u + v u^2
    v_t = -c v_x + w u - v u^2
    w_t = -c w_x + (B - w)/eps - w u

Counterpart of ``repro.apps.brusselator``, with the same arithmetic:
first-order upwind on a periodic uniform mesh (``torch.roll``), the
state ``y`` an ``(nx, 3)`` tensor, and IMEX integration with ARKODE's
ARK3(2)4L[2]SA: advection explicit, the stiff reactions implicit.  Two
nonlinear-solver configurations, the paper's:

* **task-local** — Newton whose linear solve is the batched 3x3
  block-diagonal solve (``direct.block_solve``: on the card the
  Gauss-Jordan kernel of PERF.md row 8); the only global operation is
  the WRMS norm (the kernel of row 14);
* **global** — Newton + GMRES on the full system with the block solve
  as right preconditioner.

The entry points run on the card unless the CPU is asked for:
``device="cpu"``, or ``integrate(..., policy=ExecPolicy(device="cpu"))``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.brusselator import BrusselatorConfig
from ..core import arkode, butcher, direct, krylov, matrix
from ..core import dispatch as dv
from ..core.arkode import ODEOptions
from ..core.policies import DEFAULT, ExecPolicy, resolve_device


def initial_state(cfg: BrusselatorConfig, device=None) -> torch.Tensor:
    """y: (nx, 3) float64 with the gaussian-bump initial condition."""
    dev = resolve_device(device)
    # the reference's linspace(0, b, nx, endpoint=False): b * (i / nx)
    x = cfg.b_domain * (torch.arange(cfg.nx, dtype=torch.float64,
                                     device=dev) / cfg.nx)
    mu, sigma = cfg.b_domain / 2.0, cfg.b_domain / 4.0
    p = cfg.alpha * torch.exp(-((x - mu) ** 2) / (2 * sigma ** 2))
    return torch.stack([cfg.A + p, cfg.B / cfg.A + p, 3.0 + p], dim=1)


def advection_rhs(cfg: BrusselatorConfig):
    dx = cfg.b_domain / cfg.nx

    def fe(t, y):
        # first-order upwind (c > 0), periodic
        return -(cfg.c / dx) * (y - torch.roll(y, 1, dims=0))

    return fe


def reaction_rhs(cfg: BrusselatorConfig):
    def fi(t, y):
        u, v, w = y[:, 0], y[:, 1], y[:, 2]
        du = cfg.A - (w + 1.0) * u + v * u * u
        dv_ = w * u - v * u * u
        dw = (cfg.B - w) / cfg.eps - w * u
        return torch.stack([du, dv_, dw], dim=1)

    return fi


def reaction_jacobian(cfg: BrusselatorConfig):
    """Analytic per-point 3x3 Jacobian blocks: (nx, 3, 3)."""

    def jac(t, y):
        u, v, w = y[:, 0], y[:, 1], y[:, 2]
        z = torch.zeros_like(u)
        row0 = torch.stack([-(w + 1.0) + 2.0 * v * u, u * u, -u], dim=1)
        row1 = torch.stack([w - 2.0 * v * u, -u * u, u], dim=1)
        row2 = torch.stack([-w, z, -1.0 / cfg.eps - u], dim=1)
        return torch.stack([row0, row1, row2], dim=1)

    return jac


def jacobian_csr_pattern(nx: int):
    """The CSR pattern of the Jacobian of fe + fi over the flat state
    (row 3*i + s): the columns (i, 0..2) and the upwind ((i-1) mod nx,
    s), sorted within the row (4 entries a row, 12*nx in all), as numpy
    ``(indptr, indices)``; and ``order (nx, 3, 4)``, which sorts a row's
    natural entries [block row..., upwind] into the pattern's order."""
    i = np.arange(nx)
    blk = np.broadcast_to((3 * i[:, None] + np.arange(3))[:, None, :],
                          (nx, 3, 3))
    up = (3 * ((i - 1) % nx)[:, None] + np.arange(3))[:, :, None]
    natural = np.concatenate([blk, up], axis=2)
    order = np.argsort(natural, axis=2, kind="stable")
    return (np.arange(0, 12 * nx + 1, 4),
            np.take_along_axis(natural, order, 2).reshape(-1), order)


#: profiler range of the plain code that builds the Newton blocks
JACOBIAN = "brusselator.jacobian"


def _newton_blocks(jac, t, z, gamma) -> matrix.BlockDiagMatrix:
    """I - gamma*J(t, z), (nx, 3, 3), under the :data:`JACOBIAN` range."""
    with torch.profiler.record_function(JACOBIAN):
        return matrix.bd_scale_addi(-gamma, matrix.BlockDiagMatrix(jac(t, z)))


def task_local_lin_solver(cfg: BrusselatorConfig,
                          policy: ExecPolicy = DEFAULT):
    """(t, z, gamma, rhs) -> dz via the batched 3x3 block solve."""
    jac = reaction_jacobian(cfg)

    def solve(t, z, gamma, rhs):
        return direct.block_solve(_newton_blocks(jac, t, z, gamma), rhs,
                                  policy)

    return solve


def global_gmres_lin_solver(cfg: BrusselatorConfig,
                            policy: ExecPolicy = DEFAULT):
    """(t, z, gamma, rhs) -> dz via GMRES with the block solve as
    preconditioner (the paper's 'global' configuration)."""
    fi = reaction_rhs(cfg)
    jac = reaction_jacobian(cfg)

    def solve(t, z, gamma, rhs):
        def matvec(v):
            _, jv = torch.func.jvp(lambda zz: fi(t, zz), (z,), (v,))
            # v - gamma*jv, rounded as the reference's
            return dv.linear_sum(1.0, v, -gamma, jv, policy)

        M = _newton_blocks(jac, t, z, gamma)

        def precond(v):
            return direct.block_solve(M, v, policy)

        dz, _ = krylov.gmres(matvec, rhs, tol=1e-4, restart=16,
                             max_restarts=2, precond=precond, policy=policy)
        return dz

    return solve


def integrate(cfg: BrusselatorConfig, *, t_final: Optional[float] = None,
              policy: ExecPolicy = DEFAULT,
              opts: Optional[ODEOptions] = None):
    """Run the IMEX integration; returns (y_final, stats).

    One deliberate difference from the reference: ``policy`` also goes
    into the default ODEOptions and into GMRES, so a kernel run uses the
    kernels end to end (stage sums, norms, dots) and a plain run
    (``ExecPolicy(backend="torch")``) is plain end to end.  The
    reference applies its policy to the block solve only
    (``brusselator.py:121,139-140``) and runs its vector ops in jnp,
    which its own tests hold to its Pallas ops within rounding: the same
    function.  The run happens on ``policy.device`` (None: the card).
    """
    tf = t_final if t_final is not None else cfg.t_final
    y0 = initial_state(cfg, policy.device)
    fe = advection_rhs(cfg)
    fi = reaction_rhs(cfg)
    if cfg.solver == "task-local":
        lin = task_local_lin_solver(cfg, policy)
    else:
        lin = global_gmres_lin_solver(cfg, policy)
    o = opts or ODEOptions(rtol=cfg.rtol, atol=cfg.atol, max_steps=100_000,
                           newton_max=6, policy=policy)
    return arkode.imex_integrate(fe, fi, y0, 0.0, tf, butcher.ARK324, o,
                                 lin_solver=lin)


def reference_solution(cfg: BrusselatorConfig, t_final: float,
                       n_steps: int = 20000, device=None):
    """Fine fixed-step explicit reference (expensive; small tf only)."""
    y0 = initial_state(cfg, device)
    fe = advection_rhs(cfg)
    fi = reaction_rhs(cfg)

    def f(t, y):
        return fe(t, y) + fi(t, y)

    return arkode.erk_fixed(f, y0, 0.0, t_final, n_steps,
                            butcher.DORMAND_PRINCE)
