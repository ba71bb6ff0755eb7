"""Policy-routed SoA ops of the ensemble BDF path.

Counterpart of the seven ``*_soa`` entries of ``repro.core.dispatch``
(``dispatch.py:393,666-717``), with the same names and argument order.
Each op routes per :class:`~repro_torch.core.policies.ExecPolicy`:
``"torch"`` runs the plain version, ``"auto"`` the kernel wrapper (the
CUDA kernel for a CUDA tensor, the plain version for a CPU tensor), and
``"cuda"`` the kernel wrapper after checking that the tensor lies on the
card.  The other reference ops wait for ROADMAP queue A item 7.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import block_solve as _bs
from ..kernels import blockdiag_spmv as _sp
from ..kernels import newton as _nw
from .policies import DEFAULT, ExecPolicy


def _route(op: str, policy: Optional[ExecPolicy], plain, wrapper,
           lead: torch.Tensor):
    backend = (policy or DEFAULT).backend
    if backend == "torch":
        return plain
    if backend == "cuda" and not lead.is_cuda:
        raise ValueError(f"{op}: backend 'cuda' needs CUDA tensors, got one "
                         f"on {lead.device}")
    return wrapper


def block_solve_soa(A, r, policy: Optional[ExecPolicy] = None):
    """Solve every block system: A (b,b,NB), r (b,NB) -> x (b,NB)."""
    return _route("block_solve_soa", policy, _bs.block_solve_soa_plain,
                  _bs.block_solve_soa, A)(A, r)


def block_inverse_soa(A, policy: Optional[ExecPolicy] = None):
    """Invert every block: A (b,b,NB) -> A^{-1} (b,b,NB) (lsetup)."""
    return _route("block_inverse_soa", policy, _bs.block_inverse_soa_plain,
                  _bs.block_inverse_soa, A)(A)


def blockdiag_spmv_soa(A, x, policy: Optional[ExecPolicy] = None):
    """y = blockdiag(A) @ x: A (b,b,NB), x (b,NB) -> (b,NB) (lsolve)."""
    return _route("blockdiag_spmv_soa", policy, _sp.blockdiag_spmv_soa_plain,
                  _sp.blockdiag_spmv_soa, A)(A, x)


def newton_residual_soa(z, fval, psi, gamma,
                        policy: Optional[ExecPolicy] = None, *,
                        negate: bool = False):
    """g = z - gamma*f - psi; z/f/psi (n, nsys), gamma (nsys,);
    ``negate=True`` emits -g (the Newton rhs)."""
    return _route("newton_residual_soa", policy, _nw.newton_residual_plain,
                  _nw.newton_residual, z)(z, fval, psi, gamma, negate=negate)


def masked_update_wrms_soa(z, dz, w, mask,
                           policy: Optional[ExecPolicy] = None):
    """-> (where(mask, z+dz, z), per-system WRMS of dz)."""
    return _route("masked_update_wrms_soa", policy,
                  _nw.masked_update_wrms_plain, _nw.masked_update_wrms,
                  z)(z, dz, w, mask)


def history_rescale_soa(W, Z, active, policy: Optional[ExecPolicy] = None):
    """where(active, sum_i W[j,i]*Z[i], Z[j]); W (q1,q1,nsys),
    Z (q1,n,nsys)."""
    return _route("history_rescale_soa", policy, _nw.history_rescale_plain,
                  _nw.history_rescale, Z)(W, Z, active)


def wrms_soa(v, w, policy: Optional[ExecPolicy] = None):
    """Per-system WRMS over the state axis: v/w (n, nsys) -> (nsys,)."""
    return _route("wrms_soa", policy, _nw.wrms_soa_plain, _nw.wrms_soa,
                  v)(v, w)
