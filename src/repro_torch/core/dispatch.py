"""Policy-routed ops of the ensemble paths.

Counterpart of thirteen entries of ``repro.core.dispatch``
(``dispatch.py:393,622-643,666-739``), with the same names and argument
order: the seven ``*_soa`` ops of the ensemble BDF path, the vector ops
``linear_sum``, ``axpy``, ``linear_combination`` and ``dot`` of the
Krylov solvers, and the sparse ensemble's ``bsr_spmv_soa`` and
``bsr_block_jacobi_inverse_soa``.
Each op routes per :class:`~repro_torch.core.policies.ExecPolicy`:
``"torch"`` runs the plain version, ``"auto"`` the kernel wrapper (the
CUDA kernel for a CUDA tensor, the plain version for a CPU tensor), and
``"cuda"`` the kernel wrapper after checking that the tensor lies on the
card.  ``linear_sum`` and ``axpy`` go through the linear-combination
kernel with K = 2, as in the reference (``dispatch.py:107-112``), and
their ``"torch"`` backend through its plain version, which sums
``c_0 x_0 + c_1 x_1`` in that order as the reference's ``a*x + b*y`` and
``a*x + y`` do (``1*y`` is exact).  The other reference ops wait for
ROADMAP queue A item 7.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ..kernels import block_solve as _bs
from ..kernels import blockdiag_spmv as _sp
from ..kernels import newton as _nw
from ..kernels import sparse as _sx
from ..kernels import vecops as _vo
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


def linear_combination(coeffs, vecs: Sequence[torch.Tensor],
                       policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """z = sum_k c_k * X_k in one pass; the coefficients are numbers or
    0-d tensors (or one ``(K,)`` tensor) on the vectors' device."""
    return _route("linear_combination", policy,
                  _vo.linear_combination_plain, _vo.linear_combination,
                  vecs[0])(coeffs, vecs)


def linear_sum(a, x: torch.Tensor, b, y: torch.Tensor,
               policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """z = a*x + b*y."""
    lincomb = _route("linear_sum", policy, _vo.linear_combination_plain,
                     _vo.linear_combination, x)
    return lincomb((a, b), (x, y))


def axpy(a, x: torch.Tensor, y: torch.Tensor,
         policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """z = a*x + y."""
    lincomb = _route("axpy", policy, _vo.linear_combination_plain,
                     _vo.linear_combination, x)
    return lincomb((a, 1.0), (x, y))


def dot(x: torch.Tensor, y: torch.Tensor,
        policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """<x, y> over all elements, a 0-d tensor on their device."""
    return _route("dot", policy, _vo.dot_plain, _vo.dot, x)(x, y)


def bsr_spmv_soa(values, x, pattern,
                 policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """Ensemble shared-pattern BSR SpMV: values (nnzb,b,b,NB),
    x (nblk,b,NB), pattern = (brows, bcols, nblk) -> y (nblk,b,NB)."""
    return _route("bsr_spmv_soa", policy, _sx.bsr_spmv_soa_plain,
                  _sx.bsr_spmv_soa, values)(values, x, pattern)


@functools.lru_cache(maxsize=64)
def _diag_blocks(pattern: tuple, device: torch.device) -> torch.Tensor:
    """Index of the first entry of each diagonal block (I, I)."""
    brows, bcols, nblk = pattern
    idx = []
    for I in range(nblk):
        hits = [e for e, (i, j) in enumerate(zip(brows, bcols))
                if i == I and j == I]
        if not hits:
            raise ValueError(f"pattern lacks diagonal block ({I},{I})")
        idx.append(hits[0])
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def bsr_block_jacobi_inverse_soa(values, pattern,
                                 policy: Optional[ExecPolicy] = None
                                 ) -> torch.Tensor:
    """Invert every diagonal block of the shared pattern (the
    block-Jacobi psetup): values (nnzb,b,b,NB) -> (b,b,nblk*NB), block I
    of system s at I*NB + s.  A gather of the diagonal blocks, then
    ``block_inverse_soa`` over the flattened nblk*NB batch
    (``repro/kernels/ops.py:416-439``)."""
    b, nb = values.shape[1], values.shape[3]
    D = values[_diag_blocks(pattern, values.device)]   # (nblk, b, b, NB)
    D = D.permute(1, 2, 0, 3).reshape(b, b, pattern[2] * nb)
    return block_inverse_soa(D, policy)
