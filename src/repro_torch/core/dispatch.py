"""Policy-routed ops of the port.

Counterpart of the nineteen entries of ``repro.core.dispatch``
(``dispatch.py:393,610-743``), with the same names and argument
order: the seven ``*_soa`` ops of the ensemble BDF path, the N_Vector
ops ``linear_sum``, ``axpy``, ``linear_combination``,
``scale_add_multi``, ``dot``, ``dot_prod_multi``, ``wrms_norm``,
``wrms_ss`` and ``wrms_norm_mask``, and the sparse ops ``csr_spmv``
(``SparseCSR.matvec``), ``bsr_spmv_soa`` and
``bsr_block_jacobi_inverse_soa``.
One route is the port's own, not one of the nineteen:
``lagrange_rescale_soa``, the ensemble BDF's history rebuild with its
Lagrange matrix formed inside the kernel (the reference builds W in
its jitted step, where XLA fuses the build; eager PyTorch would spend
some 60 launches on it).
Each op routes per :class:`~repro_torch.core.policies.ExecPolicy`:
``"torch"`` runs the plain version, ``"auto"`` the kernel wrapper (the
CUDA kernel for a CUDA tensor, the plain version for a CPU tensor), and
``"cuda"`` the kernel wrapper after checking that the tensor lies on the
card.  ``linear_sum`` and ``axpy`` go through the linear-combination
kernel with K = 2, as in the reference (``dispatch.py:107-112``), and
their ``"torch"`` backend through its plain version, which sums
``c_0 x_0 + c_1 x_1`` in that order as the reference's ``a*x + b*y`` and
``a*x + y`` do (``1*y`` is exact).

The N_Vector ops take a vector that is a tensor or a tuple of tensors
(the reference's pytrees) and run leaf by leaf as the reference's
Pallas wrappers do (``dispatch.py:70-204``): reductions cast every leaf
to the result type of all leaves and sum the per-leaf results in leaf
order; ``wrms_norm`` and ``wrms_norm_mask`` divide by the total element
count, masked entries included.  Reductions return 0-d (or ``(K,)``)
tensors on the vectors' device, so the host reads a norm only where a
caller decides on it.  A linear combination of more terms than one
kernel launch takes is chained: each launch after the first adds
``1 * (the partial sum)`` first, which is exact, so the sum keeps the
reference's order and its rounding.
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
from . import vector as _nv
from .policies import DEFAULT, ExecPolicy
from .sunmatrix import CSRPattern

_leaves = _nv.leaves


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


def lagrange_rescale_soa(eta, q, Z, active,
                         policy: Optional[ExecPolicy] = None):
    """``history_rescale_soa(lagrange_matrix_soa(eta, q), Z, active)``:
    eta (nsys,), q (nsys,) int32, Z (6, n, nsys); the kernel forms W
    from (eta, q) and never stores it."""
    return _route("lagrange_rescale_soa", policy, _nw.lagrange_rescale_plain,
                  _nw.lagrange_rescale, Z)(eta, q, Z, active)


def wrms_soa(v, w, policy: Optional[ExecPolicy] = None):
    """Per-system WRMS over the state axis: v/w (n, nsys) -> (nsys,)."""
    return _route("wrms_soa", policy, _nw.wrms_soa_plain, _nw.wrms_soa,
                  v)(v, w)


def _like(v, leaves):
    """``leaves`` in the structure of ``v`` (a tuple or one tensor)."""
    return tuple(leaves) if isinstance(v, tuple) else leaves[0]


def _result_type(*leaves) -> torch.dtype:
    return functools.reduce(torch.promote_types, (t.dtype for t in leaves))


def _flat(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.reshape(-1).to(dtype)


def _chained(lincomb, coeffs, vecs: list):
    """sum_k c_k vecs[k] by launches of at most ``LINCOMB_MAX_K`` terms,
    the partial sum carried in with coefficient 1."""
    K = _vo.LINCOMB_MAX_K
    cs = list(coeffs.unbind(0)) if torch.is_tensor(coeffs) else list(coeffs)
    z = lincomb(cs[:K], vecs[:K])
    for s in range(K, len(vecs), K - 1):
        z = lincomb([1.0] + cs[s:s + K - 1], [z] + vecs[s:s + K - 1])
    return z


def linear_combination(coeffs, vecs: Sequence,
                       policy: Optional[ExecPolicy] = None):
    """z = sum_k c_k * X_k in one pass per leaf; the coefficients are
    numbers or 0-d tensors (or one ``(K,)`` tensor) on the vectors'
    device."""
    lincomb = _route("linear_combination", policy,
                     _vo.linear_combination_plain, _vo.linear_combination,
                     _leaves(vecs[0])[0])
    # the kernel reads flat contiguous vectors (the reference ravels)
    rows = [[t.contiguous() for t in _leaves(v)] for v in vecs]
    return _like(vecs[0], [_chained(lincomb, coeffs, list(leaf))
                           for leaf in zip(*rows)])


def linear_sum(a, x, b, y, policy: Optional[ExecPolicy] = None):
    """z = a*x + b*y."""
    return linear_combination((a, b), (x, y), policy)


def axpy(a, x, y, policy: Optional[ExecPolicy] = None):
    """z = a*x + y."""
    return linear_combination((a, 1.0), (x, y), policy)


def scale_add_multi(coeffs, x, ys: Sequence,
                    policy: Optional[ExecPolicy] = None) -> list:
    """Z_k = c_k * x + Y_k for every k, x read once: a list of K
    vectors shaped as x."""
    fn = _route("scale_add_multi", policy, _vo.scale_add_multi_plain,
                _vo.scale_add_multi, _leaves(x)[0])
    rows = [_leaves(y) for y in ys]
    per_leaf = []                       # per leaf a (K, *leaf.shape) tensor
    for pos, xl in enumerate(_leaves(x)):
        want = _result_type(xl, *(row[pos] for row in rows))
        per_leaf.append(fn(coeffs, xl.to(want).contiguous(),
                           [row[pos].to(want).contiguous() for row in rows]))
    return [_like(x, [Z[k] for Z in per_leaf]) for k in range(len(rows))]


def _leafwise_sum(op, policy, plain, wrapper, *vecs) -> torch.Tensor:
    """sum over leaf positions of the reduction of those leaves, each
    cast to the result type of every leaf and flattened."""
    rows = [_leaves(v) for v in vecs]
    fn = _route(op, policy, plain, wrapper, rows[0][0])
    want = _result_type(*(leaf for row in rows for leaf in row))
    return functools.reduce(torch.add, (fn(*(_flat(t, want) for t in leaf))
                                        for leaf in zip(*rows)))


def dot(x, y, policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """<x, y> over all elements, a 0-d tensor on their device."""
    return _leafwise_sum("dot", policy, _vo.dot_plain, _vo.dot, x, y)


def dot_prod_multi(x, ys: Sequence,
                   policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """d_k = <x, Y_k> for every k, x read once: a ``(K,)`` tensor."""
    lx = _leaves(x)
    rows = [_leaves(y) for y in ys]
    fn = _route("dot_prod_multi", policy, _vo.dot_prod_multi_plain,
                _vo.dot_prod_multi, lx[0])
    want = _result_type(*lx, *(leaf for row in rows for leaf in row))
    return functools.reduce(torch.add, (
        fn(_flat(xl, want), [_flat(row[pos], want) for row in rows])
        for pos, xl in enumerate(lx)))


def wrms_ss(x, w, policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """sum((x*w)^2) over all elements (no sqrt, no /N)."""
    return _leafwise_sum("wrms_ss", policy, _vo.wrms_ss_plain, _vo.wrms_ss,
                         x, w)


def wrms_norm(x, w, policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """sqrt(sum((x*w)^2) / N), N the element count of every leaf."""
    return torch.sqrt(wrms_ss(x, w, policy) / _nv.tree_size(x))


def wrms_norm_mask(x, w, mask,
                   policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """sqrt(sum((x*w*m)^2) / N): N counts every entry, masked ones too
    (the reference's ``vector.py:202``)."""
    ss = _leafwise_sum("wrms_norm_mask", policy, _vo.wrms_mask_ss_plain,
                       _vo.wrms_mask_ss, x, w, mask)
    return torch.sqrt(ss / _nv.tree_size(x))


def csr_spmv(data, x, pattern,
             policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """y = A @ x for a CSR matrix: data (nnz,), x (ncols,); pattern a
    :class:`~repro_torch.core.sunmatrix.CSRPattern` (pass the object on
    a hot path: it holds the device arrays) or an ``(indptr, indices)``
    pair, checked and laid out anew each call."""
    pat = pattern if isinstance(pattern, CSRPattern) else \
        CSRPattern(*pattern, x.shape[0])
    if data.shape != (pat.nnz,):
        raise ValueError(f"csr_spmv: data has shape {tuple(data.shape)}, "
                         f"want ({pat.nnz},)")
    if x.shape != (pat.ncols,):
        raise ValueError(f"csr_spmv: x has shape {tuple(x.shape)}, want "
                         f"({pat.ncols},)")
    return _route("csr_spmv", policy, _sx.csr_spmv_plain, _sx.csr_spmv,
                  data)(data, x, *pat.kernel_plan(data.device))


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
