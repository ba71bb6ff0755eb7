"""Analytical cost of each dispatch op under its two implementations.

Counterpart of ``repro.analysis.opcost``.  Every op of
:data:`repro_torch.core.dispatch.OP_TABLE` has a signature extractor
(:data:`SIG_EXTRACTORS`) and a cost model (:data:`COST_MODELS`): the
reference's nineteen ops and the port's own four,
``lagrange_rescale_soa``, ``newton_residual_lsolve_soa``,
``newton_update_soa`` and ``newton_block_inverse_soa``.
:func:`predict` evaluates both implementations of an op at one
signature against a row of :data:`repro_torch.analysis.roofline.DEVICES`
and names the faster; the resolver of ``"auto"`` dispatch
(:mod:`repro_torch.core.autotune`) decides by that winner where no
measurement covers the call, and audits the model against every
measurement it has.

An :class:`OpSig` is the reference's, with **the same** :meth:`OpSig.key`
string, so the port's tuner keys, its dispatch keys and the reference's
agree for the nineteen shared ops.  :func:`signature` reads shapes,
dtypes and lengths only: no device read, no host sync.

:class:`OpCost` has three parts:

* ``flops`` — the op's arithmetic;
* ``hbm_bytes`` — the kernel's single pass: each input read once, each
  output written once (for the nineteen shared ops the reference's
  count, since it is the same work);
* the plain version's own cost: ``plain_launches``, the aten calls that
  launch a kernel (views and allocations launch none), and
  ``plain_bytes``, what those launches read and write.  Eager PyTorch
  fuses nothing, so each launch reads its operands and writes its
  result; the Gauss–Jordan plain loops launch per pivot.  They are
  counted from the port's plain versions (the body that
  :mod:`~repro_torch.core.dispatch` wraps around each included), not
  from the reference's jnp oracle.  ``kernel_launches`` counts the
  kernel side's launches, the body's plain ops included (``wrms_norm``'s
  division and square root run under both).

Where a count depends on more than the signature holds (a vector that
is a tuple of leaves, a sparse pattern's longest row), the model takes
one leaf and the average row (``ceil(nnz / rows)``).

Time model (:func:`predict`), per implementation::

    t = launches * launch_cost + max(flops / peak_flops, bytes / bw)

with the plain version's ``plain_launches``, ``plain_launch`` and
``torch_bw``, and the kernel's ``kernel_launches``, ``kernel_launch``
and ``cuda_bw``.  There is no ``tile_for``: the port's kernels
bounds-check the system axis, so there is no tile to choose.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch

from .roofline import Device, get_device

#: ops whose long axis is the SoA system batch; the others stream over
#: flat elements
BATCHED_OPS = frozenset({
    "block_solve_soa", "block_inverse_soa", "blockdiag_spmv_soa",
    "newton_residual_soa", "masked_update_wrms_soa", "history_rescale_soa",
    "wrms_soa", "bsr_spmv_soa", "bsr_block_jacobi_inverse_soa",
    "lagrange_rescale_soa", "newton_residual_lsolve_soa",
    "newton_update_soa", "newton_block_inverse_soa",
})

REDUCTION_OPS = frozenset({
    "dot", "wrms_norm", "wrms_norm_mask", "dot_prod_multi", "wrms_ss",
})

#: the Gauss-Jordan bodies: b <= UNROLL_MAX_B eliminates the augmented
#: system (``kernels/block_solve.py``)
UNROLL_MAX_B = 8


@dataclasses.dataclass(frozen=True)
class OpSig:
    """Shape signature of one dispatch call: the autotune cache's key
    fields.  Unused fields stay 0 (``b`` for streaming ops, ...)."""

    op: str
    dtype: str          # dtype name without its module ('float64', ...)
    n: int = 0          # flat elements (streaming) / state length (SoA)
    nsys: int = 0       # SoA system batch (0 = not batched)
    b: int = 0          # block size
    k: int = 0          # operand count K / history depth q1
    nnz: int = 0        # sparse nonzeros (CSR) or pattern blocks (BSR)

    @property
    def itemsize(self) -> int:
        return {"float64": 8, "float32": 4, "float16": 2,
                "bfloat16": 2}.get(self.dtype, 8)

    @property
    def axis_len(self) -> int:
        """Length of the long axis (batch for SoA ops, elements else)."""
        return self.nsys if self.op in BATCHED_OPS else self.n

    def key(self) -> str:
        """Stable cache-key string (the reference's)."""
        return (f"{self.op}|{self.dtype}|n={self.n},nsys={self.nsys},"
                f"b={self.b},k={self.k},nnz={self.nnz}")


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float64`` -> ``'float64'`` (the reference's names)."""
    return str(dtype).rpartition(".")[2]


def _leaves(x: Any) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _tree_size(x: Any) -> int:
    return sum(t.numel() for t in _leaves(x))


def _tree_dtype(x: Any) -> str:
    return dtype_name(functools.reduce(
        torch.promote_types, (t.dtype for t in _leaves(x))))


def _sig_pairwise(op: str, args: Tuple) -> OpSig:
    x = args[1]
    return OpSig(op, _tree_dtype(x), n=_tree_size(x), k=2)


def _sig_linear_combination(op: str, args: Tuple) -> OpSig:
    coeffs, vecs = args
    return OpSig(op, _tree_dtype(vecs[0]), n=_tree_size(vecs[0]),
                 k=len(coeffs))


def _sig_scale_add_multi(op: str, args: Tuple) -> OpSig:
    coeffs, x, _ys = args
    return OpSig(op, _tree_dtype(x), n=_tree_size(x), k=len(coeffs))


def _sig_reduction(op: str, args: Tuple) -> OpSig:
    return OpSig(op, _tree_dtype(args[0]), n=_tree_size(args[0]), k=1)


def _sig_dot_prod_multi(op: str, args: Tuple) -> OpSig:
    x, ys = args
    return OpSig(op, _tree_dtype(x), n=_tree_size(x), k=len(ys))


def _sig_block(op: str, args: Tuple) -> OpSig:
    A = args[0]
    b, _, nsys = A.shape
    return OpSig(op, dtype_name(A.dtype), n=b, nsys=nsys, b=b)


def _sig_soa_elementwise(op: str, args: Tuple) -> OpSig:
    z = args[0]
    n, nsys = z.shape
    return OpSig(op, dtype_name(z.dtype), n=n, nsys=nsys)


def _sig_residual_lsolve(op: str, args: Tuple) -> OpSig:
    z = args[0]                      # z, f, psi, gamma, gamrat, Minv...
    b, nsys = z.shape
    return OpSig(op, dtype_name(z.dtype), n=b, nsys=nsys, b=b)


def _sig_history(op: str, args: Tuple) -> OpSig:
    Z = args[-2]                     # (W | eta, q), Z, active
    q1, n, nsys = Z.shape
    return OpSig(op, dtype_name(Z.dtype), n=n, nsys=nsys, k=q1)


def _sig_csr(op: str, args: Tuple) -> OpSig:
    data, x, _pattern = args
    return OpSig(op, dtype_name(data.dtype), n=x.numel(), nnz=data.numel())


def _sig_bsr(op: str, args: Tuple) -> OpSig:
    values, pattern = args[0], args[-1]
    nnzb, b, _, nsys = values.shape
    return OpSig(op, dtype_name(values.dtype), n=int(pattern[2]) * b,
                 nsys=nsys, b=b, nnz=nnzb)


#: per-op signature extractors: their keys name exactly the op table's
#: ops (sunlint's table-coherence rule checks them against OP_TABLE)
SIG_EXTRACTORS = {
    "linear_sum": _sig_pairwise,
    "axpy": _sig_pairwise,
    "linear_combination": _sig_linear_combination,
    "scale_add_multi": _sig_scale_add_multi,
    "dot": _sig_reduction,
    "wrms_norm": _sig_reduction,
    "wrms_ss": _sig_reduction,
    "wrms_norm_mask": _sig_reduction,
    "dot_prod_multi": _sig_dot_prod_multi,
    "block_solve_soa": _sig_block,
    "block_inverse_soa": _sig_block,
    "blockdiag_spmv_soa": _sig_block,
    "newton_residual_soa": _sig_soa_elementwise,
    "masked_update_wrms_soa": _sig_soa_elementwise,
    "wrms_soa": _sig_soa_elementwise,
    "history_rescale_soa": _sig_history,
    "csr_spmv": _sig_csr,
    "bsr_spmv_soa": _sig_bsr,
    "bsr_block_jacobi_inverse_soa": _sig_bsr,
    "lagrange_rescale_soa": _sig_history,
    "newton_residual_lsolve_soa": _sig_residual_lsolve,
    "newton_update_soa": _sig_residual_lsolve,
    "newton_block_inverse_soa": _sig_block,
}


def signature(op: str, args: Tuple) -> OpSig:
    """The :class:`OpSig` of one dispatch call; ``args`` are the op's
    positional arguments as :mod:`~repro_torch.core.dispatch` passes
    them.  Reads shapes, dtypes and lengths only."""
    fn = SIG_EXTRACTORS.get(op)
    if fn is None:
        raise ValueError(f"no signature extractor for dispatch op {op!r}")
    return fn(op, args)


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytical work and traffic of one op at one signature (see the
    module docstring)."""

    flops: float
    hbm_bytes: float        # the kernel's single pass
    plain_bytes: float      # the plain version's launches' traffic
    plain_launches: int     # the plain version's launching aten calls
    kernel_launches: int = 1


# Counts in units of elements; each cost model scales by the item size.

def _lincomb_launches(k: int) -> Tuple[int, int]:
    """(plain, kernel) launches of a K-term combination chained in
    launches of at most 8 terms, the partial sum carried in with
    coefficient 1 (``dispatch._chained``)."""
    plain, kern, first = 2 * min(k, 8) - 1, 1, min(k, 8)
    left = k - first
    while left > 0:
        m = min(left, 7)
        plain += 2 * m + 1
        kern += 1
        left -= m
    return plain, kern


def _cost_lincomb(sig: OpSig) -> OpCost:
    s, n, k = sig.itemsize, sig.n, sig.k
    io = (k + 1) * n * s
    plain, kern = _lincomb_launches(k)
    # k products (read x, write) and k - 1 sums (read two, write)
    return OpCost((2 * k - 1) * n, io, (2 * k + 3 * (k - 1)) * n * s,
                  plain, kern)


def _cost_scale_add_multi(sig: OpSig) -> OpCost:
    s, n, k = sig.itemsize, sig.n, sig.k
    io = (2 * k + 1) * n * s
    # k products, k sums, the stack
    return OpCost(2 * k * n, io, (2 * k + 3 * k + 2 * k) * n * s,
                  2 * k + 1)


def _cost_reduction(sig: OpSig) -> OpCost:
    """``dot`` (a product, a sum) and ``wrms_ss`` (two products, a
    sum); ``wrms_norm`` adds a division and a square root to both
    sides."""
    s, n = sig.itemsize, sig.n
    io = 2 * n * s
    if sig.op == "dot":
        return OpCost(3 * n, io, 4 * n * s, 2)
    tail = 2 if sig.op == "wrms_norm" else 0
    return OpCost(3 * n, io, 6 * n * s, 3 + tail, 1 + tail)


def _cost_reduction_mask(sig: OpSig) -> OpCost:
    s, n = sig.itemsize, sig.n
    io = 3 * n * s
    # x*w, *m, the square, the sum; then the division and square root
    return OpCost(4 * n, io, 9 * n * s, 6, 3)


def _cost_dot_prod_multi(sig: OpSig) -> OpCost:
    s, n, k = sig.itemsize, sig.n, sig.k
    io = (k + 1) * n * s
    # per vector a product and a sum, then the stack; the kernel's entry
    # launches its partial sums and its final pass
    return OpCost(2 * k * n, io, 4 * k * n * s, 2 * k + 1, 2)


def _row_scale_bytes(b: int) -> int:
    """abs, row max, clamp, reciprocal of a (b, b) block: elements."""
    return 2 * b * b + b * b + b + 4 * b


def _cost_block_solve(sig: OpSig) -> OpCost:
    s, nsys, b = sig.itemsize, sig.nsys, sig.b
    width = b + 1
    io = (b * width + b) * nsys * s        # read A,r; write x
    if b <= UNROLL_MAX_B:
        # row scale (5: |A|, the row max, clamp, 1/.), scaled a and x
        # (2); per pivot the pivot's reciprocal (2), the pivot row and
        # entry (2), the two updates (2 each), the two pivot-row stores
        launches = 7 + 10 * b
        per_pivot = 4 * b * b + 12 * b + 8
        prologue = _row_scale_bytes(b) + 2 * b * b + 4 * b
    else:
        # row scale (5), two products and the cat (3); per pivot the
        # reciprocal (2), the pivot row, the factor column (clone, zero),
        # the update (product, in-place difference, its store), the row
        # store
        launches = 8 + 9 * b
        per_pivot = 4 * b * width + 8 * b + 4
        prologue = _row_scale_bytes(b) + 4 * b * width
    plain = (prologue + b * per_pivot) * nsys * s
    return OpCost(2 * b * b * width * nsys, io, plain, launches)


def _inverse_cost(b: int, nsys: int, s: int) -> Tuple[float, int]:
    """(plain bytes, plain launches) of the plain Gauss-Jordan inverse of
    nsys (b, b) blocks."""
    if b <= UNROLL_MAX_B:
        # eye, row scale (5), two scaled products; per pivot the
        # reciprocal (2), two row scalings and their stores, two updates,
        # two pivot-row stores
        launches = 8 + 12 * b
        per_pivot = 8 * b * b + 14 * b + 2
        prologue = _row_scale_bytes(b) + 5 * b * b
    else:
        # row scale (5), the scaled copy, the closing column scaling;
        # per pivot 13 launches, among them the full update
        launches = 7 + 13 * b
        per_pivot = 4 * b * b + 14 * b + 4
        prologue = _row_scale_bytes(b) + 6 * b * b
    return (prologue + b * per_pivot) * nsys * s, launches


def _cost_block_inverse(sig: OpSig) -> OpCost:
    s, nsys, b = sig.itemsize, sig.nsys, sig.b
    io = 2 * b * b * nsys * s
    plain, launches = _inverse_cost(b, nsys, s)
    return OpCost(4 * b ** 3 * nsys, io, plain, launches)


def _cost_newton_block_inverse(sig: OpSig) -> OpCost:
    s, nsys, b = sig.itemsize, sig.nsys, sig.b
    # the kernel reads J and gamma and writes M^-1: 152 bytes a system at
    # b = 3 in float64
    io = (2 * b * b + 1) * nsys * s
    inverse = _cost_block_inverse(sig)
    # the plain blocks: the eye, gamma*J (reads J and gamma, writes) and
    # the difference (reads the product, writes M)
    build = (4 * b * b + 1) * nsys * s
    return OpCost(inverse.flops + 2 * b * b * nsys, io,
                  inverse.plain_bytes + build, inverse.plain_launches + 3)


def _cost_blockdiag_spmv(sig: OpSig) -> OpCost:
    s, nsys, b = sig.itemsize, sig.nsys, sig.b
    io = (b * b + 2 * b) * nsys * s
    # b column products (read a column and x's row, write) and b - 1 sums
    plain = (3 * b * b + 3 * b * (b - 1)) * nsys * s
    return OpCost(2 * b * b * nsys, io, plain, 2 * b - 1)


def _cost_newton_residual(sig: OpSig) -> OpCost:
    s, n, nsys = sig.itemsize, sig.n, sig.nsys
    io = 4 * n * nsys * s
    # gamma*f, z - ., . - psi and the negation (the BDF loop's negate)
    return OpCost(3 * n * nsys, io, 11 * n * nsys * s, 4)


def _cost_residual_lsolve(sig: OpSig) -> OpCost:
    s, nsys, b = sig.itemsize, sig.nsys, sig.b
    # the kernel reads z, f, psi, gamma, gamrat and Minv and writes dz
    io = (b * b + 4 * b + 2) * nsys * s
    res, spmv = _cost_newton_residual(sig), _cost_blockdiag_spmv(sig)
    # the plain correction: 1 + gamrat, its reciprocal, times 2 (each
    # reads and writes nsys), then corr times the SpMV's output
    corr = (6 + 2 * b + 1) * nsys * s
    return OpCost(res.flops + spmv.flops + (b + 3) * nsys, io,
                  res.plain_bytes + spmv.plain_bytes + corr,
                  res.plain_launches + spmv.plain_launches + 4)


def _cost_newton_update(sig: OpSig) -> OpCost:
    s, nsys, b = sig.itemsize, sig.nsys, sig.b
    # the kernel reads z, f, psi, w, gamma, gamrat, Minv and the mask
    # byte and writes z' and dn: 217 bytes a system at b = 3 in float64
    io = (b * b + 5 * b + 3) * nsys * s + nsys
    lsolve, update = _cost_residual_lsolve(sig), _cost_masked_update_wrms(
        OpSig("masked_update_wrms_soa", sig.dtype, n=b, nsys=nsys))
    return OpCost(lsolve.flops + update.flops, io,
                  lsolve.plain_bytes + update.plain_bytes,
                  lsolve.plain_launches + update.plain_launches)


def _cost_masked_update_wrms(sig: OpSig) -> OpCost:
    s, n, nsys = sig.itemsize, sig.n, sig.nsys
    io = (5 * n + 1) * nsys * s
    # z + dz, where, dz*w, the square, the mean, the square root
    return OpCost(6 * n * nsys, io, (13 * n + 3) * nsys * s, 6)


def _cost_history_rescale(sig: OpSig) -> OpCost:
    s, n, nsys, k = sig.itemsize, sig.n, sig.nsys, sig.k
    io = (2 * k * n + k * k) * nsys * s
    # per history column a product over (k, n) and k - 1 sums; the where
    plain = (k * (k + n + k * n) + 3 * k * n * (k - 1) + 3 * k * n) \
        * nsys * s
    return OpCost(2 * k * k * n * nsys, io, plain, 2 * k)


def _cost_lagrange_rescale(sig: OpSig) -> OpCost:
    s, n, nsys, k = sig.itemsize, sig.n, sig.nsys, sig.k
    # the kernel reads eta and Z and writes Z (q, the mask: a few bytes)
    io = (2 * k * n + 1) * nsys * s
    q = k - 1
    form = k * k * 3 * q + k                 # W's entries, at q = k - 1
    # the plain W: 11 launches a factor k over (k, k, nsys) temporaries,
    # 11 more; then the rescale through W
    w_bytes = (k * 10 * k * k + 6 * k * k) * nsys * s
    rescale = _cost_history_rescale(sig)
    return OpCost(form * nsys + 2 * k * k * n * nsys, io,
                  w_bytes + rescale.plain_bytes, 11 * k + 11 + 2 * k)


def _cost_wrms_soa(sig: OpSig) -> OpCost:
    s, n, nsys = sig.itemsize, sig.n, sig.nsys
    io = (2 * n + 1) * nsys * s
    # v*w, the square, the mean, the square root
    return OpCost(3 * n * nsys, io, (6 * n + 3) * nsys * s, 4)


def _cost_csr_spmv(sig: OpSig) -> OpCost:
    s, n, nnz = sig.itemsize, sig.n, sig.nnz
    io = (2 * nnz + 2 * n) * s
    kmax = max(1, -(-nnz // max(n, 1)))
    slots = kmax * n
    # the ELL plan (int64 indices, masks, two scalar zeros; 8-byte
    # indices) each call, the gathers of data and x, then 2*kmax - 1
    # passes over the rows
    plan = (4 * nnz + 8 * n + 30 * slots) * 8
    gather = 6 * slots * s
    passes = (3 * n + 6 * n * (kmax - 1)) * s
    return OpCost(2 * nnz, io, plan + gather + passes, 15 + 2 * kmax)


def _bsr_rows(sig: OpSig) -> Tuple[int, int]:
    """(block rows, entries of the average block row)."""
    nblk = max(1, sig.n // max(sig.b, 1))
    return nblk, max(1, -(-sig.nnz // nblk))


def _cost_bsr_spmv(sig: OpSig) -> OpCost:
    s, nsys, b, nnz = sig.itemsize, sig.nsys, sig.b, sig.nnz
    nblk, per_row = _bsr_rows(sig)
    io = (nnz * b * b + 2 * nblk * b) * nsys * s
    # zeros; per position in a row: the two gathers, 2b - 1 products and
    # sums, the scatter (from the second position on: a gather and a sum
    # before it)
    launches = 1 + (2 * b + 2) + (per_row - 1) * (2 * b + 4)
    plain = (nblk * b + 2 * nnz * (b * b + b)
             + nnz * b * (3 * b + 3 * (b - 1)) + 4 * nnz * b) * nsys * s
    return OpCost(2 * nnz * b * b * nsys, io, plain, launches)


def _cost_bsr_diag_inverse(sig: OpSig) -> OpCost:
    s, nsys, b, nnz = sig.itemsize, sig.nsys, sig.b, sig.nnz
    nblk, _ = _bsr_rows(sig)
    io = (nnz + nblk) * b * b * nsys * s
    # both sides gather the diagonal blocks and lay them out (2 launches)
    layout = 4 * nblk * b * b * nsys * s
    plain, launches = _inverse_cost(b, nblk * nsys, s)
    return OpCost(4 * b ** 3 * nblk * nsys, io, plain + layout,
                  launches + 2, 3)


#: per-op cost models: their keys name exactly the op table's ops
#: (sunlint's table-coherence rule checks them against OP_TABLE)
COST_MODELS = {
    "linear_sum": _cost_lincomb,
    "axpy": _cost_lincomb,
    "linear_combination": _cost_lincomb,
    "scale_add_multi": _cost_scale_add_multi,
    "dot": _cost_reduction,
    "wrms_norm": _cost_reduction,
    "wrms_ss": _cost_reduction,
    "wrms_norm_mask": _cost_reduction_mask,
    "dot_prod_multi": _cost_dot_prod_multi,
    "block_solve_soa": _cost_block_solve,
    "block_inverse_soa": _cost_block_inverse,
    "blockdiag_spmv_soa": _cost_blockdiag_spmv,
    "newton_residual_soa": _cost_newton_residual,
    "masked_update_wrms_soa": _cost_masked_update_wrms,
    "history_rescale_soa": _cost_history_rescale,
    "wrms_soa": _cost_wrms_soa,
    "csr_spmv": _cost_csr_spmv,
    "bsr_spmv_soa": _cost_bsr_spmv,
    "bsr_block_jacobi_inverse_soa": _cost_bsr_diag_inverse,
    "lagrange_rescale_soa": _cost_lagrange_rescale,
    "newton_residual_lsolve_soa": _cost_residual_lsolve,
    "newton_update_soa": _cost_newton_update,
    "newton_block_inverse_soa": _cost_newton_block_inverse,
}


def op_cost(sig: OpSig) -> OpCost:
    """The op's analytical model at ``sig`` (see the module docstring)."""
    fn = COST_MODELS.get(sig.op)
    if fn is None:
        raise ValueError(f"no cost model for dispatch op {sig.op!r}")
    return fn(sig)


@dataclasses.dataclass(frozen=True)
class Prediction:
    """The model's times of both implementations at one signature."""

    sig: OpSig
    device: str
    t_torch: float
    t_cuda: float

    @property
    def winner(self) -> str:
        return "torch" if self.t_torch <= self.t_cuda else "cuda"

    @property
    def ratio(self) -> float:
        """Predicted torch/cuda time ratio (> 1: the kernel wins)."""
        return self.t_torch / max(self.t_cuda, 1e-12)


def predict(sig: OpSig, device) -> Prediction:
    """Both implementations' modelled times for ``sig`` on ``device`` (a
    :class:`~repro_torch.analysis.roofline.Device` or its row's name)."""
    dev = device if isinstance(device, Device) else get_device(device)
    cost = op_cost(sig)
    t_ops = cost.flops / dev.peak_flops
    t_torch = cost.plain_launches * dev.plain_launch + \
        max(t_ops, cost.plain_bytes / dev.bw("torch"))
    t_cuda = cost.kernel_launches * dev.kernel_launch + \
        max(t_ops, cost.hbm_bytes / dev.bw("cuda"))
    return Prediction(sig=sig, device=dev.name, t_torch=t_torch,
                      t_cuda=t_cuda)
