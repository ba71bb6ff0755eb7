"""Policy-routed ops of the port, through one op table.

Counterpart of ``repro.core.dispatch`` (``dispatch.py:393-743``).
:data:`OP_TABLE` holds the reference's nineteen ops, with the same
names and argument order: the seven ``*_soa`` ops of the ensemble BDF
path, the N_Vector ops ``linear_sum``, ``axpy``,
``linear_combination``, ``scale_add_multi``, ``dot``,
``dot_prod_multi``, ``wrms_norm``, ``wrms_ss`` and ``wrms_norm_mask``,
and the sparse ops ``csr_spmv`` (``SparseCSR.matvec``),
``bsr_spmv_soa`` and ``bsr_block_jacobi_inverse_soa``.  Four ops are
the port's own, not among the nineteen, each a fusion that the
reference's jitted step leaves to XLA and eager PyTorch would spend
many launches on: ``lagrange_rescale_soa``, the ensemble BDF's history
rebuild with its Lagrange matrix formed inside the kernel (some 60
launches plain); ``newton_residual_lsolve_soa``, a Newton iteration's
residual, saved-inverse lsolve and gamma-drift correction in one launch
(six composed); ``newton_update_soa``, that and the masked update with
its correction norm, the whole Newton iteration in one launch where the
two above took two, which ``BlockDiagGJ`` takes at b <= 8
(:meth:`~repro_torch.core.linsol.BlockDiagGJ.soa_newton_update`); and
``newton_block_inverse_soa``, its lsetup at b <= 8 with the Newton
blocks ``I - gamma*J`` formed inside the inverse
(:meth:`~repro_torch.core.linsol.BlockDiagGJ.soa_setup`).

Each entry is ``{"torch": plain version, "cuda": kernel wrapper}``, two
callables with one positional signature (:func:`validate_op_table`
checks that at import).  The reference's implementations also take a
keyword ``policy``, because its Pallas wrappers read the interpret flag
and their tiling from it; the port's kernel wrappers read nothing from
a policy (the device is the tensor's), so its implementations take no
``policy`` and the validator does not ask for one.  :func:`dispatch`
resolves an op under an :class:`~repro_torch.core.policies.ExecPolicy`
by ``policy.backend_for(op)``, so a pin in ``op_overrides`` takes
effect at every call site: ``"torch"`` runs the plain version,
``"cuda"`` the kernel wrapper after checking that the op's first tensor
lies on the card, and ``"auto"`` the kernel wrapper too (which takes
its plain version for CPU tensors), after recording the call's
decision: it keys the call by the few arguments its signature depends
on (:data:`_CALL_KEYS`: a tensor's shape, dtype and device index, a
list's length), counts one hit on the decision memoized under that key,
and on a miss builds the op's signature and asks
:mod:`repro_torch.core.autotune` (the card's measured cache, else the
cost model; source ``"cpu"`` for a CPU tensor).  The decision is
reported (``Context.dispatch_report()``), not followed: the plain
version runs on the card only where ``op_overrides`` pins it.  The
callables of each op are built once, at import, so :func:`dispatch` is
two dictionary reads; each looks its kernel wrapper or plain version up
in its kernel module at each call.  ``linear_sum`` and
``axpy`` go through the linear-combination kernel with K = 2, as in the
reference (``dispatch.py:107-112``), and their ``"torch"`` backend
through its plain version, which sums ``c_0 x_0 + c_1 x_1`` in that
order as the reference's ``a*x + b*y`` and ``a*x + y`` do (``1*y`` is
exact).

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
reference's order and its rounding.  A ``DTensor`` runs only under
``"torch"``: the kernel wrappers refuse one.

``python -m repro_torch.core.dispatch`` prints the table that
:mod:`repro_torch.core.policies`' docstring embeds.
"""
from __future__ import annotations

import functools
import inspect
from typing import Optional, Sequence

import torch

from ..kernels import block_solve as _bs
from ..kernels import blockdiag_spmv as _sp
from ..kernels import newton as _nw
from ..kernels import sparse as _sx
from ..kernels import vecops as _vo
from . import autotune as _at
from . import vector as _nv
from .policies import DEFAULT, ExecPolicy
from .sunmatrix import CSRPattern

_leaves = _nv.leaves
_BACKENDS = ("torch", "cuda")


# ---------------------------------------------------------------------------
# The ops' bodies: ``body(fn, *args)`` with ``fn`` the plain version or
# the kernel wrapper of the op's kernel module.
# ---------------------------------------------------------------------------


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


def _linear_combination(lincomb, coeffs, vecs: Sequence):
    # the kernel reads flat contiguous vectors (the reference ravels)
    rows = [[t.contiguous() for t in _leaves(v)] for v in vecs]
    return _like(vecs[0], [_chained(lincomb, coeffs, list(leaf))
                           for leaf in zip(*rows)])


def _linear_sum(lincomb, a, x, b, y):
    return _linear_combination(lincomb, (a, b), (x, y))


def _axpy(lincomb, a, x, y):
    return _linear_combination(lincomb, (a, 1.0), (x, y))


def _scale_add_multi(fn, coeffs, x, ys: Sequence) -> list:
    rows = [_leaves(y) for y in ys]
    per_leaf = []                       # per leaf a (K, *leaf.shape) tensor
    for pos, xl in enumerate(_leaves(x)):
        want = _result_type(xl, *(row[pos] for row in rows))
        per_leaf.append(fn(coeffs, xl.to(want).contiguous(),
                           [row[pos].to(want).contiguous() for row in rows]))
    return [_like(x, [Z[k] for Z in per_leaf]) for k in range(len(rows))]


def _leafwise_sum(fn, *vecs) -> torch.Tensor:
    """sum over leaf positions of the reduction of those leaves, each
    cast to the result type of every leaf and flattened."""
    rows = [_leaves(v) for v in vecs]
    want = _result_type(*(leaf for row in rows for leaf in row))
    return functools.reduce(torch.add, (fn(*(_flat(t, want) for t in leaf))
                                        for leaf in zip(*rows)))


def _pair_sum(fn, x, y):
    """``dot`` and ``wrms_ss``: :func:`_leafwise_sum` of two vectors,
    with the reference's two positional arguments (which
    :func:`validate_op_table`'s arity check reads)."""
    return _leafwise_sum(fn, x, y)


def _dot_prod_multi(fn, x, ys: Sequence):
    lx = _leaves(x)
    rows = [_leaves(y) for y in ys]
    want = _result_type(*lx, *(leaf for row in rows for leaf in row))
    return functools.reduce(torch.add, (
        fn(_flat(xl, want), [_flat(row[pos], want) for row in rows])
        for pos, xl in enumerate(lx)))


def _wrms_norm(fn, x, w):
    return torch.sqrt(_leafwise_sum(fn, x, w) / _nv.tree_size(x))


def _wrms_norm_mask(fn, x, w, mask):
    return torch.sqrt(_leafwise_sum(fn, x, w, mask) / _nv.tree_size(x))


def _newton_residual(fn, z, fval, psi, gamma, negate=False):
    return fn(z, fval, psi, gamma, negate=negate)


def _csr_spmv(fn, data, x, pattern):
    pat = pattern if isinstance(pattern, CSRPattern) else \
        CSRPattern(*pattern, x.shape[0])
    if data.shape != (pat.nnz,):
        raise ValueError(f"csr_spmv: data has shape {tuple(data.shape)}, "
                         f"want ({pat.nnz},)")
    if x.shape != (pat.ncols,):
        raise ValueError(f"csr_spmv: x has shape {tuple(x.shape)}, want "
                         f"({pat.ncols},)")
    return fn(data, x, *pat.kernel_plan(data.device))


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


def _bsr_block_jacobi_inverse_soa(inverse, values, pattern):
    b, nb = values.shape[1], values.shape[3]
    D = values[_diag_blocks(pattern, values.device)]   # (nblk, b, b, NB)
    D = D.permute(1, 2, 0, 3).reshape(b, b, pattern[2] * nb)
    return inverse(D)


# ---------------------------------------------------------------------------
# The op table.
# ---------------------------------------------------------------------------

def _impl(body, module, name: str):
    """One backend's implementation: ``body(module.<name>, *args)``, or
    ``module.<name>(*args)`` itself where ``body`` is None, the
    attribute looked up at each call.  ``inspect`` shows what it
    forwards to: the body's signature without ``fn``, or the kernel
    wrapper's."""
    if body is None:
        def impl(*args, **kw):
            return getattr(module, name)(*args, **kw)
        params = list(inspect.signature(getattr(module, name))
                      .parameters.values())
    else:
        def impl(*args, **kw):
            return body(getattr(module, name), *args, **kw)
        params = list(inspect.signature(body).parameters.values())[1:]
    impl.__signature__ = inspect.Signature(params)
    impl.__name__ = impl.__qualname__ = name
    return impl


def _op(module, kernel: str, body=None) -> dict:
    """``{"torch": ..., "cuda": ...}`` of an op whose kernel wrapper is
    ``module.<kernel>`` and whose plain version is
    ``module.<kernel>_plain``."""
    return {"torch": _impl(body, module, kernel + "_plain"),
            "cuda": _impl(body, module, kernel)}


OP_TABLE = {
    # streaming
    "linear_sum": _op(_vo, "linear_combination", _linear_sum),
    "linear_combination": _op(_vo, "linear_combination",
                              _linear_combination),
    "scale_add_multi": _op(_vo, "scale_add_multi", _scale_add_multi),
    "axpy": _op(_vo, "linear_combination", _axpy),
    # reductions
    "dot": _op(_vo, "dot", _pair_sum),
    "wrms_norm": _op(_vo, "wrms_ss", _wrms_norm),
    "wrms_norm_mask": _op(_vo, "wrms_mask_ss", _wrms_norm_mask),
    "dot_prod_multi": _op(_vo, "dot_prod_multi", _dot_prod_multi),
    "wrms_ss": _op(_vo, "wrms_ss", _pair_sum),
    # batched block-diagonal (ensemble) linear algebra, SoA layout
    "block_solve_soa": _op(_bs, "block_solve_soa"),
    "block_inverse_soa": _op(_bs, "block_inverse_soa"),
    "blockdiag_spmv_soa": _op(_sp, "blockdiag_spmv_soa"),
    # fused ensemble-Newton hot-loop ops (SoA, nsys last)
    "newton_residual_soa": _op(_nw, "newton_residual", _newton_residual),
    "masked_update_wrms_soa": _op(_nw, "masked_update_wrms"),
    "history_rescale_soa": _op(_nw, "history_rescale"),
    "wrms_soa": _op(_nw, "wrms_soa"),
    # sparse matrices (static shared patterns)
    "csr_spmv": _op(_sx, "csr_spmv", _csr_spmv),
    "bsr_spmv_soa": _op(_sx, "bsr_spmv_soa"),
    "bsr_block_jacobi_inverse_soa": _op(_bs, "block_inverse_soa",
                                        _bsr_block_jacobi_inverse_soa),
    # the port's own: the BDF history rebuild with W formed in the
    # kernel, the BlockDiagGJ Newton iteration's lsolve and the whole
    # iteration in one launch, and its lsetup with M formed in the kernel
    "lagrange_rescale_soa": _op(_nw, "lagrange_rescale"),
    "newton_residual_lsolve_soa": _op(_nw, "newton_residual_lsolve"),
    "newton_update_soa": _op(_nw, "newton_update"),
    "newton_block_inverse_soa": _op(_bs, "newton_block_inverse_soa"),
}


def op_names() -> frozenset:
    """The dispatch op set, which :class:`~repro_torch.core.policies.
    ExecPolicy` checks its ``op_overrides`` against."""
    return frozenset(OP_TABLE)


def _positional_arity(fn):
    """Number of positional parameters (None for a variadic callable)."""
    n = 0
    for p in inspect.signature(fn).parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind is p.VAR_POSITIONAL:
            return None
    return n


def validate_op_table(table=None):
    """Fail fast on a half-registered op.

    Checks every entry of ``table`` (default :data:`OP_TABLE`) for a
    callable ``"torch"`` plain version AND a callable ``"cuda"`` kernel
    wrapper, no stray backend keys, and equal positional arities of the
    two.  Every offender is reported in ONE aggregated ``ValueError``."""
    table = OP_TABLE if table is None else table
    problems = []
    for op in sorted(table):
        impls = table[op]
        if not isinstance(impls, dict):
            problems.append(f"{op}: entry is {type(impls).__name__}, "
                            f"expected a {{'torch', 'cuda'}} dict")
            continue
        stray = sorted(set(impls) - set(_BACKENDS))
        if stray:
            problems.append(f"{op}: unknown backend keys {stray}")
        for backend in _BACKENDS:
            fn = impls.get(backend)
            if fn is None:
                problems.append(f"{op}: missing {backend!r} implementation")
            elif not callable(fn):
                problems.append(f"{op}: {backend!r} implementation is not "
                                f"callable")
        plain, kernel = impls.get("torch"), impls.get("cuda")
        if callable(plain) and callable(kernel):
            a_p, a_k = _positional_arity(plain), _positional_arity(kernel)
            if a_p is not None and a_k is not None and a_p != a_k:
                problems.append(f"{op}: arity mismatch — the plain version "
                                f"takes {a_p} positional args, the kernel "
                                f"wrapper {a_k}")
    if problems:
        raise ValueError(
            "OP_TABLE validation failed (%d problem%s):\n  - %s"
            % (len(problems), "" if len(problems) == 1 else "s",
               "\n  - ".join(problems)))


validate_op_table()


def _first_tensor(args):
    for a in args:
        if torch.is_tensor(a):
            return a
        if isinstance(a, (tuple, list)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


def _on_card(op: str, fn):
    """``fn`` after checking that the first tensor of its arguments lies
    on the card (the ``"cuda"`` backend)."""
    def impl(*args, **kw):
        lead = _first_tensor(args)
        if lead is not None and not lead.is_cuda:
            raise ValueError(f"{op}: backend 'cuda' needs CUDA tensors, got "
                             f"one on {lead.device}")
        return fn(*args, **kw)
    return impl


def _vkey(x):
    """A vector's part of a call key: a tensor's shape, dtype and device
    index (-1 off the card), a tuple's of its leaves."""
    if isinstance(x, torch.Tensor):
        return x.shape, x.dtype, x.get_device()
    return tuple(map(_vkey, x))


def _key_first(a):
    return _vkey(a[0])


#: per op, the key of a call: the arguments its signature
#: (``opcost.SIG_EXTRACTORS``) reads, and nothing else, so a key is a
#: few attribute reads (the main path makes ~2190 calls a solve); an op
#: not named below keys on its first argument
_CALL_KEYS = dict.fromkeys(OP_TABLE, _key_first)
_CALL_KEYS.update({
    "linear_sum": lambda a: _vkey(a[1]),
    "axpy": lambda a: _vkey(a[1]),
    "linear_combination": lambda a: (len(a[0]), _vkey(a[1][0])),
    "scale_add_multi": lambda a: (len(a[0]), _vkey(a[1])),
    "dot_prod_multi": lambda a: (len(a[1]), _vkey(a[0])),
    "csr_spmv": lambda a: (_vkey(a[0]), _vkey(a[1])),
    "bsr_spmv_soa": lambda a: (_vkey(a[0]), a[-1][2]),
    "bsr_block_jacobi_inverse_soa": lambda a: (_vkey(a[0]), a[-1][2]),
    "history_rescale_soa": lambda a: _vkey(a[-2]),
    "lagrange_rescale_soa": lambda a: _vkey(a[-2]),
})


#: set by ``analysis.stepcost.StepCost`` while it counts a step:
#: ``ROW_RECORDER(op, kernel, args, kw)`` makes each ``"auto"`` call
#: (it runs the kernel wrapper, and counts the call under the kernel's
#: row when its tensors are abstract); no decision is recorded then
ROW_RECORDER = None


def _auto(op: str):
    """The ``"auto"`` callable of ``op``: the kernel wrapper, after one
    hit on the decision memoized under the call's key (resolved by the
    autotuner on a miss)."""
    kernel, key_of, memo = OP_TABLE[op]["cuda"], _CALL_KEYS[op], \
        _at.memo_for(op)

    def impl(*args, **kw):
        if ROW_RECORDER is not None:
            return ROW_RECORDER(op, kernel, args, kw)
        key = key_of(args)
        dec = memo.get(key)
        if dec is None:
            memo[key] = _at.resolve_call(op, _first_tensor(args), args)
        else:
            dec.hits += 1
        return kernel(*args, **kw)

    impl.__name__ = impl.__qualname__ = f"auto_{op}"
    return impl


#: per op, the callable of each ExecPolicy backend
_RESOLVED = {op: {"torch": impls["torch"], "auto": _auto(op),
                  "cuda": _on_card(op, impls["cuda"])}
             for op, impls in OP_TABLE.items()}


def dispatch(op: str, policy: Optional[ExecPolicy] = None):
    """Resolve ``op`` to the implementation ``policy`` selects (None
    means the default ``ExecPolicy()``): ``policy.backend_for(op)``, so a
    per-op pin wins over the policy-wide backend.  Unknown ops and
    backends raise ``ValueError``."""
    by_backend = _RESOLVED.get(op)
    if by_backend is None:
        raise ValueError(f"unknown dispatch op {op!r}; valid OP_TABLE "
                         f"ops: {', '.join(sorted(OP_TABLE))}")
    policy = DEFAULT if policy is None else policy
    backend = policy.backend_for(op)
    fn = by_backend.get(backend)
    if fn is None:
        raise ValueError(f"unknown ExecPolicy backend: {backend!r}")
    return fn


# ---------------------------------------------------------------------------
# Documentation rendering: the op-table matrix in the policies module's
# docstring is generated FROM this table (one row per OP_TABLE key); a
# test asserts the rendered text is embedded verbatim.
# ---------------------------------------------------------------------------

#: short descriptions of each op's plain version and kernel; the
#: renderer iterates OP_TABLE keys, so an op missing here still gets a row
OP_NOTES = {
    "linear_sum": ("vecops lincomb plain (K=2)",
                   "row 12 lincomb_kernel (K=2)"),
    "linear_combination": ("vecops lincomb plain", "row 12 lincomb_kernel"),
    "scale_add_multi": ("vecops scale_add_multi plain",
                        "row 13 scale_add_multi_kernel"),
    "axpy": ("vecops lincomb plain (K=2)", "row 12 lincomb_kernel (K=2)"),
    "dot": ("(x*y).sum()", "row 16 onepass_reduce (dot)"),
    "wrms_norm": ("sqrt(sum((x*w)^2)/N)", "row 14 onepass_reduce (wrms)"),
    "wrms_norm_mask": ("sqrt(sum((x*w*m)^2)/N)",
                       "row 15 onepass_reduce (mask)"),
    "dot_prod_multi": ("stacked (x*y_k).sum()", "row 17 multi_dot + final"),
    "wrms_ss": ("sum((x*w)^2)", "row 14 onepass_reduce (wrms)"),
    "block_solve_soa": ("Gauss-Jordan, kernel order", "rows 8, 9 gj_solve_*"),
    "block_inverse_soa": ("Gauss-Jordan inverse", "rows 6, 7 gj_inverse_*"),
    "blockdiag_spmv_soa": ("per-block products, in order",
                           "row 2 spmv_*_kernel"),
    "newton_residual_soa": ("z - gamma*f - psi",
                            "row 1 newton_residual_kernel"),
    "masked_update_wrms_soa": ("where + per-system WRMS",
                               "row 3 masked_update_wrms_kernel"),
    "history_rescale_soa": ("masked W Z products",
                            "row 4 history_rescale_kernel"),
    "wrms_soa": ("per-system WRMS", "row 5 wrms_soa_kernel"),
    "csr_spmv": ("ELL gather + row sums", "row 11 csr_spmv_kernel"),
    "bsr_spmv_soa": ("block products by position",
                     "row 10 bsr_spmv_kernel"),
    "bsr_block_jacobi_inverse_soa": ("diag gather + plain inverse",
                                     "diag gather + rows 6, 7"),
    "lagrange_rescale_soa": ("lagrange_matrix_soa + row 4",
                             "row 4f (W formed from eta, q)"),
    "newton_residual_lsolve_soa": ("rows 1, 2 plain + 2/(1+gr)",
                                   "row 1+2f (one launch, b <= 8)"),
    "newton_update_soa": ("rows 1, 2, 3 plain + 2/(1+gr)",
                          "row 1+2+3f (one launch, b <= 8)"),
    "newton_block_inverse_soa": ("I - gamma*J + row 6 plain",
                                 "row 6f (M formed, b <= 8)"),
}


def op_table_rows():
    """(op, plain description, kernel description) per OP_TABLE entry."""
    return [(op,) + OP_NOTES.get(op, ("plain version", "kernel wrapper"))
            for op in OP_TABLE]


def render_op_table(fmt: str = "rst") -> str:
    """Render the backend matrix from :data:`OP_TABLE` ('rst' for the
    policies module's docstring, 'md' for markdown)."""
    rows = op_table_rows()
    heads = ("op", "'torch' backend", "'cuda' backend")
    widths = [max(len(r[i]) for r in rows + [heads]) for i in range(3)]
    if fmt == "md":
        lines = ["| " + " | ".join(h.ljust(w)
                                   for h, w in zip(heads, widths)) + " |",
                 "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
        lines += ["| " + " | ".join(c.ljust(w)
                                    for c, w in zip(r, widths)) + " |"
                  for r in rows]
        return "\n".join(lines)
    rule = "  ".join("=" * w for w in widths)
    lines = [rule, "  ".join(h.ljust(w)
                             for h, w in zip(heads, widths)).rstrip(), rule]
    lines += ["  ".join(c.ljust(w)
                        for c, w in zip(r, widths)).rstrip() for r in rows]
    lines.append(rule)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Public ops — what the integrators call.
# ---------------------------------------------------------------------------


def block_solve_soa(A, r, policy: Optional[ExecPolicy] = None):
    """Solve every block system: A (b,b,NB), r (b,NB) -> x (b,NB)."""
    return dispatch("block_solve_soa", policy)(A, r)


def block_inverse_soa(A, policy: Optional[ExecPolicy] = None):
    """Invert every block: A (b,b,NB) -> A^{-1} (b,b,NB) (lsetup)."""
    return dispatch("block_inverse_soa", policy)(A)


def blockdiag_spmv_soa(A, x, policy: Optional[ExecPolicy] = None):
    """y = blockdiag(A) @ x: A (b,b,NB), x (b,NB) -> (b,NB) (lsolve)."""
    return dispatch("blockdiag_spmv_soa", policy)(A, x)


def newton_residual_soa(z, fval, psi, gamma,
                        policy: Optional[ExecPolicy] = None, *,
                        negate: bool = False):
    """g = z - gamma*f - psi; z/f/psi (n, nsys), gamma (nsys,);
    ``negate=True`` emits -g (the Newton rhs)."""
    return dispatch("newton_residual_soa", policy)(z, fval, psi, gamma,
                                                   negate=negate)


def masked_update_wrms_soa(z, dz, w, mask,
                           policy: Optional[ExecPolicy] = None):
    """-> (where(mask, z+dz, z), per-system WRMS of dz)."""
    return dispatch("masked_update_wrms_soa", policy)(z, dz, w, mask)


def history_rescale_soa(W, Z, active, policy: Optional[ExecPolicy] = None):
    """where(active, sum_i W[j,i]*Z[i], Z[j]); W (q1,q1,nsys),
    Z (q1,n,nsys)."""
    return dispatch("history_rescale_soa", policy)(W, Z, active)


def lagrange_rescale_soa(eta, q, Z, active,
                         policy: Optional[ExecPolicy] = None):
    """``history_rescale_soa(lagrange_matrix_soa(eta, q), Z, active)``:
    eta (nsys,), q (nsys,) int32, Z (6, n, nsys); the kernel forms W
    from (eta, q) and never stores it."""
    return dispatch("lagrange_rescale_soa", policy)(eta, q, Z, active)


def newton_residual_lsolve_soa(z, fval, psi, gamma, gamrat, Minv,
                               policy: Optional[ExecPolicy] = None):
    """``dz = 2/(1+gamrat) * (Minv @ -(z - gamma*f - psi))`` per system:
    ``newton_residual_soa(..., negate=True)``, ``blockdiag_spmv_soa``
    with the saved inverse Minv (b, b, nsys) and CVODE's correction, in
    one launch at b <= 8; z/f/psi (b, nsys), gamma/gamrat (nsys,)."""
    return dispatch("newton_residual_lsolve_soa", policy)(
        z, fval, psi, gamma, gamrat, Minv)


def newton_update_soa(z, fval, psi, gamma, gamrat, Minv, w, mask,
                      policy: Optional[ExecPolicy] = None):
    """One Newton iteration in one launch at b <= 8 -> ``(z_new, dn)``:
    ``masked_update_wrms_soa(z, newton_residual_lsolve_soa(z, fval, psi,
    gamma, gamrat, Minv), w, mask)``; z/f/psi/w (b, nsys), gamma/gamrat
    (nsys,), Minv (b, b, nsys), mask (nsys,)."""
    return dispatch("newton_update_soa", policy)(
        z, fval, psi, gamma, gamrat, Minv, w, mask)


def newton_block_inverse_soa(J, gamma, policy: Optional[ExecPolicy] = None):
    """``(I - gamma*J)^-1`` per block, the Newton blocks formed inside
    the b <= 8 inverse: J (b, b, nsys), gamma (nsys,)."""
    return dispatch("newton_block_inverse_soa", policy)(J, gamma)


def wrms_soa(v, w, policy: Optional[ExecPolicy] = None):
    """Per-system WRMS over the state axis: v/w (n, nsys) -> (nsys,)."""
    return dispatch("wrms_soa", policy)(v, w)


def linear_combination(coeffs, vecs: Sequence,
                       policy: Optional[ExecPolicy] = None):
    """z = sum_k c_k * X_k in one pass per leaf; the coefficients are
    numbers or 0-d tensors (or one ``(K,)`` tensor) on the vectors'
    device."""
    return dispatch("linear_combination", policy)(coeffs, vecs)


def linear_sum(a, x, b, y, policy: Optional[ExecPolicy] = None):
    """z = a*x + b*y."""
    return dispatch("linear_sum", policy)(a, x, b, y)


def axpy(a, x, y, policy: Optional[ExecPolicy] = None):
    """z = a*x + y."""
    return dispatch("axpy", policy)(a, x, y)


def scale_add_multi(coeffs, x, ys: Sequence,
                    policy: Optional[ExecPolicy] = None) -> list:
    """Z_k = c_k * x + Y_k for every k, x read once: a list of K
    vectors shaped as x."""
    return dispatch("scale_add_multi", policy)(coeffs, x, ys)


def dot(x, y, policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """<x, y> over all elements, a 0-d tensor on their device."""
    return dispatch("dot", policy)(x, y)


def dot_prod_multi(x, ys: Sequence,
                   policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """d_k = <x, Y_k> for every k, x read once: a ``(K,)`` tensor."""
    return dispatch("dot_prod_multi", policy)(x, ys)


def wrms_ss(x, w, policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """sum((x*w)^2) over all elements (no sqrt, no /N)."""
    return dispatch("wrms_ss", policy)(x, w)


def wrms_norm(x, w, policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """sqrt(sum((x*w)^2) / N), N the element count of every leaf."""
    return dispatch("wrms_norm", policy)(x, w)


def wrms_norm_mask(x, w, mask,
                   policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """sqrt(sum((x*w*m)^2) / N): N counts every entry, masked ones too
    (the reference's ``vector.py:202``)."""
    return dispatch("wrms_norm_mask", policy)(x, w, mask)


def csr_spmv(data, x, pattern,
             policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """y = A @ x for a CSR matrix: data (nnz,), x (ncols,); pattern a
    :class:`~repro_torch.core.sunmatrix.CSRPattern` (pass the object on
    a hot path: it holds the device arrays) or an ``(indptr, indices)``
    pair, checked and laid out anew each call."""
    return dispatch("csr_spmv", policy)(data, x, pattern)


def bsr_spmv_soa(values, x, pattern,
                 policy: Optional[ExecPolicy] = None) -> torch.Tensor:
    """Ensemble shared-pattern BSR SpMV: values (nnzb,b,b,NB),
    x (nblk,b,NB), pattern = (brows, bcols, nblk) -> y (nblk,b,NB)."""
    return dispatch("bsr_spmv_soa", policy)(values, x, pattern)


def bsr_block_jacobi_inverse_soa(values, pattern,
                                 policy: Optional[ExecPolicy] = None
                                 ) -> torch.Tensor:
    """Invert every diagonal block of the shared pattern (the
    block-Jacobi psetup): values (nnzb,b,b,NB) -> (b,b,nblk*NB), block I
    of system s at I*NB + s.  A gather of the diagonal blocks, then the
    block inverse over the flattened nblk*NB batch
    (``repro/kernels/ops.py:416-439``)."""
    return dispatch("bsr_block_jacobi_inverse_soa", policy)(values, pattern)


if __name__ == "__main__":
    print(render_op_table())
