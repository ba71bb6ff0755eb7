"""N_Vector kernels over flat vectors (counterpart of
``repro/kernels/vecops.py``), each with its plain PyTorch version:

* :func:`linear_combination` — ``z = sum_k c_k x_k`` in one pass (the
  dispatch ops ``linear_sum``, ``axpy`` and ``linear_combination``);
* :func:`dot` — ``<x, y>``, a deterministic one-launch reduction that
  returns a 0-d tensor on the vectors' device;
* :func:`wrms_ss` — ``sum((x*w)^2)`` and :func:`wrms_mask_ss` —
  ``sum((x*w*m)^2)``, the weighted norms' sums, reduced as the dot is
  (the dispatch ops ``wrms_norm``, ``wrms_ss``, ``wrms_norm_mask``);
* :func:`scale_add_multi` — ``Z_k = c_k*x + Y_k`` for K vectors, x read
  once, returned as one ``(K, *x.shape)`` tensor;
* :func:`dot_prod_multi` — ``d_k = <x, Y_k>`` for K vectors, x read
  once, a ``(K,)`` tensor.

The CUDA kernels are ``csrc/vecops.cu``.  The vectors may have any
shape; they are read as flat contiguous arrays.  The coefficients stay
on the device: a ``(K,)`` tensor, or a sequence whose items are 0-d
tensors or Python numbers (a number becomes a cached device constant),
so a coefficient computed on the card is never read by the host.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_FLOATS = tuple(_build.SUFFIX)
#: terms the linear combination takes (``LINCOMB_MAX_K`` in
#: csrc/vecops.cu); the Krylov solvers use at most 3
LINCOMB_MAX_K = 8
#: vectors the multi-vector ops take (``MULTI_MAX_K`` in csrc/vecops.cu);
#: more raise, as the linear combination's do
MULTI_MAX_K = 8
#: the multi-dot's partial sums per output, at most (``DOT_MAX_BLOCKS``
#: in csrc/vecops.cu)
DOT_MAX_BLOCKS = 1024
#: blocks of a one-launch reduction (dot, the weighted sums of squares),
#: at most (``RED_MAX_BLOCKS`` in csrc/vecops.cu): two a SM on the
#: H100's 132, a constant, so the partition and the bits repeat on any
#: card
RED_MAX_BLOCKS = 264
#: a block's least share of a reduction, in bytes of one input: shorter
#: vectors take fewer blocks, down to one
RED_MIN_CHUNK_BYTES = 16384


@functools.lru_cache(maxsize=256)
def _constant(hexval: str, dtype, device) -> torch.Tensor:
    return torch.full((), float.fromhex(hexval), dtype=dtype, device=device)


def coefficients(coeffs, like: torch.Tensor) -> list:
    """The K coefficients as 0-d tensors of ``like``'s dtype on its
    device: views of a ``(K,)`` tensor, given 0-d tensors (cast if
    their dtype differs), or cached constants for Python numbers."""
    if torch.is_tensor(coeffs):
        coeffs = coeffs.to(like.dtype)
        return [coeffs[k] for k in range(coeffs.shape[0])]
    out = []
    for c in coeffs:
        if torch.is_tensor(c):
            out.append(c.reshape(()).to(like.dtype))
        else:
            out.append(_constant(float(c).hex(), like.dtype, like.device))
    return out


def linear_combination_plain(coeffs, xs):
    linear_combination_plain.calls += 1
    cs = coefficients(coeffs, xs[0])
    acc = cs[0] * xs[0]
    for c, x in zip(cs[1:], xs[1:]):
        acc = acc + c * x
    return acc


def linear_combination(coeffs, xs):
    """z = sum_k coeffs[k] * xs[k]; the xs share one shape and dtype,
    and there are at most ``LINCOMB_MAX_K`` of them."""
    x0 = xs[0]
    if len(xs) > LINCOMB_MAX_K:
        raise ValueError(f"linear_combination: {len(xs)} terms, at most "
                         f"{LINCOMB_MAX_K}")
    if _build.on_cpu("linear_combination", x0):
        return linear_combination_plain(coeffs, xs)
    cs = coefficients(coeffs, x0)
    if len(cs) != len(xs):
        raise ValueError(f"linear_combination: {len(cs)} coefficients for "
                         f"{len(xs)} vectors")
    for c in cs:
        if c.device != x0.device:
            raise ValueError(f"linear_combination: a coefficient lies on "
                             f"{c.device}, want {x0.device}")
    shape = tuple(x0.shape)
    for k, x in enumerate(xs):
        _build.check("linear_combination", x0.device,
                     **{f"x{k}": (x, shape, _FLOATS if k == 0
                                  else (x0.dtype,))})
    z = torch.empty_like(x0)
    n, fn = x0.numel(), "linear_combination_" + _build.SUFFIX[x0.dtype]
    ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    cptr = (ctypes.c_void_p * len(cs))(*(c.data_ptr() for c in cs))
    _build.launch("vecops", fn, "ippplp", len(xs), ctypes.addressof(ptrs),
                  ctypes.addressof(cptr), z.data_ptr(), n,
                  _build.stream(z.device))
    linear_combination.launches += 1
    return z


def dot_plain(x, y):
    dot_plain.calls += 1
    return (x * y).sum()


def dot(x, y):
    """<x, y> over all elements: a 0-d tensor on the vectors' device."""
    if _build.on_cpu("dot", x):
        return dot_plain(x, y)
    out = _reduce("dot", "dot", x, {"y": y})
    dot.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def reduction_plan(n: int, dtype) -> tuple:
    """``(blocks, chunk)`` of a one-launch reduction over ``n`` elements
    of ``dtype``: block b sums elements ``[b*chunk, min((b+1)*chunk,
    n))``.  ``chunk`` is a multiple of 16 bytes' worth of elements, so
    every chunk starts at the vector's own offset from a 16-byte
    boundary; at most ``RED_MAX_BLOCKS`` blocks, and vectors shorter than
    ``RED_MAX_BLOCKS`` chunks of ``RED_MIN_CHUNK_BYTES`` take fewer.  It
    depends on ``n`` and the dtype alone (not on the device or the
    vectors' addresses), so the sum's order, and its bits, do too."""
    size = dtype.itemsize
    align = 16 // size
    per = -(-n // RED_MAX_BLOCKS)
    chunk = max(-(-per // align) * align, RED_MIN_CHUNK_BYTES // size)
    return max(1, -(-n // chunk)), chunk


#: a one-launch reduction's accumulator (its partial sums' dtype): a
#: float32 reduction sums its float32 terms in float64 and rounds once
ACC_DTYPE = {torch.float32: torch.float64}

#: (device, stream, accumulator dtype) -> (partial sums, ticket counter)
_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, dtype) -> tuple:
    """A reduction's ``RED_MAX_BLOCKS`` partial sums and its int32 ticket
    counter for launches on ``stream`` (``device``'s current stream):
    made once (the counter zeroed on that stream), reused by every launch
    there, which leaves the counter at 0.  Launches on one stream are
    ordered, so they never share them at once; another stream gets its
    own pair."""
    key = (device, stream, dtype)
    pair = _SCRATCH.get(key)
    if pair is None:
        pair = _SCRATCH[key] = (
            torch.empty((RED_MAX_BLOCKS,), dtype=dtype, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device))
    return pair


def _reduce(name, symbol, x, others: dict, extra=()):
    """Launch one reduction over ``x`` and the named ``others`` (x's
    shape and dtype); ``extra`` are pointers passed after theirs."""
    shape = tuple(x.shape)
    _build.check(name, x.device, x=(x, shape, _FLOATS),
                 **{k: (v, shape, (x.dtype,)) for k, v in others.items()})
    stream = _build.stream(x.device)
    partial, ticket = _scratch(x.device, stream, ACC_DTYPE.get(x.dtype,
                                                                x.dtype))
    out = torch.empty((), dtype=x.dtype, device=x.device)
    blocks, chunk = reduction_plan(x.numel(), x.dtype)
    ptrs = [v.data_ptr() for v in (x, *others.values())] + list(extra)
    _build.launch("vecops", symbol + "_" + _build.SUFFIX[x.dtype],
                  "p" * (len(ptrs) + 3) + "lilp", *ptrs, partial.data_ptr(),
                  ticket.data_ptr(), out.data_ptr(), x.numel(), blocks, chunk,
                  stream)
    return out


def wrms_ss_plain(x, w):
    wrms_ss_plain.calls += 1
    xw = x * w
    return (xw * xw).sum()


def wrms_ss(x, w):
    """sum((x*w)^2) over all elements: a 0-d tensor on x's device."""
    if _build.on_cpu("wrms_ss", x):
        return wrms_ss_plain(x, w)
    out = _reduce("wrms_ss", "wrms_ss", x, {"w": w}, extra=(None,))
    wrms_ss.launches += 1
    return out


def wrms_mask_ss_plain(x, w, m):
    wrms_mask_ss_plain.calls += 1
    xm = x * w * m
    return (xm * xm).sum()


def wrms_mask_ss(x, w, m):
    """sum((x*w*m)^2) over all elements; m is a 0/1 vector of x's
    dtype (the mask multiplies, as in the reference)."""
    if _build.on_cpu("wrms_mask_ss", x):
        return wrms_mask_ss_plain(x, w, m)
    out = _reduce("wrms_mask_ss", "wrms_ss", x, {"w": w, "m": m})
    wrms_mask_ss.launches += 1
    return out


def _multi(op, x, ys):
    """Check the K vectors of a multi-vector op and return them."""
    ys = list(ys)
    if not 1 <= len(ys) <= MULTI_MAX_K:
        raise ValueError(f"{op}: {len(ys)} vectors, want 1 to "
                         f"{MULTI_MAX_K}")
    if x.device.type == "cuda":
        shape = tuple(x.shape)
        _build.check(op, x.device, x=(x, shape, _FLOATS),
                     **{f"y{k}": (y, shape, (x.dtype,))
                        for k, y in enumerate(ys)})
    return ys


def scale_add_multi_plain(coeffs, x, ys):
    scale_add_multi_plain.calls += 1
    cs = coefficients(coeffs, x)
    return torch.stack([c * x + y for c, y in zip(cs, ys)])


def scale_add_multi(coeffs, x, ys):
    """Z[k] = coeffs[k]*x + ys[k] for the K <= ``MULTI_MAX_K`` vectors
    ``ys`` (x's shape and dtype): a ``(K, *x.shape)`` tensor."""
    ys = _multi("scale_add_multi", x, ys)
    if _build.on_cpu("scale_add_multi", x):
        return scale_add_multi_plain(coeffs, x, ys)
    cs = coefficients(coeffs, x)
    if len(cs) != len(ys):
        raise ValueError(f"scale_add_multi: {len(cs)} coefficients for "
                         f"{len(ys)} vectors")
    for c in cs:
        if c.device != x.device:
            raise ValueError(f"scale_add_multi: a coefficient lies on "
                             f"{c.device}, want {x.device}")
    z = torch.empty((len(ys),) + tuple(x.shape), dtype=x.dtype,
                    device=x.device)
    yptr = (ctypes.c_void_p * len(ys))(*(y.data_ptr() for y in ys))
    cptr = (ctypes.c_void_p * len(cs))(*(c.data_ptr() for c in cs))
    _build.launch("vecops", "scale_add_multi_" + _build.SUFFIX[x.dtype],
                  "ipppplp", len(ys), x.data_ptr(),
                  ctypes.addressof(yptr), ctypes.addressof(cptr),
                  z.data_ptr(), x.numel(), _build.stream(x.device))
    scale_add_multi.launches += 1
    return z


def dot_prod_multi_plain(x, ys):
    dot_prod_multi_plain.calls += 1
    return torch.stack([(x * y).sum() for y in ys])


def dot_prod_multi(x, ys):
    """d_k = <x, ys[k]> for the K <= ``MULTI_MAX_K`` vectors ``ys``: a
    ``(K,)`` tensor on x's device."""
    ys = _multi("dot_prod_multi", x, ys)
    if _build.on_cpu("dot_prod_multi", x):
        return dot_prod_multi_plain(x, ys)
    K = len(ys)
    partial = torch.empty((K * DOT_MAX_BLOCKS,), dtype=x.dtype,
                          device=x.device)
    out = torch.empty((K,), dtype=x.dtype, device=x.device)
    yptr = (ctypes.c_void_p * K)(*(y.data_ptr() for y in ys))
    _build.launch("vecops", "dot_prod_multi_" + _build.SUFFIX[x.dtype],
                  "ipppplp", K, x.data_ptr(), ctypes.addressof(yptr),
                  partial.data_ptr(), out.data_ptr(), x.numel(),
                  _build.stream(x.device))
    dot_prod_multi.launches += 1
    return out


for _fn in (linear_combination, dot, wrms_ss, wrms_mask_ss, scale_add_multi,
            dot_prod_multi):
    _fn.launches = 0
for _fn in (linear_combination_plain, dot_plain, wrms_ss_plain,
            wrms_mask_ss_plain, scale_add_multi_plain, dot_prod_multi_plain):
    _fn.calls = 0
