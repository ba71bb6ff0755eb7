"""N_Vector kernels over flat vectors (counterpart of
``repro/kernels/vecops.py``), each with its plain PyTorch version:

* :func:`linear_combination` — ``z = sum_k c_k x_k`` in one pass (the
  dispatch ops ``linear_sum``, ``axpy`` and ``linear_combination``);
* :func:`dot` — ``<x, y>``, a deterministic two-stage reduction that
  returns a 0-d tensor on the vectors' device.

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
#: the dot's partial sums, at most (``DOT_MAX_BLOCKS`` in csrc/vecops.cu)
DOT_MAX_BLOCKS = 1024


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
    shape = tuple(x.shape)
    _build.check("dot", x.device, x=(x, shape, _FLOATS),
                 y=(y, shape, (x.dtype,)))
    # the partial sums return to PyTorch's stream-ordered cache when the
    # wrapper returns; a later use on this stream waits for the kernel
    partial = torch.empty((DOT_MAX_BLOCKS,), dtype=x.dtype, device=x.device)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    _build.launch("vecops", "dot_" + _build.SUFFIX[x.dtype], "pppplp",
                  x.data_ptr(), y.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), x.numel(), _build.stream(x.device))
    dot.launches += 1
    return out


linear_combination.launches = 0
dot.launches = 0
linear_combination_plain.calls = 0
dot_plain.calls = 0
