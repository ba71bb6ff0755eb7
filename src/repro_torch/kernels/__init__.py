"""The port's hand-written CUDA kernels, each beside its plain version.

Every wrapper launches its kernel for CUDA tensors and counts the launch
in its ``launches`` attribute; for CPU tensors it runs the plain PyTorch
version, which counts its own ``calls``.  The two Gauss-Jordan entries
have two kernel bodies each (b <= 8 and b > 8) and count per body
(``launches_unrolled``, ``launches_tiled``, ``calls_unrolled``, ...).
:func:`reset_counts` zeroes them all, so a run can show which
implementation, and which body, its path went through.
"""
from __future__ import annotations

from . import block_solve, blockdiag_spmv, newton, sparse, vecops

#: name -> (wrapper, plain version, body) for every ported kernel body;
#: body "" names a wrapper with one body, else the suffix of its counters
KERNELS = {
    "newton_residual": (newton.newton_residual,
                        newton.newton_residual_plain, ""),
    "blockdiag_spmv": (blockdiag_spmv.blockdiag_spmv_soa,
                       blockdiag_spmv.blockdiag_spmv_soa_plain, ""),
    "newton_residual_lsolve": (newton.newton_residual_lsolve,
                               newton.newton_residual_lsolve_plain, ""),
    "masked_update_wrms": (newton.masked_update_wrms,
                           newton.masked_update_wrms_plain, ""),
    "newton_update": (newton.newton_update, newton.newton_update_plain, ""),
    "history_rescale": (newton.history_rescale,
                        newton.history_rescale_plain, ""),
    "lagrange_rescale": (newton.lagrange_rescale,
                         newton.lagrange_rescale_plain, ""),
    "wrms_soa": (newton.wrms_soa, newton.wrms_soa_plain, ""),
    "block_inverse": (block_solve.block_inverse_soa,
                      block_solve.block_inverse_soa_plain, "unrolled"),
    "block_inverse_tiled": (block_solve.block_inverse_soa,
                            block_solve.block_inverse_soa_plain, "tiled"),
    "newton_block_inverse": (block_solve.newton_block_inverse_soa,
                             block_solve.newton_block_inverse_soa_plain, ""),
    "block_solve": (block_solve.block_solve_soa,
                    block_solve.block_solve_soa_plain, "unrolled"),
    "block_solve_tiled": (block_solve.block_solve_soa,
                          block_solve.block_solve_soa_plain, "tiled"),
    "bsr_spmv": (sparse.bsr_spmv_soa, sparse.bsr_spmv_soa_plain, ""),
    "csr_spmv": (sparse.csr_spmv, sparse.csr_spmv_plain, ""),
    "linear_combination": (vecops.linear_combination,
                           vecops.linear_combination_plain, ""),
    "dot": (vecops.dot, vecops.dot_plain, ""),
    "scale_add_multi": (vecops.scale_add_multi,
                        vecops.scale_add_multi_plain, ""),
    "wrms_ss": (vecops.wrms_ss, vecops.wrms_ss_plain, ""),
    "wrms_mask_ss": (vecops.wrms_mask_ss, vecops.wrms_mask_ss_plain, ""),
    "dot_prod_multi": (vecops.dot_prod_multi, vecops.dot_prod_multi_plain,
                       ""),
}


def _attrs(body: str) -> tuple:
    """Names of the launch and call counters of one body."""
    return ("launches", "calls") if not body else \
        (f"launches_{body}", f"calls_{body}")


def reset_counts() -> None:
    for wrapper, plain, body in KERNELS.values():
        launches, calls = _attrs(body)
        setattr(wrapper, launches, 0)
        setattr(plain, calls, 0)


def counts() -> dict:
    """``{name: (kernel launches, plain calls)}`` since the last reset."""
    out = {}
    for name, (wrapper, plain, body) in KERNELS.items():
        launches, calls = _attrs(body)
        out[name] = (getattr(wrapper, launches), getattr(plain, calls))
    return out
