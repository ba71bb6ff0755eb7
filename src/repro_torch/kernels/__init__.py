"""The port's hand-written CUDA kernels, each beside its plain version.

Every wrapper launches its kernel for CUDA tensors and counts the launch
in its ``launches`` attribute; for CPU tensors it runs the plain PyTorch
version, which counts its own ``calls``.  :func:`reset_counts` zeroes
both, so a run can show which implementation its main path went
through.
"""
from __future__ import annotations

from . import block_solve, blockdiag_spmv, newton

#: name -> (wrapper, plain version) for the six kernels of the ensemble
#: BDF path
KERNELS = {
    "newton_residual": (newton.newton_residual,
                        newton.newton_residual_plain),
    "blockdiag_spmv": (blockdiag_spmv.blockdiag_spmv_soa,
                       blockdiag_spmv.blockdiag_spmv_soa_plain),
    "masked_update_wrms": (newton.masked_update_wrms,
                           newton.masked_update_wrms_plain),
    "history_rescale": (newton.history_rescale,
                        newton.history_rescale_plain),
    "wrms_soa": (newton.wrms_soa, newton.wrms_soa_plain),
    "block_inverse": (block_solve.block_inverse_soa,
                      block_solve.block_inverse_soa_plain),
}


def reset_counts() -> None:
    for wrapper, plain in KERNELS.values():
        wrapper.launches = 0
        plain.calls = 0


def counts() -> dict:
    """``{name: (kernel launches, plain calls)}`` since the last reset."""
    return {name: (w.launches, p.calls) for name, (w, p) in KERNELS.items()}
