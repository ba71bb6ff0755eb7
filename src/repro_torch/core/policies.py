"""Execution policies: which implementation each dispatched op runs.

Counterpart of ``repro.core.policies.ExecPolicy``.  On the card there
are two implementations of every hot op: the hand-written CUDA kernel
and its plain PyTorch version.  The policy picks between them:

============  ==========================================================
backend       meaning
============  ==========================================================
``"auto"``    the kernels, each call's cost-driven decision recorded
              for the report; the plain version for a CPU tensor (the
              default)
``"torch"``   the plain versions on purpose, on any device (the
              comparison run of ``chip_smoke.py``)
``"cuda"``    the kernels; CPU tensors raise
============  ==========================================================

``"auto"`` resolves each call on CUDA tensors by its op's shape
signature (n, nsys, b, K, nnz, dtype) through
:mod:`repro_torch.core.autotune`, as the reference's ``'auto'`` does: a
measured entry of the card's autotune cache (``.autotune_torch/<row>.json``,
written by ``python -m repro_torch.core.autotune --tune`` on the card
and not committed) wins, a measured entry within 8x along the batch axis
next; otherwise the analytical model (:mod:`repro_torch.analysis.opcost`,
over the :data:`repro_torch.analysis.roofline.DEVICES` row of the card)
predicts the winner.  Unlike the reference's, the decision is advice:
``"auto"`` runs the kernel wrapper on the card whatever it decided, so
a cache left in the checkout or a near tie (the one-term linear
combination, where the plain copy measures a few per cent faster)
cannot send a path to its plain version; a pin in ``op_overrides`` is
the way to the plain version there.  A
call on CPU tensors takes the plain version (source ``"cpu"``); a card
with no roofline row runs its kernels (source ``"no-row"``).  The
decisions are memoized per call shape and inspectable through
``Context.dispatch_report()``.  There is no ``interpret`` and no
``batch_tile``: the kernels bounds-check the system axis, so no batch
padding exists to tune.

Backend selection
-----------------
The policy is consumed by :mod:`repro_torch.core.dispatch`, whose **op
table** routes each op to the implementation the policy names.  The
matrix below is rendered from ``OP_TABLE`` itself (``python -m
repro_torch.core.dispatch`` prints it; a test asserts it is embedded
verbatim, so ops cannot drift out of this doc):

============================  =============================  ===============================
op                            'torch' backend                'cuda' backend
============================  =============================  ===============================
linear_sum                    vecops lincomb plain (K=2)     row 12 lincomb_kernel (K=2)
linear_combination            vecops lincomb plain           row 12 lincomb_kernel
scale_add_multi               vecops scale_add_multi plain   row 13 scale_add_multi_kernel
axpy                          vecops lincomb plain (K=2)     row 12 lincomb_kernel (K=2)
dot                           (x*y).sum()                    row 16 onepass_reduce (dot)
wrms_norm                     sqrt(sum((x*w)^2)/N)           row 14 onepass_reduce (wrms)
wrms_norm_mask                sqrt(sum((x*w*m)^2)/N)         row 15 onepass_reduce (mask)
dot_prod_multi                stacked (x*y_k).sum()          row 17 multi_dot + final
wrms_ss                       sum((x*w)^2)                   row 14 onepass_reduce (wrms)
block_solve_soa               Gauss-Jordan, kernel order     rows 8, 9 gj_solve_*
block_inverse_soa             Gauss-Jordan inverse           rows 6, 7 gj_inverse_*
blockdiag_spmv_soa            per-block products, in order   row 2 spmv_*_kernel
newton_residual_soa           z - gamma*f - psi              row 1 newton_residual_kernel
masked_update_wrms_soa        where + per-system WRMS        row 3 masked_update_wrms_kernel
history_rescale_soa           masked W Z products            row 4 history_rescale_kernel
wrms_soa                      per-system WRMS                row 5 wrms_soa_kernel
csr_spmv                      ELL gather + row sums          row 11 csr_spmv_kernel
bsr_spmv_soa                  block products by position     row 10 bsr_spmv_kernel
bsr_block_jacobi_inverse_soa  diag gather + plain inverse    diag gather + rows 6, 7
lagrange_rescale_soa          lagrange_matrix_soa + row 4    row 4f (W formed from eta, q)
newton_residual_lsolve_soa    rows 1, 2 plain + 2/(1+gr)     row 1+2f (one launch, b <= 8)
newton_update_soa             rows 1, 2, 3 plain + 2/(1+gr)  row 1+2+3f (one launch, b <= 8)
newton_block_inverse_soa      I - gamma*J + row 6 plain      row 6f (M formed, b <= 8)
============================  =============================  ===============================

``op_overrides`` pins single ops to a backend whatever the policy-wide
``backend`` says, e.g. ``ExecPolicy().override(blockdiag_spmv_soa=
"torch")`` runs the BDF lsolve's SpMV as its plain version and every
other op on its kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

BACKENDS = ("auto", "torch", "cuda")


@dataclass(frozen=True)
class ExecPolicy:
    """backend      : one of :data:`BACKENDS`.
    device       : where :func:`repro_torch.core.ivp.integrate` runs when
                   the call names no device (None means ``"cuda"``).
    op_overrides : per-op backend pins, a tuple of ``(op, backend)``
                   pairs (hashable, as the reference's), validated at
                   construction against ``dispatch.op_names()`` and
                   :data:`BACKENDS`: an unknown op or backend raises one
                   ``ValueError`` naming every bad pair and the valid
                   ops."""

    backend: str = "auto"
    device: Optional[str] = None
    op_overrides: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"valid: {', '.join(BACKENDS)}")
        if not self.op_overrides:
            return
        # lazy: dispatch imports this module
        from . import dispatch
        valid_ops = dispatch.op_names()
        bad = []
        for name, be in self.op_overrides:
            if name not in valid_ops:
                bad.append(f"unknown dispatch op {name!r}")
            if be not in BACKENDS:
                bad.append(f"unknown backend {be!r} for op {name!r} "
                           f"(valid: {', '.join(map(repr, BACKENDS))})")
        if bad:
            raise ValueError(
                "invalid ExecPolicy.op_overrides: %s; valid OP_TABLE "
                "ops: %s" % ("; ".join(bad), ", ".join(sorted(valid_ops))))

    def device_name(self) -> str:
        """The resolver this policy's context reports: ``"cpu"`` for a
        CPU ``device``, else the card's row, or ``"no-row"`` for a card
        the table has none of (None: the card, which raises without
        CUDA)."""
        from .autotune import row_of
        return row_of(resolve_device(self.device))

    def backend_for(self, op: str) -> str:
        """Backend for one op: an ``op_overrides`` pin wins, else the
        policy-wide ``backend``."""
        for name, be in self.op_overrides:
            if name == op:
                return be
        return self.backend

    def pinned(self, op: str) -> bool:
        """Whether ``op_overrides`` pins ``op`` (to any backend)."""
        return any(name == op for name, _ in self.op_overrides)

    def override(self, **ops: str) -> "ExecPolicy":
        """A copy with per-op pins added (a later pin of an op replaces
        an earlier one), e.g. ``ExecPolicy().override(
        blockdiag_spmv_soa="torch")``."""
        merged = dict(self.op_overrides)
        merged.update(ops)
        return replace(self, op_overrides=tuple(sorted(merged.items())))


DEFAULT = ExecPolicy()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.

    The entry points run on the card unless the caller asks for the CPU:
    without CUDA they raise instead of falling back silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
