#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile[=main,A,...,M]] [--ptxas]

Run from the repository root.  It imports nothing of JAX or of the JAX
package.  Phases, each of which fails the run (non-zero exit), and each
of which prints the seconds it took:

1. device: prints the card's name and power limit (``nvidia-smi``);
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
   (one process per source, all at once) unless already built;
3. kernels: each ported kernel body against its plain PyTorch version
   on the card, in float64 and float32: the six of the ensemble-BDF path
   and the fused history rebuild ``lagrange_rescale`` (W formed from
   eta and q) at the main-path shape (2**20 systems, n = b = 3) and at
   ragged batches (7, 130, 516), the six and the fused rebuild also at
   path M's decay chain, n = b = 6, over those and 16384 systems, both
   rebuild entries and ``wrms_soa`` also at n = 32 over those and 2**16
   systems, both rebuild entries bit for bit (also with no system and
   with every system active),
   ``blockdiag_spmv`` also at b = 9, 16, 24, 32
   (its row form; 32 is path K's) and 33 over 7, 130, 516 and 2**16
   systems, equal to its plain version bit for bit at every b (it sums
   in the plain version's order); the two Gauss-Jordan entries at b = 1, 3,
   8 (register bodies), and their tiled bodies at b = 9, 16, 24, 32
   (the warp-per-system form) and 33 (the device-memory form) over 7,
   130, 516 and 2**16 systems; both entries on stiff Robertson Newton
   blocks, the tiled bodies also on path B's Brusselator Newton blocks
   (I - gamma*J at its initial states, gamma over 1e-4..1e-1), with
   |M x - r| within 1e-10*(|M||x|+|r|);
   the sparse ensemble's three: ``bsr_spmv_soa`` at b = 1, 2, 3 on the
   Brusselator's 124-entry pattern, ``linear_combination`` (K = 3) and
   ``dot`` over (32, nb) vectors, at nb = 2**16 and ragged; the four
   N_Vector bodies of the scalar stack (``wrms_ss``, ``wrms_mask_ss``,
   ``scale_add_multi``, ``dot_prod_multi``) at N = 1, 130, 8193 and
   3*2**20 + 5 with K = 1, 3, 5, 8 vectors, the reductions also for
   repeating their bits, and the one-launch reductions (``dot``,
   ``wrms_ss``, ``wrms_mask_ss``) at those N on views at every offset
   from a 16-byte boundary, each input at its own, for the aligned
   copies' bits; the scalar CSR SpMV (``csr_spmv``) on path I's
   pattern (the §7 Brusselator's Jacobian over 3*2**20 rows, 4 entries a
   row) and on a ragged banded pattern of 133 rows.
   Each comparison also checks that the wrapper launched the body it
   should.  Then each body, its plain version and, where one exists, a
   single PyTorch library call computing the same function are timed
   with CUDA events (median of 25, L2 flushed before each run) at the
   shape its path gives it, the tiled Gauss-Jordan bodies and
   ``blockdiag_spmv`` also at b = 16 and 24 over 2**16 systems,
   ``blockdiag_spmv`` also at b = 32 over 2**16 (path K) and b = 2 over
   2**20 (path D's ``BlockJacobiPrecond(2)``), the Newton loop's five
   (``newton_residual``, ``masked_update_wrms``, ``history_rescale``,
   ``lagrange_rescale``, ``wrms_soa``) also at n = 32 over 2**16 (paths
   B, K, D, E, F), the six of the ensemble-BDF path also at n = 6 over
   16384 (path M's decay chain), the two rebuild entries also with
   every system active, the
   dot also at 3*2**20 elements (paths H and I) and at 32 (the floor of
   one timed launch);
4. paths, each driven through ``integrate`` with the launch counts set
   to 0 just before and read just after; each must launch the kernels
   of its path and no plain version, and agree with a run of the plain
   versions (``ExecPolicy(backend="torch")``; on the BDF paths that run
   builds W with ``lagrange_matrix_soa``, the kernel run never): equal
   retcodes and y
   within 10*(rtol*|y|+atol) (100*(...) for the Krylov paths D and F,
   whose one global iteration couples the lanes: their plain run covers
   the same systems).  rtol 1e-5, atol 1e-10, float64:
   - ensemble BDF, the main path: ``"ensemble_bdf"`` with
     ``BlockDiagGJ()`` over 2**20 batched Robertson systems (rates from
     numpy seed 0) to t = 10; 256 classic-Robertson lanes must match
     scipy's Radau IIA (rtol 1e-12) within 10*(rtol*|y|+atol);
   - path A: ``"ensemble_dirk:sdirk2"`` on the same 2**20 systems (the
     plain run on the first 2**16 of them: the lanes are independent),
     and the same Radau check;
   - path B: ``"ensemble_bdf"`` with ``BlockDiagGJ(factor_once=False)``
     on ``ensemble_brusselator(2**16, nx=16)`` (n = b = 32) to t = 2;
   - path K: ``"ensemble_bdf"`` with the default ``BlockDiagGJ()`` on
     B's systems (the b = 32 inverse once a lsetup, ``blockdiag_spmv``
     at b = 32 once a Newton iteration, which it checks); K's and B's
     final states, the same problem under two lsolves, are compared in
     the max norm over rtol*|y|+atol (printed);
   - path C: ``"ensemble_erk:bogacki_shampine"`` on that ensemble;
   - paths D, E, F: ``"ensemble_bdf"`` on that ensemble with its
     ``jac_sparsity`` (124 entries): D ``SPGMR(tol=1e-10, restart=10,
     max_restarts=6, precond=BlockJacobiPrecond(2))``, E
     ``EnsembleSparseGJ()``, F ``SPBCGS(tol=1e-10, maxiter=200,
     precond=ILU0Precond())``;
   the Robertson paths also conserve y1+y2+y3 = 1 within 10*rtol;
   - paths G and H, the paper's §7 demonstration through
     ``repro_torch.apps.brusselator.integrate`` (``imex:ark324``,
     rtol 1e-6, atol 1e-9, float64) on the advection-reaction
     Brusselator at nx = 2**20 (3*2**20 unknowns): G the task-local
     Newton (3x3 block solve) to t = 0.2, H the global Newton-GMRES
     with the block solve as preconditioner to t = 0.05; each held to
     its plain run with every counter (steps, attempts, Newton
     iterations, error-test and convergence failures) equal and the
     difference within 1 in the WRMS norm the integrator's error test
     controls; H also in the max norm within 10*(rtol*|y|+atol).  G's
     plain run pivots in its block solve, the kernel does not, and at
     this mesh the advected kink of the periodic initial state carries a
     grid-scale oscillation that amplifies such rounding differences, so
     G's max-norm ratio is printed, and G is also held to a plain run
     that keeps the kernel's no-pivot Gauss-Jordan (counters equal, WRMS
     within 1); H to a task-local run to t = 0.05 within the reference
     test's rtol 1e-7, atol 1e-9 (``tests/test_brusselator.py:14``);
   - path I, CVODE with a CSR Newton matrix:
     ``integrate(IVP(f=fe+fi), 0, 0.005, "bdf", lin_solver=csr_gmres)``
     on that mesh (one stiff system, the upwind advection implicit too;
     rtol 1e-6, atol 1e-9, ``newton_max`` 6, order 5), where
     ``csr_gmres`` builds the Jacobian as a ``SparseCSR`` over a fixed
     pattern, forms ``J.scale_addI(-gamma)`` and solves with GMRES
     (restart 16) preconditioned by the 3x3 block solve;
   - path J: ``integrate(IVP(f=fe), 0, 0.02, "adams")``, the nonstiff
     advection half of the split on the same mesh;
   I and J are held to their plain runs as G is: every counter equal
   and the WRMS norm of the difference within 1, the max-norm ratio
   printed;
   - path L, coupled legs, run right after the main path on its
     problem, through one ``Context`` with a 256-slot step-telemetry
     ring, the profiler and the INFO logger on: y0 made on the host
     and moved by ``ctx.memory``; leg 1 to t = 10 (``timed=True``,
     ``return_session=True``) equal to the main path's kernel run bit
     for bit with its host syncs; leg 2 to t = 20 warm from that
     session, twice from one handle (the same bits, the handle
     unchanged), cold from leg 1's y, and warm on the plain versions
     (the warm kernel leg held to it as the main path is); each leg
     conserves mass, launches the main path's kernels (none in the
     plain leg), and its ring reconciles exactly, per lane, with its
     steps, attempts, Newton iterations and lsetups; the final y goes
     back to the host through ``ctx.memory`` (one copy each way, 2 *
     2**20 * 3 * 8 bytes); one ``integrate.done`` a call and no
     ``integrate.lane_failed``, the profiler's build and execute spans
     of leg 1, and ``context_metrics`` counting the calls; it prints
     each leg's wall, syncs, trips and peak memory, warm against cold
     steps, and leg 1's order occupancy and log10 h histogram;
   - path M, the serving tier, right after L: ``SolverServer`` on the
     card (``ensemble_bdf``, ``BlockDiagGJ()``, buckets 4096, 16384 and
     65536, rtol 1e-5, atol 1e-10) over Robertson (n = 3) and the decay
     chain (n = 6): a burst of 2**17 Robertson requests (the main
     path's rates) and 16000 decay-chain requests (rates U(0.1, 5) of
     numpy seed 1) drained as two full 65536-lane bundles and one
     16000-of-16384 bundle, each served lane equal to a direct
     ``integrate`` kernel run of the same systems in its per-lane steps,
     nni and retcodes and within 10*(rtol*|y|+atol) (bit for bit
     printed); a warm leg of the first 2**16 with their sessions, held
     to a direct warm call the same way, and its bundle's ``_assemble``
     timed as served (one gather a leaf) against every warm lane joined
     by ``concat`` (the reference's construction, bit for bit the same
     session); the async facade (3000 + 1000
     requests); every kernel bundle launching rows 1-6 (4f) at b = 3 and
     b = 6 and no plain version, no failure, no degraded bundle, mass
     conserved, the Prometheus scrape equal to ``metrics()``, cache
     misses equal to the distinct keys and no steady-state miss; a
     plain-version server on 2**14 of the burst's Robertson requests and
     its decay-chain requests, held to the kernel server's answers; then
     the chaos sub-phase on the card: ``run_core_chaos`` (2**16 lanes,
     k = 8, nan and divergent: exactly those lanes fail with the
     reference's retcodes, healthy lanes bit for bit the clean run) and
     ``run_serving_chaos`` (2**14 requests, 32 poisoned, 16 deadlines,
     one degraded bundle, one failed fallback, one kernel error that
     fails its bundle without a fallback); it prints each bundle's
     wall, host syncs and per-request host costs (submit, assemble,
     resolve, and the garbage collector's share), latency percentiles,
     occupancy, cache counters, peak memory and the sub-phase's seconds;
5. prints the ``{"kernels": [...]}`` line; 6. prints the ``ok`` line.

``--profile`` adds a profiled kernel run to each path (``--profile=I,J``
to the paths named; ``main`` is the main path; M profiles the drain of
one more full Robertson bundle) and writes its
busiest device kernels to ``chip_smoke_out/chip_smoke_profile_*.txt``,
with the device time under the profiler ranges of the plain code
(``lagrange_matrix_soa``, which a BDF path's kernel run must not reach,
the sparse LU, GMRES's Hessenberg work, the Brusselator's Jacobian
blocks) and, for the main path, one plain W build timed alone;
``--ptxas``
prints what ``nvcc -Xptxas -v`` reports for each kernel (registers,
spills) when it builds.  The full record goes to
``chip_smoke_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"
NSYS = 1 << 20          # Robertson systems of the main path and path A
NSUB = 1 << 16          # path A's plain-version run
NBRUSS = 1 << 16        # Brusselator members of paths B and C (n = 32)
NX = 16
NXB = 1 << 20           # mesh points of the Brusselator demonstration (G, H)
RAGGED = (7, 130, 516)
#: vector lengths and counts of the scalar stack's N_Vector kernels
VEC_N = (1, 130, 8193, 3 * NXB + 5)
VEC_K = (1, 3, 5, 8)
RTOL, ATOL = 1e-5, 1e-10
# H100 SXM, NVIDIA data sheet: HBM3 bandwidth; float64 and float32
# non-tensor-core peaks (the kernels use no tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float64": 34e12, "torch.float32": 67e12}
TOL = {"torch.float64": 1e-10, "torch.float32": 1e-4}
#: clock cycles of the spin before each timed call (~0.5 ms)
SPIN_CYCLES = 1_000_000
#: the __global__ functions of kernels/csrc, as the profiler names them
KERNEL_SYMBOLS = ("newton_residual_kernel", "masked_update_wrms_kernel",
                  "history_rescale_kernel", "history_rescale_loop_kernel",
                  "wrms_soa_kernel",
                  "spmv_fixed_kernel", "spmv_rows_kernel",
                  "spmv_any_kernel",
                  "gj_inverse_unrolled_kernel", "gj_inverse_warp_kernel",
                  "gj_inverse_inplace_kernel", "gj_solve_unrolled_kernel",
                  "gj_solve_warp_kernel", "gj_solve_tiled_kernel",
                  "bsr_spmv_fixed_kernel", "bsr_spmv_any_kernel",
                  "lincomb_kernel", "onepass_reduce_kernel",
                  "scale_add_multi_kernel", "multi_dot_partial_kernel",
                  "multi_final_kernel", "csr_spmv_kernel")
#: profiler ranges of plain tensor code whose device time is summed
RANGES = ("lagrange_matrix_soa", "spsolve.numeric_lu", "spsolve.lu_solve",
          "gmres.hessenberg", "brusselator.jacobian")
#: the Newton loop's kernels, on every BDF path
BDF_LOOP = ("newton_residual", "masked_update_wrms", "lagrange_rescale",
            "wrms_soa")
#: path -> the kernel bodies (registry names) it must launch
PATH_KERNELS = {
    "ensemble_bdf": ("newton_residual", "blockdiag_spmv",
                     "masked_update_wrms", "lagrange_rescale", "wrms_soa",
                     "block_inverse"),
    "A: ensemble_dirk": ("newton_residual", "block_solve", "wrms_soa"),
    "B: ensemble_bdf direct": ("newton_residual", "block_solve_tiled",
                               "masked_update_wrms", "lagrange_rescale",
                               "wrms_soa"),
    "K: ensemble_bdf BlockDiagGJ": ("newton_residual", "block_inverse_tiled",
                                    "blockdiag_spmv", "masked_update_wrms",
                                    "lagrange_rescale", "wrms_soa"),
    "C: ensemble_erk": ("wrms_soa",),
    "D: ensemble_bdf SPGMR": BDF_LOOP + ("bsr_spmv", "dot", "block_inverse",
                                         "blockdiag_spmv"),
    "E: ensemble_bdf EnsembleSparseGJ": BDF_LOOP,
    "F: ensemble_bdf SPBCGS": BDF_LOOP + ("bsr_spmv", "linear_combination",
                                          "dot"),
    "G: imex task-local": ("block_solve", "linear_combination", "wrms_ss"),
    "H: imex global": ("block_solve", "linear_combination", "wrms_ss", "dot"),
    "I: bdf csr": ("csr_spmv", "block_solve", "linear_combination", "wrms_ss",
                   "dot"),
    "J: adams": ("wrms_ss",),
    "L: coupled legs": ("newton_residual", "blockdiag_spmv",
                        "masked_update_wrms", "lagrange_rescale", "wrms_soa",
                        "block_inverse"),
    "M: serving": ("newton_residual", "blockdiag_spmv", "masked_update_wrms",
                   "lagrange_rescale", "wrms_soa", "block_inverse"),
}
#: path L: slots of the step-telemetry ring, and the legs' intervals
L_RING = 256
L_LEG1, L_LEG2 = (0.0, 10.0), (10.0, 20.0)
#: path M, the serving tier: bucket sizes; the burst's Robertson requests
#: (rates of numpy seed 0) and decay-chain requests (n = 6); the warm
#: leg's requests (the burst's first); the async leg's Robertson and
#: decay-chain requests; the plain-version server's Robertson requests
#: (the burst's first); the chaos sub-phase's core lanes and faults, and
#: its serving requests, faults and bucket.  The plain server's and the
#: serving chaos's requests are cut from 2**16 to 2**14 (PERF.md §4):
#: each request costs ~50-100 us of host Python on the card's host, and
#: every 65536-lane bundle stays
M_BUCKETS = (4096, 16384, 65536)
M_ROB, M_DECAY, M_WARM = 1 << 17, 16000, 1 << 16
M_ASYNC = (3000, 1000)
M_PLAIN = 1 << 14
M_CHAOS_NSYS, M_CHAOS_K = 1 << 16, 8
M_CHAOS_REQUESTS, M_CHAOS_FAULTS, M_CHAOS_BUCKET = 1 << 14, 32, 1 << 14
#: the decay chain's systems in phase 3 (path M's padded bundle)
NDECAY = 16384
#: t_final of paths I and J (each run ~15 s or less on the card; J takes
#: 20+ steps at nx = 2**20)
TF_I, TF_J = 0.005, 0.02


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def nbytes(*items) -> int:
    """Bytes of the tensors among ``items``, lists and tuples walked."""
    return sum(nbytes(*t) if isinstance(t, (list, tuple)) else
               t.numel() * t.element_size() if hasattr(t, "element_size")
               else 0 for t in items)


def solve_flops(b, nb):
    """Operations of one no-pivot GJ solve: row scaling (b divisions,
    b*(b+1) products), then per pivot step one division, the pivot row's
    columns right of the pivot and r, and a product and a difference for
    each of them in the other b-1 rows."""
    return nb * (b * (b + 2) + sum(1 + (b - k) * (2 * b - 1)
                                   for k in range(b)))


def inverse_flops(b, nb):
    return nb * (b + 2 * b * b + b * (1 + 2 * b + 4 * b * (b - 1)))


class Kernel:
    """One kernel body: how to call it, its plain version, an optional
    library yardstick, the shapes it is checked and timed at, and its
    least time on the card."""

    def __init__(self, name, wrapper, plain, replaces, source, args, kw,
                 flops, cases, timing=(3, NSYS), library=None,
                 skipped_bytes=lambda d: 0, make=None, index_bytes=None,
                 err_scale=None, more_timings=(), exact=False):
        self.name, self.wrapper, self.plain = name, wrapper, plain
        self.replaces, self.source = replaces, source
        self.args, self.kw, self.flops, self.library = args, kw, flops, library
        #: (b, nb) it is compared at; (b, nb) it is timed at (the path's
        #: shape, in the kernels line) and more (b, nb) it is timed at
        self.cases, self.timing = cases, timing
        self.more_timings = more_timings
        # input bytes that this data does not need read (the bound counts
        # what the run's data needs)
        self.skipped_bytes = skipped_bytes
        #: the inputs' maker: (nb, dtype, gen, dev, b) -> dict
        self.make = make or make_inputs
        # bytes of static index arrays the kernel also reads
        self.index_bytes = index_bytes or (lambda d: 0)
        # the scale of the comparison's tolerance: max(1, |plain|) unless
        # given (args, plain) -> float
        self.err_scale = err_scale
        #: the body sums in its plain version's order: equal bit for bit
        self.exact = exact
        self.max_err = 0.0

    def compare(self, d, what):
        import torch
        from repro_torch import kernels
        args = self.args(d)
        before = kernels.counts()[self.name][0]
        got = self.wrapper(*args, **self.kw)
        check(kernels.counts()[self.name][0] == before + 1,
              f"{self.name} {what}: the wrapper did not launch this body")
        want = self.plain(*args, **self.kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = (g - w).abs().max().item()
            check(not self.exact or torch.equal(g, w),
                  f"{self.name} {what}: kernel and plain version differ in "
                  f"their bits (max |kernel-plain| {err})")
            scale = max(1.0, w.abs().max().item()) if self.err_scale is None \
                else self.err_scale(args, w)
            tol = TOL[str(w.dtype)] * scale
            check(err <= tol, f"{self.name} {what}: |kernel-plain| {err} > "
                  f"{tol}")
            if w.dtype == torch.float64:
                self.max_err = max(self.max_err, err)


def robertson_newton_blocks(nb, gen, dev, dtype):
    """M = I - gamma*J at Robertson states, gamma over eight decades:
    entries spanning many decades, the case the GJ row scaling is for."""
    import torch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(nb, generator=gen, device=dev,
                                           dtype=dtype)

    k1 = torch.full((nb,), 0.04, device=dev, dtype=dtype)
    k2, k3 = 1e4 * (0.5 + u(0, 1)), 3e7 * 10.0 ** u(-1, 1)
    b, c, z = 10.0 ** u(-8, -4), u(0, 1), torch.zeros_like(k1)
    J = torch.stack([torch.stack([-k1, k2 * c, k2 * b]),
                     torch.stack([k1, -k2 * c - 2 * k3 * b, -k2 * b]),
                     torch.stack([z, 2 * k3 * b, z])])
    gam = 10.0 ** u(-8, 0)
    return torch.eye(3, device=dev, dtype=dtype)[:, :, None] - gam * J


def brusselator_newton_blocks(gen, dev):
    """Path B's Newton blocks M = I - gamma*J, J the Jacobian of
    ``ensemble_brusselator(NBRUSS, nx=NX)`` at its initial states (b =
    32), gamma over 1e-4..1e-1; and a right-hand side r, float64."""
    import torch
    from repro_torch.core import problems
    y0 = problems.ensemble_brusselator(NBRUSS, nx=NX, device=dev)[3]
    jac = problems.ensemble_brusselator_soa(NBRUSS, nx=NX, device=dev)[1]
    J = jac(torch.zeros(NBRUSS, device=dev, dtype=y0.dtype), y0.T.contiguous())
    gam = 10.0 ** (-4 + 3 * torch.rand(NBRUSS, generator=gen, device=dev,
                                       dtype=y0.dtype))
    n = J.shape[0]
    M = torch.eye(n, device=dev, dtype=J.dtype)[:, :, None] - gam * J
    return M.contiguous(), torch.randn(n, NBRUSS, generator=gen, device=dev,
                                       dtype=J.dtype)


def make_inputs(nb, dtype, gen, dev, b=3):
    """Inputs of the ensemble kernels over nb systems of n = b
    components (each path's state size is its block size): the Newton
    loop's vectors, weights, mask, W and history Z (6, n, nb); the
    fused rebuild's step ratios eta over [0.1, 10] (every fifth exactly
    1) and valid history counts q over 0..5 (int32); blocks A (b, b,
    nb), diagonally dominant, and r."""
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    eta = 10.0 ** (2 * torch.rand(nb, generator=gen, device=dev,
                                  dtype=dtype) - 1)
    eta[::5] = 1.0
    q = torch.randint(0, 6, (nb,), generator=gen, device=dev,
                      dtype=torch.int32)
    return {"z": r(b, nb), "f": r(b, nb), "psi": r(b, nb),
            "gam": r(nb).abs(), "w": r(b, nb).abs() + 0.1,
            "mask": torch.rand(nb, generator=gen, device=dev) > 0.4,
            "W": r(6, 6, nb), "Z": r(6, b, nb), "r": r(b, nb),
            "eta": eta, "q": q,
            "A": r(b, b, nb) + b * torch.eye(b, device=dev,
                                              dtype=dtype)[:, :, None]}


def brusselator_pattern():
    """The ensemble Brusselator's Jacobian pattern at NX cells (n = 32,
    124 entries with the diagonal) as the 1x1 block pattern (brows,
    bcols, n) of its Krylov matvec."""
    import numpy as np
    from repro_torch.core import problems, spsolve
    P = problems.ensemble_brusselator(1, nx=NX, device="cpu")[2]
    indptr, indices = spsolve.encode_pattern(P)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return (tuple(int(r) for r in rows), tuple(int(c) for c in indices),
            len(indptr) - 1)


def make_sparse_inputs(nb, dtype, gen, dev, b=1):
    """Inputs of the sparse ensemble's kernels over nb systems: block
    values on the Brusselator pattern (b x b blocks), x, three Krylov
    vectors (n, nb) and three device coefficients; at b = 1 also the
    library yardsticks' operands, built here, outside any timing: the
    ensemble as one block-diagonal CSR matrix of order n*nb, and the
    Krylov vectors and coefficients stacked as (3, n*nb) and (3,)."""
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    pattern = brusselator_pattern()
    brows, bcols, n = pattern
    d = {"pattern": pattern, "vals": r(len(brows), b, b, nb),
         "xb": r(n, b, nb), "v": [r(n, nb) for _ in range(3)],
         "c": list(r(3).unbind(0))}
    if b == 1:
        s = torch.arange(nb, device=dev)
        rows = torch.as_tensor(brows, device=dev)[:, None] * nb + s
        cols = torch.as_tensor(bcols, device=dev)[:, None] * nb + s
        with warnings.catch_warnings():     # "sparse CSR is in beta"
            warnings.simplefilter("ignore", UserWarning)
            d["csr"] = torch.sparse_coo_tensor(
                torch.stack([rows.reshape(-1), cols.reshape(-1)]),
                d["vals"].reshape(-1), (n * nb, n * nb),
                check_invariants=False).coalesce().to_sparse_csr()
        d["xflat"] = d["xb"].reshape(n * nb, 1)
        d["X"] = torch.stack(d["v"]).reshape(3, -1)
        d["cvec"] = torch.stack(d["c"])
    return d


def make_vec_inputs(n, dtype, gen, dev, b=3):
    """Inputs of the scalar stack's N_Vector kernels: x, weights w > 0,
    a 0/1 mask m, K = b vectors ys of n elements and K device
    coefficients; and the library yardsticks' operands, stacked here,
    outside any timing: Y (K, n) and the (K,) coefficients."""
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    d = {"x": r(n), "w": r(n).abs() + 0.1,
         "m": (torch.rand(n, generator=gen, device=dev) > 0.3).to(dtype),
         "ys": [r(n) for _ in range(b)], "c": list(r(b).unbind(0))}
    d["Y"] = torch.stack(d["ys"])
    d["cvec"] = torch.stack(d["c"])
    return d


def sum_abs(*factors):
    """sum |prod factors| in float64: the scale of a sum's rounding."""
    prod = factors[0].double()
    for f in factors[1:]:
        prod = prod * f.double()
    return prod.abs().sum().item()


def bsr_flops(d):
    """Products and sums of one shared-pattern SpMV: b*(2b-1) a block
    entry, and b sums for each entry after the first of its row."""
    brows, _, nblk = d["pattern"]
    b, nb = d["vals"].shape[1], d["vals"].shape[3]
    nonempty = len(set(brows))
    return nb * (len(brows) * b * (2 * b - 1) + b * (len(brows) - nonempty))


def bsr_index_bytes(d):
    """The kernel's int32 pattern arrays: row pointer, columns, slots."""
    return 4 * (d["pattern"][2] + 1 + 2 * len(d["pattern"][0]))


@functools.lru_cache(maxsize=4)
def csr_pattern(b, n):
    """Row 11's patterns: b = 4 path I's over n = 3*nx rows, b = 0 the
    banded |i - j| <= 2 pattern of n rows (``kernels_bench.py:101``)."""
    import numpy as np
    from repro_torch.apps.brusselator import jacobian_csr_pattern
    from repro_torch.core.sunmatrix import CSRPattern
    if b == 4:
        indptr, indices, _ = jacobian_csr_pattern(n // 3)
    else:
        keep = np.abs(np.arange(n)[:, None] - np.arange(n)) <= 2
        indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
        indices = np.nonzero(keep)[1]
    return CSRPattern(indptr, indices, n)


def make_csr_inputs(n, dtype, gen, dev, b=4):
    """Row 11's inputs: values on the pattern of :func:`csr_pattern`,
    x, and the library yardstick's operands, built here, outside any
    timing: the same matrix as a ``torch.sparse_csr_tensor`` and x as a
    column."""
    import torch
    pat = csr_pattern(b, n)
    d = {"pattern": pat,
         "data": torch.randn(pat.nnz, generator=gen, device=dev,
                             dtype=dtype),
         "x": torch.randn(n, generator=gen, device=dev, dtype=dtype)}
    with warnings.catch_warnings():     # "sparse CSR is in beta"
        warnings.simplefilter("ignore", UserWarning)
        d["csr"] = torch.sparse_csr_tensor(
            torch.as_tensor(pat.indptr, device=dev),
            torch.as_tensor(pat.indices, device=dev), d["data"], (n, n))
    d["xcol"] = d["x"][:, None]
    return d


def csr_flops(d):
    """A row of L entries: L products and L - 1 sums."""
    import numpy as np
    pat = d["pattern"]
    return 2 * pat.nnz - int(np.count_nonzero(np.diff(pat.indptr)))


def lagrange_flops(d):
    """Operations of the fused rebuild on the active systems: to form W,
    per system of q + 1 valid rows the q + 1 products (-j)*eta and, for
    each of the (q + 1)**2 entries, q factors of a sum (p + k), a
    quotient (one operation) and a product; then as ``history_rescale``
    6 products and 5 sums per history row and component."""
    q = d["q"][d["mask"]].double()
    form = ((q + 1) ** 2 * 3 * q + q + 1).sum().item()
    return int(form) + 11 * 6 * d["Z"].shape[1] * int(d["mask"].sum())


def kernel_table():
    import torch
    from repro_torch.kernels import (block_solve, blockdiag_spmv, newton,
                                     sparse, vecops)

    def b_of(d):
        return d["A"].shape[0]

    def nb_of(d):
        return d["A"].shape[2]

    b3 = [(3, nb) for nb in (NSYS,) + RAGGED]
    # path M's decay chain: n = b = 6, ragged and its padded bundle
    b6 = [(6, nb) for nb in RAGGED + (NDECAY,)]
    n6 = [(6, NDECAY)]
    # the Newton loop's state on paths B, K, D, E, F: n = 32, 2**16 systems
    n32 = [(32, NBRUSS)]
    n32_cases = [(32, nb) for nb in RAGGED + (NBRUSS,)]
    csrc = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    return [
        Kernel("newton_residual", newton.newton_residual,
               newton.newton_residual_plain, ref + "newton.py:40",
               csrc + "newton.cu",
               lambda d: (d["z"], d["f"], d["psi"], d["gam"]),
               {"negate": True}, lambda d: 3 * d["z"].numel(), b3 + b6,
               more_timings=n6 + n32),
        Kernel("blockdiag_spmv", blockdiag_spmv.blockdiag_spmv_soa,
               blockdiag_spmv.blockdiag_spmv_soa_plain,
               ref + "blockdiag_spmv.py:20", csrc + "blockdiag_spmv.cu",
               lambda d: (d["A"], d["r"]), {},
               lambda d: (2 * b_of(d) - 1) * b_of(d) * nb_of(d),
               b3 + b6 + tiled_gj_cases(), exact=True,
               more_timings=tuple(n6) + SPMV_TIMINGS,
               library=lambda d: torch.einsum("ijs,js->is", d["A"], d["r"])),
        Kernel("masked_update_wrms", newton.masked_update_wrms,
               newton.masked_update_wrms_plain, ref + "newton.py:73",
               csrc + "newton.cu",
               lambda d: (d["z"], d["f"], d["w"], d["mask"]), {},
               lambda d: 3 * d["z"].numel()
               + d["z"].shape[0] * int(d["mask"].sum())
               + 2 * d["mask"].numel(), b3 + b6, more_timings=n6 + n32),
        Kernel("history_rescale", newton.history_rescale,
               newton.history_rescale_plain, ref + "newton.py:119",
               csrc + "newton.cu", lambda d: (d["W"], d["Z"], d["mask"]), {},
               # per active system, history row and component: 6
               # products and 5 sums
               lambda d: 11 * 6 * d["Z"].shape[1] * int(d["mask"].sum()),
               b3 + n32_cases, more_timings=n32, exact=True,
               library=lambda d: torch.where(d["mask"], torch.einsum(
                   "jis,iks->jks", d["W"], d["Z"]), d["Z"]),
               # an inactive system copies Z and needs none of its W
               skipped_bytes=lambda d: 36 * d["W"].element_size()
               * int((~d["mask"]).sum())),
        # the same TPU kernel with W formed in the kernel from (eta, q):
        # the BDF loop's rebuild; no single PyTorch call builds W
        Kernel("lagrange_rescale", newton.lagrange_rescale,
               newton.lagrange_rescale_plain, ref + "newton.py:119",
               csrc + "newton.cu",
               lambda d: (d["eta"], d["q"], d["Z"], d["mask"]), {},
               lagrange_flops, b3 + b6 + n32_cases, more_timings=n6 + n32,
               exact=True),
        Kernel("wrms_soa", newton.wrms_soa, newton.wrms_soa_plain,
               ref + "newton.py:167", csrc + "newton.cu",
               lambda d: (d["z"], d["w"]), {},
               lambda d: 3 * d["z"].numel() + 2 * d["z"].shape[1],
               b3 + b6 + n32_cases, more_timings=n6 + n32,
               library=lambda d: torch.linalg.vector_norm(d["z"] * d["w"],
                                                          dim=0)),
        Kernel("block_inverse", block_solve.block_inverse_soa,
               block_solve.block_inverse_soa_plain, ref + "block_solve.py:92",
               csrc + "block_solve.cu", lambda d: (d["A"],), {},
               lambda d: inverse_flops(b_of(d), nb_of(d)),
               b3 + b6 + [(1, 130), (8, 516), (8, 1 << 16)], more_timings=n6,
               library=lambda d: torch.linalg.inv(d["A"].permute(2, 0, 1))),
        Kernel("block_inverse_tiled", block_solve.block_inverse_soa,
               block_solve.block_inverse_soa_plain,
               ref + "block_solve.py:161", csrc + "block_solve.cu",
               lambda d: (d["A"],), {},
               lambda d: inverse_flops(b_of(d), nb_of(d)), tiled_gj_cases(),
               timing=(32, NBRUSS), more_timings=TILED_GJ_TIMINGS,
               library=lambda d: torch.linalg.inv(d["A"].permute(2, 0, 1))),
        Kernel("block_solve", block_solve.block_solve_soa,
               block_solve.block_solve_soa_plain, ref + "block_solve.py:55",
               csrc + "block_solve.cu", lambda d: (d["A"], d["r"]), {},
               lambda d: solve_flops(b_of(d), nb_of(d)),
               b3 + [(b, nb) for b in (1, 8) for nb in RAGGED],
               library=lambda d: torch.linalg.solve(
                   d["A"].permute(2, 0, 1), d["r"].T[..., None])),
        Kernel("block_solve_tiled", block_solve.block_solve_soa,
               block_solve.block_solve_soa_plain, ref + "block_solve.py:132",
               csrc + "block_solve.cu", lambda d: (d["A"], d["r"]), {},
               lambda d: solve_flops(b_of(d), nb_of(d)), tiled_gj_cases(),
               timing=(32, NBRUSS), more_timings=TILED_GJ_TIMINGS,
               library=lambda d: torch.linalg.solve(
                   d["A"].permute(2, 0, 1), d["r"].T[..., None])),
        Kernel("bsr_spmv", sparse.bsr_spmv_soa, sparse.bsr_spmv_soa_plain,
               ref + "sparse.py:84", csrc + "sparse.cu",
               lambda d: (d["vals"], d["xb"], d["pattern"]), {}, bsr_flops,
               sparse_cases((1, 2, 3)), timing=(1, NBRUSS),
               make=make_sparse_inputs, index_bytes=bsr_index_bytes,
               library=lambda d: torch.sparse.mm(d["csr"], d["xflat"])),
        Kernel("csr_spmv", sparse.csr_spmv, sparse.csr_spmv_plain,
               ref + "sparse.py:44", csrc + "sparse.cu",
               lambda d: (d["data"], d["x"],
                          *d["pattern"].kernel_plan(d["data"].device)), {},
               csr_flops,
               [(4, 3 * NXB), (0, 133)], timing=(4, 3 * NXB),
               make=make_csr_inputs,
               library=lambda d: torch.sparse.mm(d["csr"], d["xcol"])),
        Kernel("linear_combination", vecops.linear_combination,
               vecops.linear_combination_plain, ref + "vecops.py:42",
               csrc + "vecops.cu", lambda d: (d["c"], d["v"]), {},
               lambda d: 5 * d["v"][0].numel(), sparse_cases((1,)),
               timing=(1, NBRUSS), make=make_sparse_inputs,
               library=lambda d: torch.matmul(d["cvec"], d["X"])),
        Kernel("dot", vecops.dot, vecops.dot_plain, ref + "vecops.py:151",
               csrc + "vecops.cu", lambda d: (d["v"][0], d["v"][1]), {},
               lambda d: 2 * d["v"][0].numel() - 1, sparse_cases((1,)),
               timing=(1, NBRUSS), make=make_sparse_inputs,
               more_timings=DOT_TIMINGS,
               # a sum's rounding scales with sum |x*y|, not with |sum|
               err_scale=lambda args, w: (args[0].double()
                                          * args[1].double()).abs().sum()
               .item(),
               library=lambda d: torch.dot(d["v"][0].reshape(-1),
                                           d["v"][1].reshape(-1))),
        Kernel("scale_add_multi", vecops.scale_add_multi,
               vecops.scale_add_multi_plain, ref + "vecops.py:71",
               csrc + "vecops.cu",
               lambda d: (d["c"], d["x"], d["ys"]), {},
               lambda d: 2 * len(d["ys"]) * d["x"].numel(), vec_cases(),
               timing=(3, 3 * NXB), make=make_vec_inputs,
               library=lambda d: torch.addcmul(d["Y"], d["cvec"][:, None],
                                               d["x"])),
        Kernel("wrms_ss", vecops.wrms_ss, vecops.wrms_ss_plain,
               ref + "vecops.py:100", csrc + "vecops.cu",
               lambda d: (d["x"], d["w"]), {},
               lambda d: 3 * d["x"].numel() - 1, vec_cases((1,)),
               timing=(1, 3 * NXB), make=make_vec_inputs,
               err_scale=lambda args, w: sum_abs(*args, *args),
               library=lambda d: torch.einsum("i,i,i,i->", d["x"], d["w"],
                                              d["x"], d["w"])),
        Kernel("wrms_mask_ss", vecops.wrms_mask_ss, vecops.wrms_mask_ss_plain,
               ref + "vecops.py:125", csrc + "vecops.cu",
               lambda d: (d["x"], d["w"], d["m"]), {},
               lambda d: 4 * d["x"].numel() - 1, vec_cases((1,)),
               timing=(1, 3 * NXB), make=make_vec_inputs,
               err_scale=lambda args, w: sum_abs(*args, *args),
               library=lambda d: torch.einsum(
                   "i,i,i,i,i,i->", d["x"], d["w"], d["m"], d["x"], d["w"],
                   d["m"])),
        Kernel("dot_prod_multi", vecops.dot_prod_multi,
               vecops.dot_prod_multi_plain, ref + "vecops.py:174",
               csrc + "vecops.cu", lambda d: (d["x"], d["ys"]), {},
               lambda d: len(d["ys"]) * (2 * d["x"].numel() - 1),
               vec_cases(), timing=(3, 3 * NXB), make=make_vec_inputs,
               err_scale=lambda args, w: max(sum_abs(args[0], y)
                                             for y in args[1]),
               library=lambda d: torch.mv(d["Y"], d["x"])),
    ]


#: (b, nb) the tiled Gauss-Jordan bodies are also timed at
TILED_GJ_TIMINGS = ((16, NBRUSS), (24, NBRUSS))
#: (b, nb) blockdiag_spmv is also timed at: path K's b = 32, the row
#: form's templated 16 and 24, and path D's BlockJacobiPrecond(2) psolve
#: (2**16 systems of 16 blocks of 2)
SPMV_TIMINGS = ((32, NBRUSS),) + TILED_GJ_TIMINGS + ((2, NSYS),)
#: (b, nb) the dot is also timed at: (32, 3*2**15), the 3*2**20
#: elements of paths H's and I's GMRES (88 % of its launches), and
#: (32, 1), whose work is nil: the floor of a timed launch
DOT_TIMINGS = ((1, 3 * NXB // 32), (1, 1))


def tiled_gj_cases():
    """(b, nb) cases of the tiled Gauss-Jordan bodies: the warp form at
    b = 9 (its smallest), 16, 24 and 32 (its largest, path B's and K's),
    the device-memory form at b = 33; ragged batches and 2**16."""
    return [(b, nb) for b in (9, 16, 24, 32, 33) for nb in RAGGED + (NBRUSS,)]


def vec_cases(ks=VEC_K):
    """(K, N) cases of the scalar stack's N_Vector kernels: K vectors
    of ragged lengths, up to the Brusselator state's 3*2**20 + 5."""
    return [(k, n) for k in ks for n in VEC_N]


def sparse_cases(bs):
    """(b, nb) cases of the sparse ensemble's kernels: ragged batches
    and the paths' 2**16 systems."""
    return [(b, nb) for b in bs for nb in RAGGED + (NBRUSS,)]


def time_ms(fn, flush, reps=25):
    """Median device time of one call, CUDA events, L2 flushed before
    each run (the main path streams far more than the 50 MB L2).  A spin
    kernel after the flush keeps the device busy while the host runs the
    call's Python and enqueues it, so the events bracket the device work
    and not a wrapper's host time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_compare(table, dev):
    """Every body against its plain version at each of its (b, nb)
    cases, float64 and float32, and the GJ bodies on stiff blocks."""
    import torch
    from repro_torch.kernels import block_solve
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = sorted({(k.make.__name__, c) for k in table for c in k.cases})
    makers = {k.make.__name__: k.make for k in table}
    for dtype in (torch.float64, torch.float32):
        for maker, (b, nb) in cases:
            d = makers[maker](nb, dtype, gen, dev, b=b)
            for k in table:
                if k.make.__name__ == maker and (b, nb) in k.cases:
                    k.compare(d, f"b={b} nb={nb} {dtype}")
            if maker == "make_inputs" and b in (3, 6, 32):
                compare_rescale_masks(d, f"n={b} nb={nb} {dtype}")
    by_name = {k.name: k for k in table}
    M = robertson_newton_blocks(NSYS, gen, dev, torch.float64)
    r = torch.randn(3, NSYS, generator=gen, device=dev, dtype=M.dtype)
    stiff = {"A": M, "r": r}
    by_name["block_inverse"].compare(stiff, "Robertson Newton blocks")
    by_name["block_solve"].compare(stiff, "Robertson Newton blocks")
    Minv = block_solve.block_inverse_soa(M)
    eye = torch.einsum("ijs,jks->iks", M, Minv)
    resid = (eye - torch.eye(3, device=dev, dtype=eye.dtype)[:, :, None])
    check(resid.abs().max().item() < 1e-8,
          f"M @ inv(M) - I reaches {resid.abs().max().item()}")
    x = block_solve.block_solve_soa(M, r)
    back = (torch.einsum("ijs,js->is", M, x) - r).abs()
    scale = torch.einsum("ijs,js->is", M.abs(), x.abs()) + r.abs()
    check(bool((back <= 1e-10 * scale).all()),
          f"|M x - r| reaches {(back / scale).max().item()} of |M||x|+|r|")
    del M, r, stiff, Minv, eye, resid, x, back, scale
    # the tiled bodies on path B's (and K's) Newton blocks
    M, r = brusselator_newton_blocks(gen, dev)
    blocks = {"A": M, "r": r}
    by_name["block_inverse_tiled"].compare(blocks, "Brusselator Newton blocks")
    by_name["block_solve_tiled"].compare(blocks, "Brusselator Newton blocks")
    for what, x in (("block_solve_soa", block_solve.block_solve_soa(M, r)),
                    ("block_inverse_soa", torch.einsum(
                        "ijs,js->is", block_solve.block_inverse_soa(M), r))):
        back = (torch.einsum("ijs,js->is", M, x) - r).abs()
        scale = torch.einsum("ijs,js->is", M.abs(), x.abs()) + r.abs()
        check(bool((back <= 1e-10 * scale).all()),
              f"{what}, Brusselator Newton blocks: |M x - r| reaches "
              f"{(back / scale).max().item()} of |M||x|+|r|")
    del M, r, blocks, x, back, scale
    # the reductions the integrators decide on repeat their bits
    from repro_torch.kernels import vecops
    d = make_vec_inputs(VEC_N[-1], torch.float64, gen, dev, b=VEC_K[-1])
    for fn, args in ((vecops.dot, (d["x"], d["w"])),
                     (vecops.wrms_ss, (d["x"], d["w"])),
                     (vecops.wrms_mask_ss, (d["x"], d["w"], d["m"])),
                     (vecops.dot_prod_multi, (d["x"], d["ys"]))):
        check(torch.equal(fn(*args), fn(*args)),
              f"{fn.__name__}: two runs on one input differ in their bits")
    del d
    compare_misaligned_reductions(gen, dev)
    print(f"kernels: all {len(table)} bodies agree with their plain versions "
          f"(float64 tol 1e-10, float32 1e-4, relative to max(1,|plain|); "
          + ", ".join(k.name for k in table if k.exact) + " bit for bit)",
          flush=True)


def compare_rescale_masks(d, what):
    """Both rebuild entries: inactive lanes copied bit-exactly, and bit
    for bit their plain versions with no system and with every system
    active."""
    import torch
    from repro_torch.kernels import newton
    off = ~d["mask"]
    none, every = torch.zeros_like(d["mask"]), torch.ones_like(d["mask"])
    for name, kern, plain, args in (
            ("history_rescale", newton.history_rescale,
             newton.history_rescale_plain, (d["W"], d["Z"])),
            ("lagrange_rescale", newton.lagrange_rescale,
             newton.lagrange_rescale_plain, (d["eta"], d["q"], d["Z"]))):
        out = kern(*args, d["mask"])
        check(torch.equal(out[:, :, off], d["Z"][:, :, off]),
              f"{name} {what}: inactive lanes not bit-exact")
        check(torch.equal(kern(*args, none), d["Z"]),
              f"{name} {what}: all-inactive copy")
        check(torch.equal(kern(*args, every), plain(*args, every)),
              f"{name} {what}: all active, kernel and plain version differ "
              "in their bits")


def placed(t, off):
    """t's values in a fresh buffer, ``off`` elements past its start: a
    view ``off`` elements from a 16-byte boundary."""
    import torch
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[off:off + t.numel()]
    view.copy_(t)
    return view


def compare_misaligned_reductions(gen, dev):
    """The one-launch reductions (dot, wrms_ss, wrms_mask_ss) on views at
    every offset from a 16-byte boundary, each input at its own: within
    the tolerance of the plain version, and the same bits as on the
    aligned copies of the same values."""
    import torch
    from repro_torch.kernels import vecops
    for dtype in (torch.float64, torch.float32):
        step = 16 // dtype.itemsize
        for n in VEC_N:
            d = make_vec_inputs(n, dtype, gen, dev, b=1)
            for fn, plain, args in (
                    (vecops.dot, vecops.dot_plain, (d["x"], d["ys"][0])),
                    (vecops.wrms_ss, vecops.wrms_ss_plain, (d["x"], d["w"])),
                    (vecops.wrms_mask_ss, vecops.wrms_mask_ss_plain,
                     (d["x"], d["w"], d["m"]))):
                want = fn(*args)
                ref = plain(*args)
                scale = sum_abs(*args) if fn is vecops.dot else \
                    sum_abs(*args, *args)
                tol = TOL[str(dtype)] * scale
                err = abs(want.item() - ref.item())
                check(err <= tol, f"{fn.__name__} n={n} {dtype}: |kernel-"
                      f"plain| {err} > {tol}")
                for shift in range(step):
                    offs = [(shift + i) % step for i in range(len(args))]
                    got = fn(*(placed(a, o) for a, o in zip(args, offs)))
                    check(torch.equal(got, want),
                          f"{fn.__name__} n={n} {dtype}: inputs at offsets "
                          f"{offs} give other bits than aligned "
                          f"({got.item()!r} against {want.item()!r})")
            del d


def phase_timings(table, dev):
    """Each body, its plain version and its library yardstick at the
    shape its path gives it, float64, against its bound."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows, more, inputs = [], [], {}
    for k, shape in [(k, k.timing) for k in table] + [
            (k, shape) for k in table for shape in k.more_timings]:
        key = (k.make.__name__, shape)
        if key not in inputs:
            b, nb = shape
            inputs[key] = k.make(nb, torch.float64, gen, dev, b=b)
        d = inputs[key]
        args = k.args(d)
        out = k.wrapper(*args, **k.kw)
        out = out if isinstance(out, tuple) else (out,)
        moved = nbytes(*args, *out) - k.skipped_bytes(d) + k.index_bytes(d)
        flops = k.flops(d)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(torch.float64)] * 1e3
        row = {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "b": shape[0], "nb": shape[1],
            "ms": time_ms(lambda: k.wrapper(*args, **k.kw), flush),
            "plain_ms": time_ms(lambda: k.plain(*args, **k.kw), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (time_ms(lambda: k.library(d), flush)
                           if k.library is not None else None),
            "bytes": moved, "flops": flops,
        }
        (rows if shape == k.timing else more).append(row)
        print(f"  {k.name:20s} b={row['b']:<2d} nb={row['nb']:<7d} kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  library "
              f"{row['library_ms']}", flush=True)
    # the step's second rescale finds (nearly) every system active: every
    # W is read (or formed)
    for row in rows + more:
        k = next(k for k in table if k.name == row["name"])
        if k.name not in ("history_rescale", "lagrange_rescale"):
            continue
        d = dict(inputs[("make_inputs", (row["b"], row["nb"]))])
        d["mask"] = torch.ones_like(d["mask"])
        args = k.args(d)
        t_bytes = nbytes(*args, d["Z"]) / HBM_BYTES_PER_S * 1e3
        t_ops = k.flops(d) / PEAK_FLOPS[str(torch.float64)] * 1e3
        row["ms_all_active"] = time_ms(lambda: k.wrapper(*args), flush)
        row["bound_ms_all_active"] = max(t_bytes, t_ops)
        row["library_ms_all_active"] = (time_ms(lambda: k.library(d), flush)
                                        if k.library is not None else None)
        print(f"  {k.name}, n={row['b']}, all systems active: kernel "
              f"{row['ms_all_active']:.4f} ms  bound "
              f"{row['bound_ms_all_active']:.4f} ms  library "
              f"{row['library_ms_all_active']}", flush=True)
    del inputs, flush
    return rows, more


def classic_robertson_reference(method):
    """A small input against an independent reference: 256 lanes of the
    classic Robertson problem (k1 = 0.04, k2 = 1e4, k3 = 3e7) through
    ``integrate`` on the card, against scipy's Radau IIA at rtol 1e-12."""
    import numpy as np
    from scipy.integrate import solve_ivp
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    k1, k2, k3 = 0.04, 1e4, 3e7

    def f(t, y):
        a, b, c = y
        return [-k1 * a + k2 * b * c, k1 * a - k2 * b * c - k3 * b * b,
                k3 * b * b]

    def jac(t, y):
        a, b, c = y
        return [[-k1, k2 * c, k2 * b], [k1, -k2 * c - 2 * k3 * b, -k2 * b],
                [0.0, 2 * k3 * b, 0.0]]

    ref = solve_ivp(f, (0.0, 10.0), [1.0, 0.0, 0.0], method="Radau",
                    jac=jac, rtol=1e-12, atol=1e-16).y[:, -1]
    nsys = 256
    rates = {k: np.full(nsys, v) for k, v in (("k1", k1), ("k2", k2),
                                              ("k3", k3))}
    fr, jr, y0 = problems.batched_robertson(nsys, rates=rates)
    sol = ivp.integrate(ivp.IVP(f=fr, jac=jr, y0=y0), 0.0, 10.0, method,
                        opts=ODEOptions(rtol=RTOL, atol=ATOL))
    check(bool(sol.ok.all()), f"reference problem, {method}: a lane failed")
    y = sol.y.cpu().numpy()
    ratio = float((np.abs(y - ref) / (10 * (RTOL * np.abs(ref) + ATOL))).max())
    check(ratio <= 1.0, f"reference problem, {method}: y(10) differs from "
          f"Radau by {ratio} of 10*(rtol*|y|+atol)")
    print(f"reference problem, {method}: y(10) = {y[0].tolist()}, Radau "
          f"{ref.tolist()}, max |dy|/(10*(rtol*|y|+atol)) {ratio:.3g}",
          flush=True)
    return {"radau_y10": ref.tolist(), "port_y10": y[0].tolist(),
            "max_diff_over_bound": ratio}


def check_counts(path, counts, kernel_run):
    """A kernel run launches every body of its path and no plain
    version; a plain run launches nothing."""
    if not kernel_run:
        check(all(v[0] == 0 for v in counts.values()),
              f"{path}: the torch-backend run launched a kernel")
        if "lagrange_rescale" in PATH_KERNELS[path]:
            check(counts["lagrange_rescale"][1] > 0, f"{path}: the plain "
                  "run did not build W (lagrange_rescale_plain)")
        return
    for name in PATH_KERNELS[path]:
        check(counts[name][0] > 0, f"{path}: kernel {name} was never "
              "launched")
    for name, (_, plain_calls) in counts.items():
        check(plain_calls == 0, f"{path}: plain {name} ran {plain_calls} "
              "times")


def run_path(path, label, prob, method, t1, opts, ctx=None, t0=0.0, **kw):
    """One ``integrate`` call from t0 to t1 with the counts zeroed just
    before it and read just after; ``label`` "plain versions" marks the
    plain run (any other, a kernel run); ``ctx`` None is a fresh
    Context."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import batched, ivp
    from repro_torch.core.context import Context
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    batched.reset_loop_counts()
    start = time.perf_counter()
    sol = ivp.integrate(prob, t0, t1, method,
                        ctx=Context() if ctx is None else ctx, opts=opts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = kernels.counts()
    st = sol.stats
    ok = sol.ok if sol.ok is not None else st.success
    rec = {"wall_s": wall, "counts": counts, "loop": dict(batched.loop_counts),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "lanes": int(ok.numel()), "lanes_ok": int(ok.sum())}
    for k in ("steps", "attempts", "nni", "nsetups", "netf"):
        v = getattr(st, k)
        if v is not None:
            rec[k] = {"sum": int(v.sum()), "max": int(v.max())}
    # the Krylov solvers' totals (one global iteration for all systems)
    krylov = {k: int(getattr(sol, k)) for k in ("nli", "npsolves", "npsetups")
              if getattr(sol, k) is not None}
    rec.update(krylov)
    print(f"{path} [{label}]: wall {wall:.3f} s, host syncs "
          f"{rec['loop']['host_syncs']}, step trips "
          f"{rec['loop']['step_trips']}, Newton trips "
          f"{rec['loop']['newton_trips']}, Krylov trips "
          f"{rec['loop']['krylov_trips']}, lanes ok {rec['lanes_ok']}/"
          f"{rec['lanes']}, peak {rec['peak_bytes'] / 2**20:.1f} MiB, "
          + ", ".join(f"{k} sum {v['sum']} max {v['max']}"
                      for k, v in rec.items() if isinstance(v, dict)
                      and "sum" in v)
          + "".join(f", {k} {v}" for k, v in krylov.items()), flush=True)
    check_counts(path, counts, label != "plain versions")
    check(rec["lanes_ok"] == rec["lanes"],
          f"{path} [{label}]: {rec['lanes'] - rec['lanes_ok']} lanes failed")
    check(bool(torch.isfinite(sol.y).all()), f"{path}: non-finite y")
    return sol, rec


def agree(path, y, ref, retcodes=None, ref_retcodes=None, mass=False, C=10):
    """Kernel run against plain run: equal retcodes, y within
    C*(rtol*|y|+atol); optionally y1+y2+y3 = 1 within 10*rtol."""
    import torch
    if retcodes is not None:
        check(torch.equal(retcodes, ref_retcodes), f"{path}: retcodes differ")
    bound = C * (RTOL * ref.abs() + ATOL)
    ratio = ((y - ref).abs() / bound).max().item()
    check(ratio <= 1.0, f"{path}: y differs from the plain run by {ratio} "
          f"of {C}*(rtol*|y|+atol)")
    out = {"max_diff_over_bound": ratio}
    if mass:
        out["mass_drift"] = (y.sum(dim=1) - 1.0).abs().max().item()
        check(out["mass_drift"] <= 10 * RTOL,
              f"{path}: y1+y2+y3 drifts from 1 by {out['mass_drift']}")
    print(f"{path} agrees with the plain run: "
          + ", ".join(f"{k} {v:.3g}" for k, v in out.items()), flush=True)
    return out


def robertson_problem(nsys, rates):
    from repro_torch.core import ivp, problems
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates)
    f_soa, jac_soa = problems.batched_robertson_soa(nsys, rates=rates)
    return ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa)


def phase_main_path(profile):
    """The ensemble-BDF main path, 2**20 Robertson systems."""
    from repro_torch.core import problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    path = "ensemble_bdf"
    prob = robertson_problem(NSYS, problems.robertson_rates(NSYS, seed=0))
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    sol, rec = run_path(path, "kernels", prob, "ensemble_bdf", 10.0, opts)
    check(sol.y.shape == (NSYS, 3), "misshapen y")
    ref, ref_rec = run_path(path, "plain versions", prob, "ensemble_bdf",
                            10.0, opts._replace(
                                policy=ExecPolicy(backend="torch")))
    agreement = agree(path, sol.y, ref.y, sol.retcodes, ref.retcodes,
                      mass=True)
    y = sol.y
    del sol, ref
    prof = None
    if profile:
        prof = profile_run(path, integrate_call(prob, "ensemble_bdf", 10.0,
                                                opts), rec["wall_s"], True)
        prof["lagrange_alone_ms"] = lagrange_alone_ms()
    return {"kernels_run": rec, "plain_run": ref_rec,
            "agreement": agreement, "profile": prof, "y": y}


def run_leg(path, label, ctx, prob, t_span, opts, summarise=False, **kw):
    """One leg of path L: :func:`run_path` with the path's context
    (telemetry, profiler and logger on), then Robertson's mass, and the
    leg's ring reconciled exactly, per lane, with its counters.
    ``summarise`` adds the ring's ``summary()``; the ring itself does not
    outlive the call (36 B a system a slot)."""
    import torch
    sol, rec = run_path(path, label, prob, "ensemble_bdf", t_span[1], opts,
                        ctx=ctx, t0=t_span[0], **kw)
    st, tel = sol.stats, sol.telemetry
    rec["timings"] = sol.timings
    rec["mass_drift"] = (sol.y.sum(dim=1) - 1.0).abs().max().item()
    check(rec["mass_drift"] <= 10 * RTOL, f"{path} [{label}]: y1+y2+y3 "
          f"drifts from 1 by {rec['mass_drift']}")
    check(tel.t.device.type == "cuda", f"{path} [{label}]: the ring lies "
          f"on {tel.t.device}")
    check(not tel.truncated, f"{path} [{label}]: the ring wrapped "
          f"({tel.total_records} records in {tel.capacity} slots)")
    for name, got, want in (("steps", tel.steps(), st.steps),
                            ("attempts", tel.attempts(), st.attempts),
                            ("nni", tel.newton_iters_total(), st.nni),
                            ("nsetups", tel.lsetups(), st.nsetups)):
        check(torch.equal(got.to(want.dtype), want), f"{path} [{label}]: "
              f"the ring's {name} differ from the Solution's")
    if summarise:
        rec["telemetry_summary"] = tel.summary()
    return sol._replace(telemetry=None), rec


def phase_path_l(y_main, main_syncs, profile):
    """Path L, coupled legs: the main path's problem integrated as a
    reacting-flow code calls it once a coupling step, through one
    Context with telemetry, profiler and logger on.  y0 is made on the
    host and moved by ``ctx.memory``; leg 1 to t = 10 (timed, exporting
    a session), leg 2 to t = 20 warm from it (twice from one handle),
    cold from leg 1's y, and plain versions warm; the final y goes back
    to the host through ``ctx.memory``."""
    import numpy as np
    import torch
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.context import Context
    from repro_torch.core.memory import MemoryType
    from repro_torch.core.policies import ExecPolicy
    from repro_torch.observability import (MetricsRegistry,
                                           ObservabilityConfig,
                                           context_metrics)
    path = "L: coupled legs"
    rates = problems.robertson_rates(NSYS, seed=0)
    f, jac, _ = problems.batched_robertson(NSYS, rates=rates)
    f_soa, jac_soa = problems.batched_robertson_soa(NSYS, rates=rates)

    def prob(y):
        return ivp.IVP(f=f, jac=jac, y0=y, f_soa=f_soa, jac_soa=jac_soa)

    ctx = Context(observability=ObservabilityConfig(
        profile=True, log_level="INFO", telemetry=True,
        telemetry_capacity=L_RING))
    mem = ctx.memory
    y0_host = np.zeros((NSYS, 3))
    y0_host[:, 0] = 1.0
    y0 = mem.copy(mem.alloc((NSYS, 3), torch.float64, MemoryType.DEVICE),
                  mem.wrap(torch.from_numpy(y0_host), MemoryType.HOST)).data
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    legs = {}
    sol1, legs["leg1"] = run_leg(
        path, "leg 1", ctx, prob(y0), L_LEG1, opts, summarise=True,
        return_session=True, timed=True)
    spans = [s.name for s in ctx.profiler.spans]
    check(spans == ["integrate.build", "integrate.execute"],
          f"{path}: leg 1's profiler spans are {spans}")
    check(torch.equal(sol1.y, y_main), f"{path}: leg 1 is not the main "
          "path's kernel run bit for bit")
    check(legs["leg1"]["loop"]["host_syncs"] == main_syncs,
          f"{path}: leg 1 made {legs['leg1']['loop']['host_syncs']} host "
          f"syncs with telemetry on, the main path {main_syncs}")
    summary = legs["leg1"]["telemetry_summary"]
    sess, y1 = sol1.session, sol1.y
    before = [x.clone() for x in sess]
    warm, legs["leg2 warm"] = run_leg(
        path, "leg 2 warm", ctx, prob(y1), L_LEG2, opts, session=sess)
    warm2, legs["leg2 warm again"] = run_leg(
        path, "leg 2 warm again", ctx, prob(y1), L_LEG2, opts, session=sess)
    check(all(torch.equal(a, b) for a, b in zip(before, sess)),
          f"{path}: the call changed the caller's session")
    check(torch.equal(warm.y, warm2.y) and torch.equal(
        warm.stats.steps, warm2.stats.steps),
        f"{path}: two warm legs from one session differ")
    del warm2, before
    cold, legs["leg2 cold"] = run_leg(path, "leg 2 cold", ctx, prob(y1),
                                         L_LEG2, opts)
    plain, legs["leg2 plain"] = run_leg(
        path, "plain versions", ctx, prob(y1), L_LEG2,
        opts._replace(policy=ExecPolicy(backend="torch")), session=sess)
    agreement = agree(path, warm.y, plain.y, warm.retcodes, plain.retcodes,
                      mass=True)
    warm_vs_cold = ((warm.y - cold.y).abs() /
                    (RTOL * cold.y.abs() + ATOL)).max().item()
    agreement["warm_vs_cold_max_over_tol"] = warm_vs_cold
    print(f"{path}: leg 2 steps warm {legs['leg2 warm']['steps']['sum']} "
          f"against cold {legs['leg2 cold']['steps']['sum']}; max |y_warm - "
          f"y_cold|/(rtol*|y_cold|+atol) {warm_vs_cold:.3g}", flush=True)
    y_host = mem.copy(mem.alloc((NSYS, 3), torch.float64, MemoryType.HOST),
                      mem.wrap(warm.y, MemoryType.DEVICE)).data
    check(torch.equal(y_host.to(warm.y.device), warm.y),
          f"{path}: the host copy of y differs")
    stats = dict(mem.stats)
    check(stats["copies_h2d"] == 1 and stats["copies_d2h"] == 1
          and stats["copy_bytes"] == 2 * NSYS * 3 * 8,
          f"{path}: memory helper stats {stats}")
    calls = len(legs)
    done = [e for e in ctx.logger.events if e["event"] == "integrate.done"]
    failed = [e for e in ctx.logger.events
              if e["event"] == "integrate.lane_failed"]
    check(len(done) == calls and not failed,
          f"{path}: {len(done)} integrate.done and {len(failed)} "
          f"integrate.lane_failed events for {calls} calls")
    reg = MetricsRegistry()
    context_metrics(reg, ctx)
    check(f"repro_context_integrations_total {calls}" in reg.render(),
          f"{path}: the metrics do not count {calls} integrations")
    print(f"{path}: memory helper {stats}; leg 1 timings "
          f"{legs['leg1']['timings']}; telemetry of leg 1: order occupancy "
          f"{summary['order_occupancy']}, log10 h histogram "
          f"{summary['h_hist_log10']}", flush=True)
    kernels_run = {"counts": {
        name: (sum(legs[k]["counts"][name][0] for k in legs
                   if k != "leg2 plain"), 0)
        for name in legs["leg1"]["counts"]}}
    prof = None
    if profile:
        prof = profile_run(path, integrate_call(
            prob(y1), "ensemble_bdf", L_LEG2[1], opts, {"session": sess},
            t0=L_LEG2[0], obs=ctx.observability),
            legs["leg2 warm"]["wall_s"], True)
    del warm, cold, plain, sol1, sess
    return {"legs": legs, "kernels_run": kernels_run,
            "agreement": agreement, "memory_stats": stats,
            "profiler": ctx.profiler.summary(), "profile": prof}


def m_server(ctx):
    """Path M's server: Robertson (n = 3) and the decay chain (n = 6),
    ``ensemble_bdf`` with the default ``BlockDiagGJ()`` on ``ctx``."""
    from repro_torch.core import problems
    from repro_torch.serve.solver import ProblemFamily, SolverServer
    fr, fd = problems.robertson_family(), problems.decay_chain_family(6)
    return SolverServer(
        [ProblemFamily("robertson", 3, *fr), ProblemFamily("decay6", 6, *fd)],
        ctx=ctx, bucket_sizes=M_BUCKETS, max_batch=M_BUCKETS[-1],
        max_wait=2e-3, max_depth=1 << 18)


class GcClock:
    """The seconds Python's cyclic garbage collector ran, and its full
    (generation 2) collections, since it was made (a ``gc.callbacks``
    hook; :meth:`close` removes it)."""

    def __init__(self):
        self.s, self.full, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._hook)

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.full += info["generation"] == 2
            self._t0 = None

    def close(self):
        gc.callbacks.remove(self._hook)


class BundleProbe:
    """Wraps a server's ``_execute``, ``_assemble`` and ``_run_compiled``
    (instance attributes, as ``failing_executions`` does) and records
    each bundle: family, live and padded lanes, the kernel launch counts
    (set to 0 just before the bundle's run, read just after it), the
    host syncs of the bundle (the integrator's loops and the server's own
    reads, all through ``loops.read``), and the walls of the whole
    bundle, of ``_assemble``, of the run, of resolving its futures (from
    the run's end to the bundle's end), and of the garbage collector's
    runs inside the bundle (``gcc``, a :class:`GcClock`)."""

    def __init__(self, server, gcc):
        from repro_torch import kernels
        from repro_torch.core import batched
        self.rows = []
        self.bundle = None      # the last bundle executed
        run0, asm0, exe0 = (server._run_compiled, server._assemble,
                            server._execute)
        self.assemble = asm0

        def assemble(bundle):
            t = time.perf_counter()
            out = asm0(bundle)
            self.cur["assemble_s"] = time.perf_counter() - t
            return out

        def run(entry, sess, tfa, params):
            kernels.reset_counts()
            t = time.perf_counter()
            out = run0(entry, sess, tfa, params)
            self.cur["run_end"] = time.perf_counter()
            self.cur["run_s"] = self.cur["run_end"] - t
            self.cur["counts"] = kernels.counts()
            return out

        def execute(bundle):
            self.bundle = bundle
            self.cur = {"family": bundle.key.family, "live": bundle.live,
                        "nsys": bundle.nsys}
            batched.reset_loop_counts()
            gc0, full0 = gcc.s, gcc.full
            t = time.perf_counter()
            exe0(bundle)
            end = time.perf_counter()
            self.cur.update(wall_s=end - t,
                            resolve_s=end - self.cur.pop("run_end"),
                            gc_s=gcc.s - gc0, gc_full=gcc.full - full0,
                            loop=dict(batched.loop_counts))
            self.rows.append(self.cur)

        server._assemble, server._run_compiled, server._execute = (
            assemble, run, execute)

    def take(self):
        rows, self.rows = self.rows, []
        return rows


def m_assemble_ab(path, card, assemble, bundle):
    """``_assemble`` of the warm bundle as the server does it (its warm
    lanes gathered with one ``index_select`` a leaf from the burst
    bundle's session) against the same with every warm lane joined by
    ``concat``, the reference's construction: walls in the order
    gather, concat, gather, concat, and the two sessions equal bit for
    bit."""
    import torch
    from repro_torch.core.batched import SolverSession
    from repro_torch.serve.solver import server as server_mod
    gather = server_mod._join_warm

    def concat_only(sessions, dev):
        return (SolverSession.concat([SolverSession(*(x.to(dev) for x in s))
                                      for s in sessions]),
                list(range(len(sessions))))

    walls, outs = {"gather": [], "concat": []}, {}
    try:
        for name in ("gather", "concat", "gather", "concat"):
            server_mod._join_warm = gather if name == "gather" \
                else concat_only
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs[name] = assemble(bundle)[0]
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t)
    finally:
        server_mod._join_warm = gather
    check(all(torch.equal(a, b) for a, b in zip(outs["gather"],
                                                outs["concat"])),
          f"{path}: the gathered warm session differs from the concat one")
    us = {k: [1e6 * w / bundle.live for w in v] for k, v in walls.items()}
    print(f"{path} [warm _assemble] on {card}: {bundle.live} warm lanes, "
          f"gather {', '.join(f'{w:.3f} s ({u:.2f} us/request)' for w, u in zip(walls['gather'], us['gather']))}; "
          f"concat only {', '.join(f'{w:.3f} s ({u:.2f} us/request)' for w, u in zip(walls['concat'], us['concat']))}; "
          f"sessions bit for bit equal", flush=True)
    return {"walls_s": walls, "us_per_request": us}


def m_submit(srv, gcc, family, y0, span, params, warm=None):
    """Submit one request a params entry (``warm``: a ``(y, session)``
    pair a request, the continuation); returns ``(futures, seconds,
    garbage-collector seconds)``."""
    gc0 = gcc.s
    t = time.perf_counter()
    futs = [srv.submit(family, y0 if warm is None else warm[i][0],
                       span[0], span[1], rtol=RTOL, atol=ATOL, params=p,
                       session=None if warm is None else warm[i][1])
            for i, p in enumerate(params)]
    return futs, time.perf_counter() - t, gcc.s - gc0


def m_stacked(sols, name):
    """One tensor of the lanes' ``name`` field (device views, stacked)."""
    import torch
    return torch.stack([getattr(s, name) for s in sols])


def m_agree(path, what, sols, ref_y, ref_st, mass):
    """Served lanes against a direct ``integrate`` of the same systems:
    equal per-lane steps, nni and retcodes, y within
    10*(rtol*|y|+atol); whether they are equal bit for bit."""
    import torch
    y = m_stacked(sols, "y")
    for name in ("steps", "nni", "retcodes"):
        got = torch.stack([getattr(s.stats, name) for s in sols])
        check(torch.equal(got, getattr(ref_st, name)),
              f"{path}: {what}: per-lane {name} differ from the direct run")
    out = agree(f"{path} ({what})", y, ref_y, mass=mass)
    out["bit_equal"] = bool(torch.equal(y, ref_y))
    print(f"{path} ({what}): per-lane steps, nni and retcodes equal; bit for "
          f"bit equal to the direct run: {out['bit_equal']}", flush=True)
    return out


def m_all_ok(path, what, sols):
    """Every request succeeded with retcode 0 (one read)."""
    import torch
    ok = torch.stack([m_stacked(sols, "success"), m_stacked(sols, "ok"),
                      m_stacked(sols, "retcodes") == 0])
    check(bool(ok.all()), f"{path}: {what}: a request did not succeed")


def m_check_bundles(path, rows, kernel_run):
    """Every bundle of a kernel server launched each of the path's
    kernels and no plain version; a plain server's launched none."""
    for r in rows:
        where = f"{path}: {r['family']} bundle of {r['live']}/{r['nsys']}"
        if kernel_run:
            for name in PATH_KERNELS[path]:
                check(r["counts"][name][0] > 0,
                      f"{where}: kernel {name} was never launched")
            for name, (_, calls) in r["counts"].items():
                check(calls == 0, f"{where}: plain {name} ran {calls} times")
        else:
            check(all(v[0] == 0 for v in r["counts"].values()),
                  f"{where}: the plain-version server launched a kernel")


def m_leg(path, card, name, rows, submitted=None):
    """A leg's record; prints each bundle's wall, host syncs and
    per-request host costs, and the submit cost a request."""
    leg = {"bundles": rows}
    for r in rows:
        r["assemble_us_per_request"] = 1e6 * r["assemble_s"] / r["live"]
        r["resolve_us_per_request"] = 1e6 * r["resolve_s"] / r["live"]
        print(f"{path} [{name}] on {card}: {r['family']} bundle "
              f"{r['live']}/{r['nsys']} lanes: wall {r['wall_s']:.3f} s "
              f"(run {r['run_s']:.3f} s), host syncs "
              f"{r['loop']['host_syncs']}, step trips "
              f"{r['loop']['step_trips']}, assemble "
              f"{r['assemble_us_per_request']:.2f} us/request, resolve "
              f"{r['resolve_us_per_request']:.2f} us/request; garbage "
              f"collector {r['gc_s']:.3f} s of the bundle ({r['gc_full']} "
              f"full)", flush=True)
    if submitted is not None:
        n, s, gc_s = submitted
        leg.update(requests=n, submit_s=s, submit_gc_s=gc_s)
        print(f"{path} [{name}] on {card}: submit {1e6 * s / n:.2f} "
              f"us/request over {n} requests (garbage collector "
              f"{1e6 * gc_s / n:.2f} us/request)", flush=True)
    return leg


def phase_path_m(card, profile):
    """Path M, the serving tier on the card: a burst of 2**17 Robertson
    and 16000 decay-chain requests, a warm leg of 2**16, the async
    facade, a plain-version server, and the chaos sub-phase.  Each
    leg's responses are released once its gates have read them (a
    client consumes its results): held, their ~20 tensor views a request
    make the garbage collector's full passes longer."""
    path = "M: serving"
    t_phase = time.perf_counter()
    gcc = GcClock()
    try:
        rec = phase_path_m_legs(path, card, gcc, profile)
    finally:
        gcc.close()
    rec["served_s"] = time.perf_counter() - t_phase

    # chaos on the card, the kernels
    from repro_torch.testing.chaos import run_core_chaos, run_serving_chaos
    t = time.perf_counter()
    chaos = []
    try:
        # the reference's retcodes: -4 for nan, -3 or -4 for divergent
        for mode, allowed in (("nan", {"CONV_FAILURE"}),
                              ("divergent", {"ERR_FAILURE", "CONV_FAILURE"})):
            r = run_core_chaos(M_CHAOS_NSYS, M_CHAOS_K, mode=mode)
            chaos.append(r)
            check(set(r["retcodes"].values()) <= allowed and
                  r["failed"] == M_CHAOS_K and r["bitwise_checked"],
                  f"{path}: core chaos ({mode}): {r}")
        chaos.append(run_serving_chaos(M_CHAOS_REQUESTS, M_CHAOS_FAULTS, 16,
                                       bucket=M_CHAOS_BUCKET))
    except AssertionError as exc:
        raise RuntimeError(f"{path}: chaos on the card: {exc}") from None
    rec["chaos"] = chaos
    rec["chaos_s"] = time.perf_counter() - t
    print(f"{path} chaos on {card}: core nan {chaos[0]['retcodes']}, core "
          f"divergent {chaos[1]['retcodes']} (healthy lanes bit for bit the "
          f"clean run), serving {chaos[2]['failures_by_reason']}, degraded "
          f"bundles {chaos[2]['degraded_bundles']}; {rec['chaos_s']:.1f} s",
          flush=True)
    print(f"{path} on {card}: served legs {rec['served_s']:.1f} s, chaos "
          f"{rec['chaos_s']:.1f} s", flush=True)
    return rec


def phase_path_m_legs(path, card, gcc, profile):
    """Path M's served legs (see :func:`phase_path_m`)."""
    import numpy as np
    import torch
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.batched import SolverSession
    from repro_torch.core.context import Context
    from repro_torch.core.policies import ExecPolicy
    rates = problems.robertson_rates(M_ROB, seed=0)
    cols = [rates[k].tolist() for k in ("k1", "k2", "k3")]
    rob_params = [{"k1": a, "k2": b, "k3": c} for a, b, c in zip(*cols)]
    kdec = np.random.default_rng(1).uniform(0.1, 5.0, size=(M_DECAY, 6))
    dec_params = [{"k": k} for k in kdec]
    y_rob, y_dec = np.array([1.0, 0.0, 0.0]), np.ones(6)
    srv = m_server(Context())
    probe = BundleProbe(srv, gcc)
    rec = {"legs": {}, "agreement": {}}

    # 1. the burst: two full Robertson bundles, one padded decay bundle
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rob, s1, g1 = m_submit(srv, gcc, "robertson", y_rob, (0.0, 10.0),
                           rob_params)
    dec, s2, g2 = m_submit(srv, gcc, "decay6", y_dec, (0.0, 1.0), dec_params)
    t = time.perf_counter()
    srv.drain()
    rob = [f.result() for f in rob]
    dec = [f.result() for f in dec]
    burst = m_leg(path, card, "burst", probe.take(),
                  (M_ROB + M_DECAY, s1 + s2, g1 + g2))
    burst.update(wall_s=time.perf_counter() - t,
                 peak_bytes=torch.cuda.max_memory_allocated())
    rec["legs"]["burst"] = burst
    made = sorted((r["family"], r["live"], r["nsys"])
                  for r in burst["bundles"])
    full = M_BUCKETS[-1]
    check(made == [("decay6", M_DECAY, srv.queue.pad_to(M_DECAY))]
          + [("robertson", full, full)] * (M_ROB // full),
          f"{path}: the burst made the bundles {made}")
    m_all_ok(path, "burst", rob + dec)

    # 2. padding changes no lane: a direct kernel run of the same systems
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    direct, _ = run_path(path, "direct kernels, Robertson",
                         robertson_problem(M_ROB, rates), "ensemble_bdf",
                         10.0, opts)
    rec["agreement"]["burst_robertson"] = m_agree(
        path, "burst Robertson", rob, direct.y, direct.stats, True)
    dev = rob[0].y.device
    fd = problems.decay_chain_family(6)
    pk = {"k": torch.from_numpy(kdec).to(dev)}
    dprob = ivp.IVP(f=lambda t, y: fd[0](t, y, pk),
                    jac=lambda t, y: fd[1](t, y, pk),
                    f_soa=lambda t, y: fd[2](t, y, pk),
                    jac_soa=lambda t, y: fd[3](t, y, pk),
                    y0=torch.ones((M_DECAY, 6), dtype=torch.float64,
                                  device=dev))
    ddirect, _ = run_path(path, "direct kernels, decay chain", dprob,
                          "ensemble_bdf", 1.0, opts)
    rec["agreement"]["burst_decay6"] = m_agree(
        path, f"burst decay chain, padded to {srv.queue.pad_to(M_DECAY)}",
        dec, ddirect.y, ddirect.stats, False)
    # what the later legs need of the burst: the plain server's
    # comparison, and the warm leg's (y, session) a request
    kept = {"rob_y": m_stacked(rob[:M_PLAIN], "y"),
            "rob_rc": m_stacked(rob[:M_PLAIN], "retcodes"),
            "dec_y": m_stacked(dec, "y"), "dec_rc": m_stacked(dec, "retcodes")}
    warm_src = [(s.y, s.session) for s in rob[:M_WARM]]
    del direct, ddirect, rob, dec

    # 3. the warm leg: the burst's first 2**16 requests, with sessions
    warm, s1, g1 = m_submit(srv, gcc, "robertson", None, (10.0, 20.0),
                            rob_params[:M_WARM], warm=warm_src)
    t = time.perf_counter()
    srv.drain()
    warm = [f.result() for f in warm]
    leg = m_leg(path, card, "warm", probe.take(), (M_WARM, s1, g1))
    leg["wall_s"] = time.perf_counter() - t
    rec["legs"]["warm"] = leg
    m_all_ok(path, "warm leg", warm)
    rec["warm_assemble"] = m_assemble_ab(path, card, probe.assemble,
                                         probe.bundle)
    probe.bundle = None
    sess = SolverSession.concat([s for _, s in warm_src])
    y10 = torch.stack([y for y, _ in warm_src])
    del warm_src
    prob10 = dataclasses.replace(robertson_problem(
        M_WARM, {k: v[:M_WARM] for k, v in rates.items()}), y0=y10)
    wdirect, _ = run_path(path, "direct kernels, warm", prob10,
                          "ensemble_bdf", 20.0, opts, t0=10.0, session=sess)
    rec["agreement"]["warm"] = m_agree(path, "warm leg", warm, wdirect.y,
                                       wdirect.stats, True)
    cold, _ = run_path(path, "direct kernels, cold from y(10)", prob10,
                       "ensemble_bdf", 20.0, opts, t0=10.0)
    rec["warm_vs_cold_steps"] = {
        "warm": int(torch.stack([s.stats.steps for s in warm]).sum()),
        "cold": int(cold.stats.steps.sum())}
    print(f"{path}: warm leg steps {rec['warm_vs_cold_steps']['warm']} "
          f"against a cold leg's {rec['warm_vs_cold_steps']['cold']} (the "
          f"same {M_WARM} systems, t in [10, 20])", flush=True)
    del wdirect, cold, sess, y10, prob10, warm

    # 4. the async facade
    t = time.perf_counter()
    with srv:
        afut, s1, g1 = m_submit(srv, gcc, "robertson", y_rob, (0.0, 10.0),
                                rob_params[:M_ASYNC[0]])
        dfut, s2, g2 = m_submit(srv, gcc, "decay6", y_dec, (0.0, 1.0),
                                dec_params[:M_ASYNC[1]])
        asol = [f.result(timeout=300) for f in afut + dfut]
    leg = m_leg(path, card, "async", probe.take(),
                (sum(M_ASYNC), s1 + s2, g1 + g2))
    leg["wall_s"] = time.perf_counter() - t
    rec["legs"]["async"] = leg
    m_all_ok(path, "async leg", asol)
    del asol, afut, dfut
    prom = srv.metrics_prometheus()
    m = srv.metrics()
    rec["metrics"] = m
    check(m["failures"] == {} and m["degraded"] == 0,
          f"{path}: failures {m['failures']}, degraded {m['degraded']}")
    for key in ("requests", "bundles", "live_lanes", "padded_lanes",
                "rejected", "steady_misses", "degraded"):
        check(f"repro_serve_{key}_total {m[key]}\n" in prom,
              f"{path}: the scrape's repro_serve_{key}_total is not "
              f"metrics()['{key}'] = {m[key]}")
    tc = m["trace_cache"]
    check(f"repro_trace_cache_misses_total {tc['misses']}\n" in prom and
          f"repro_trace_cache_hits_total {tc['hits']}\n" in prom,
          f"{path}: the scrape's trace-cache counters are not {tc}")
    keys = len(srv.cache.keys())
    check(tc["misses"] == keys and tc["evictions"] == 0
          and m["steady_misses"] == 0,
          f"{path}: cache {tc} over {keys} distinct keys, steady misses "
          f"{m['steady_misses']}")
    kernel_rows = [r for lg in rec["legs"].values() for r in lg["bundles"]]
    m_check_bundles(path, kernel_rows, True)
    for fam, b in (("robertson", 3), ("decay6", 6)):
        check(any(r["family"] == fam for r in kernel_rows),
              f"{path}: no bundle at b = {b}")
    rec["kernels_run"] = {"counts": {
        name: (sum(r["counts"][name][0] for r in kernel_rows), 0)
        for name in kernel_rows[0]["counts"]}}
    print(f"{path} on {card}: {m['requests']} requests in {m['bundles']} "
          f"bundles, occupancy {m['occupancy']:.4f}, latency p50 "
          f"{m['latency_p50_s']:.4f} s p99 {m['latency_p99_s']:.4f} s, "
          f"bundle cache {tc}, peak (burst) "
          f"{burst['peak_bytes'] / 2**20:.1f} MiB", flush=True)
    if profile:
        # one more full Robertson bundle, its drain profiled (after the
        # gates: its requests are not in the metrics above)
        futs, _, _ = m_submit(srv, gcc, "robertson", y_rob, (0.0, 10.0),
                              rob_params[:M_WARM])
        rec["profile"] = profile_run(path, srv.drain,
                                     burst["bundles"][0]["wall_s"], True)
        probe.take()
        del futs
    del srv, probe

    # 5. the plain versions: a second server on the burst's first
    # Robertson requests and its decay-chain requests
    psrv = m_server(Context(policy=ExecPolicy(backend="torch")))
    pprobe = BundleProbe(psrv, gcc)
    prob_f, s1, g1 = m_submit(psrv, gcc, "robertson", y_rob, (0.0, 10.0),
                              rob_params[:M_PLAIN])
    pdec_f, s2, g2 = m_submit(psrv, gcc, "decay6", y_dec, (0.0, 1.0),
                              dec_params)
    t = time.perf_counter()
    psrv.drain()
    leg = m_leg(path, card, "plain versions", pprobe.take(),
                (M_PLAIN + M_DECAY, s1 + s2, g1 + g2))
    leg["wall_s"] = time.perf_counter() - t
    rec["legs"]["plain"] = leg
    m_check_bundles(path, leg["bundles"], False)
    for what, futs, key, mass in (("Robertson", prob_f, "rob", True),
                                  ("decay chain", pdec_f, "dec", False)):
        psols = [f.result() for f in futs]
        rec["agreement"][f"plain_{key}"] = agree(
            f"{path} (plain-version server, {what})", kept[f"{key}_y"],
            m_stacked(psols, "y"), kept[f"{key}_rc"],
            m_stacked(psols, "retcodes"), mass=mass)
    return rec


def phase_path_a(profile):
    """Path A: ensemble DIRK (SDIRK2) on the main path's 2**20 systems;
    the plain run covers the first NSUB lanes, which are independent of
    the rest."""
    from repro_torch.core import problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    path, method = "A: ensemble_dirk", "ensemble_dirk:sdirk2"
    rates = problems.robertson_rates(NSYS, seed=0)
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    prob = robertson_problem(NSYS, rates)
    sol, rec = run_path(path, "kernels", prob, method, 10.0, opts)
    check(sol.y.shape == (NSYS, 3), "misshapen y")
    sub = {k: v[:NSUB] for k, v in rates.items()}
    ref, ref_rec = run_path(path, "plain versions",
                            robertson_problem(NSUB, sub), method, 10.0,
                            opts._replace(policy=ExecPolicy(backend="torch")))
    agreement = agree(path, sol.y[:NSUB], ref.y, sol.retcodes[:NSUB],
                      ref.retcodes)
    mass = (sol.y.sum(dim=1) - 1.0).abs().max().item()
    check(mass <= 10 * RTOL, f"{path}: y1+y2+y3 drifts from 1 by {mass}")
    agreement["mass_drift_all_lanes"] = mass
    print(f"{path}: mass drift over all {NSYS} lanes {mass:.3g}", flush=True)
    del sol, ref
    prof = profile_run(path, integrate_call(prob, method, 10.0, opts),
                       rec["wall_s"]) if profile else None
    return {"kernels_run": rec, "plain_run": ref_rec,
            "agreement": agreement, "profile": prof,
            "reference": classic_robertson_reference(method)}


def phase_brusselator(path, method, t1, kw, profile, sparsity=False, C=10,
                      per_newton=(), keep_y=False):
    """Paths B-F and K: the Brusselator ensemble (with its
    ``jac_sparsity`` for D-F), kernel run and a plain run over the same
    systems; y held to C*(rtol*|y|+atol).  The kernels ``per_newton``
    must launch once a Newton iteration of the kernel run; ``keep_y``
    returns its final state under "y"."""
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    f, jac, P, y0 = problems.ensemble_brusselator(NBRUSS, nx=NX)
    f_soa, jac_soa = problems.ensemble_brusselator_soa(NBRUSS, nx=NX)
    prob = ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa,
                   jac_sparsity=P if sparsity else None)
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    sol, rec = run_path(path, "kernels", prob, method, t1, opts, **kw)
    check(sol.y.shape == (NBRUSS, 2 * NX), "misshapen y")
    for name in per_newton:
        launched, trips = rec["counts"][name][0], rec["loop"]["newton_trips"]
        check(launched == trips, f"{path}: {name} launched {launched} times "
              f"in {trips} Newton iterations")
    ref, ref_rec = run_path(path, "plain versions", prob, method, t1,
                            opts._replace(policy=ExecPolicy(backend="torch")),
                            **kw)
    agreement = agree(path, sol.y, ref.y, sol.retcodes, ref.retcodes, C=C)
    y = sol.y if keep_y else None
    del sol, ref
    prof = profile_run(path, integrate_call(prob, method, t1, opts, kw),
                       rec["wall_s"], method == "ensemble_bdf") \
        if profile else None
    out = {"kernels_run": rec, "plain_run": ref_rec, "agreement": agreement,
           "profile": prof}
    if keep_y:
        out["y"] = y
    return out


def integrate_call(prob, method, t1, opts, kw=None, t0=0.0, obs=None):
    """A kernel run of an ``integrate`` path, for :func:`profile_run`
    (``obs``: the context's ObservabilityConfig)."""
    from repro_torch.core import ivp
    from repro_torch.core.context import Context
    ctx_kw = {} if obs is None else {"observability": obs}
    return lambda: ivp.integrate(prob, t0, t1, method, ctx=Context(**ctx_kw),
                                 opts=opts, **(kw or {}))


def agree_wrms(path, y, ref, rtol, atol, what="the plain run", limit=1.0,
               C=10, gate_max=False):
    """One large system against another run of it: the WRMS norm of
    the difference, weighted by 1/(rtol*|y|+atol), within ``limit`` (the
    norm the integrator's error test controls); and the max-norm ratio
    |dy|/(C*(rtol*|y|+atol)), within 1 where ``gate_max``, else printed
    with the entries past it."""
    import torch
    e = (y - ref).abs() / (rtol * ref.abs() + atol)
    out = {"wrms_diff": torch.sqrt((e * e).mean()).item(),
           "max_diff_over_bound": e.max().item() / C,
           "entries_over_bound": int((e > C).sum())}
    print(f"{path} against {what}: WRMS of the difference "
          f"{out['wrms_diff']:.3g} (gate {limit}); max |dy|/({C}*(rtol*|y|+"
          f"atol)) {out['max_diff_over_bound']:.3g} "
          f"({'gate 1' if gate_max else 'printed'}), "
          f"{out['entries_over_bound']} of {e.numel()} entries past it",
          flush=True)
    check(out["wrms_diff"] <= limit, f"{path}: y differs from {what} by "
          f"{out['wrms_diff']} in the WRMS norm, more than {limit}")
    if gate_max:
        check(out["max_diff_over_bound"] <= 1.0, f"{path}: y differs from "
              f"{what} by {out['max_diff_over_bound']} of {C}*(rtol*|y|+"
              "atol)")
    return out


APP_COUNTERS = ("steps", "attempts", "nni", "netf", "ncfn")


def same_counters(path, rec, ref_rec, what):
    """Two runs of one solve take the same steps: every counter equal."""
    print(f"{path}: kernel run / {what}: " + ", ".join(
        f"{k} {rec[k]}/{ref_rec[k]}" for k in APP_COUNTERS), flush=True)
    check(all(rec[k] == ref_rec[k] for k in APP_COUNTERS),
          f"{path}: the kernel run's counters differ from {what}'s")


def run_app(path, label, run, kernel_run, kernels_of=None):
    """One Brusselator solve, ``run()`` -> (y, stats), with the counts
    zeroed just before it and read just after: a kernel run must launch
    the kernels of path ``kernels_of`` (default ``path``), a plain run
    none."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import loops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    loops.reset_loop_counts()
    t0 = time.perf_counter()
    y, st = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "counts": kernels.counts(),
           "loop": dict(loops.loop_counts),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "t": st.t.item(), "success": bool(st.success)}
    rec.update({k: int(getattr(st, k)) for k in
                ("nfe", "nfi") + APP_COUNTERS})
    print(f"{path} [{label}]: wall {wall:.3f} s, host syncs "
          f"{rec['loop']['host_syncs']}, step trips "
          f"{rec['loop']['step_trips']}, Newton trips "
          f"{rec['loop']['newton_trips']}, Krylov trips "
          f"{rec['loop']['krylov_trips']}, peak "
          f"{rec['peak_bytes'] / 2**20:.1f} MiB, steps {rec['steps']}, "
          f"attempts {rec['attempts']}, nni {rec['nni']}, netf "
          f"{rec['netf']}, ncfn {rec['ncfn']}, t {rec['t']}", flush=True)
    check_counts(kernels_of or path, rec["counts"], kernel_run)
    check(rec["success"], f"{path} [{label}]: the solve did not reach "
          f"its t_final (t = {rec['t']})")
    check(y.shape == (NXB, 3), f"{path}: misshapen y {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{path}: non-finite y")
    return y, rec


def integrate_no_pivot(cfg, t1):
    """``apps.brusselator.integrate``'s task-local plain run (its default
    options, every vector op plain) with one change: the block solve is
    row 8's plain version, ``block_solve_soa_plain`` (the kernel's
    no-pivot row-scaled Gauss-Jordan), instead of the plain backend's
    ``gauss_jordan_batched`` (partial pivoting, the reference's jnp
    route).  So it differs from the kernel run only in which of each
    kernel's two versions ran: the kernels' order of sums."""
    from repro_torch.apps import brusselator as br
    from repro_torch.core import arkode, butcher, dispatch, matrix
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    plain = ExecPolicy(backend="torch")
    jac = br.reaction_jacobian(cfg)

    def lin(t, z, gamma, rhs):
        M = matrix.bd_scale_addi(-gamma, matrix.BlockDiagMatrix(jac(t, z)))
        x = dispatch.block_solve_soa(M.data.permute(1, 2, 0).contiguous(),
                                     rhs.reshape(-1, 3).T.contiguous(), plain)
        return x.T.reshape(rhs.shape)

    opts = ODEOptions(rtol=cfg.rtol, atol=cfg.atol, max_steps=100_000,
                      newton_max=6, policy=plain)
    return arkode.imex_integrate(br.advection_rhs(cfg), br.reaction_rhs(cfg),
                                 br.initial_state(cfg), 0.0, t1,
                                 butcher.ARK324, opts, lin_solver=lin)


def phase_imex(path, solver, t1, profile):
    """Paths G and H: the paper's §7 Brusselator (``imex:ark324``) at
    nx = NXB, a kernel run, then a plain run on the same card
    (``ExecPolicy(backend="torch")``): every counter equal, the WRMS norm
    of the difference within 1 (G and H) and the max norm within
    10*(rtol*|y|+atol) (H; printed for G, whose plain run pivots).  G is
    also held to :func:`integrate_no_pivot`, which isolates the kernels:
    every counter equal and the WRMS norm within 1.  H is also held to a
    task-local kernel run over the same interval within the reference
    test's bound between its two configurations."""
    from repro_torch.apps import brusselator as br
    from repro_torch.configs.brusselator import BrusselatorConfig
    from repro_torch.core.policies import ExecPolicy
    cfg = BrusselatorConfig(nx=NXB, t_final=t1, solver=solver)
    plain = ExecPolicy(backend="torch")
    y, rec = run_app(path, "kernels", lambda: br.integrate(
        cfg, t_final=t1, policy=ExecPolicy()), True)
    ref, ref_rec = run_app(path, "plain versions", lambda: br.integrate(
        cfg, t_final=t1, policy=plain), False)
    same_counters(path, rec, ref_rec, "the plain run")
    agreement = agree_wrms(path, y, ref, cfg.rtol, cfg.atol,
                           gate_max=solver == "global")
    del ref
    if solver == "task-local":
        np_y, np_rec = run_app(path, "plain versions, no pivoting",
                               lambda: integrate_no_pivot(cfg, t1), False)
        check(np_rec["counts"]["block_solve"][1] > 0, f"{path}: the "
              "no-pivot run did not run block_solve_soa's plain version")
        same_counters(path, rec, np_rec, "the no-pivot plain run")
        agreement["vs_no_pivot"] = agree_wrms(
            path, y, np_y, cfg.rtol, cfg.atol, "the no-pivot plain run")
        agreement["no_pivot_run"] = np_rec
        del np_y
    else:
        # the reference test's bound between its two configurations
        # (tests/test_brusselator.py:14): |dy| <= 1e-9 + 1e-7*|y_tl|
        tl, _ = run_app(path, "task-local kernels", lambda: br.integrate(
            BrusselatorConfig(nx=NXB, t_final=t1, solver="task-local"),
            t_final=t1, policy=ExecPolicy()), True,
            kernels_of="G: imex task-local")
        ratio = ((y - tl).abs() / (1e-9 + 1e-7 * tl.abs())).max().item()
        print(f"{path} against the task-local run: max |dy|/(1e-9 + "
              f"1e-7*|y|) {ratio:.3g}", flush=True)
        agreement["vs_task_local"] = agree_wrms(
            path, y, tl, cfg.rtol, cfg.atol, "the task-local run")
        agreement["vs_task_local"]["test_bound_ratio"] = ratio
        check(ratio <= 1.0, f"{path}: y differs from the task-local run by "
              f"{ratio} of (1e-9 + 1e-7*|y|)")
        del tl
    del y
    prof = profile_run(path, lambda: br.integrate(cfg, t_final=t1),
                       rec["wall_s"]) if profile else None
    return {"kernels_run": rec, "plain_run": ref_rec,
            "agreement": agreement, "profile": prof}


def csr_gmres(cfg, policy):
    """Path I's linear solver ``(t, z, gamma, rhs) -> dz`` from public
    API only: the Jacobian of fe + fi as a ``SparseCSR`` over the fixed
    pattern of ``apps.brusselator.jacobian_csr_pattern`` (the reaction
    block, -c/dx on the diagonal, +c/dx at the upwind entry), ``M =
    J.scale_addI(-gamma)``, and GMRES on ``M.matvec`` (row 11) with the
    3x3 block solve of I - gamma*(B - (c/dx) I) (row 8) as right
    preconditioner, as the app's global Newton-GMRES does."""
    import torch
    from repro_torch.apps import brusselator as br
    from repro_torch.core import direct, krylov, matrix, sunmatrix
    nx = cfg.nx
    pattern = csr_pattern(4, 3 * nx)
    order_host = torch.as_tensor(br.jacobian_csr_pattern(nx)[2])
    orders = {}                         # the sort order, once per device
    cdx = cfg.c / (cfg.b_domain / nx)
    jac = br.reaction_jacobian(cfg)

    def solve(t, z, gamma, rhs):
        order = orders.get(z.device)
        if order is None:
            order = orders[z.device] = order_host.to(z.device)
        Bc = jac(t, z) - cdx * torch.eye(3, dtype=z.dtype, device=z.device)
        natural = torch.cat([Bc, torch.full((nx, 3, 1), cdx, dtype=z.dtype,
                                            device=z.device)], dim=2)
        J = sunmatrix.SparseCSR(natural.gather(2, order).reshape(-1),
                                pattern)
        M = J.scale_addI(-gamma)
        P = matrix.bd_scale_addi(-gamma, matrix.BlockDiagMatrix(Bc))
        dz, _ = krylov.gmres(
            lambda v: M.matvec(v.reshape(-1), policy).reshape(v.shape), rhs,
            tol=1e-4, restart=16, max_restarts=2,
            precond=lambda v: direct.block_solve(P, v, policy), policy=policy)
        return dz

    return solve


def phase_cvode(path, method, t1, profile):
    """Paths I and J: the scalar CVODE stack on the §7 Brusselator at
    nx = NXB through ``integrate``: I ``"bdf"`` on fe + fi with
    :func:`csr_gmres`, J ``"adams"`` on fe; a kernel run, then a plain
    run (``ExecPolicy(backend="torch")``) on the same card, held to it
    as G is: every counter equal, the WRMS norm of the difference
    within 1, the max-norm ratio printed; the one system succeeds (bdf:
    retcode 0)."""
    from repro_torch.apps import brusselator as br
    from repro_torch.configs.brusselator import BrusselatorConfig
    from repro_torch.core import ivp
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.context import Context
    from repro_torch.core.policies import ExecPolicy
    cfg = BrusselatorConfig(nx=NXB)
    fe, fi = br.advection_rhs(cfg), br.reaction_rhs(cfg)
    y0 = br.initial_state(cfg)
    prob = ivp.IVP(f=(lambda t, y: fe(t, y) + fi(t, y)) if method == "bdf"
                   else fe, y0=y0)

    def runner(policy):
        opts = ODEOptions(rtol=cfg.rtol, atol=cfg.atol, max_steps=100_000,
                          newton_max=6, policy=policy)
        kw = {"lin_solver": csr_gmres(cfg, policy)} if method == "bdf" \
            else {}

        def run():
            sol = ivp.integrate(prob, 0.0, t1, method, ctx=Context(),
                                opts=opts, **kw)
            if sol.retcodes is not None:
                check(int(sol.retcodes) == 0, f"{path}: retcode "
                      f"{int(sol.retcodes)}")
            return sol.y, sol.stats

        return run

    y, rec = run_app(path, "kernels", runner(ExecPolicy()), True)
    ref, ref_rec = run_app(path, "plain versions",
                           runner(ExecPolicy(backend="torch")), False)
    same_counters(path, rec, ref_rec, "the plain run")
    agreement = agree_wrms(path, y, ref, cfg.rtol, cfg.atol)
    del y, ref
    prof = profile_run(path, runner(ExecPolicy()), rec["wall_s"]) \
        if profile else None
    return {"t_final": t1, "kernels_run": rec, "plain_run": ref_rec,
            "agreement": agreement, "profile": prof}


def profile_run(path, run, plain_wall, bdf=False):
    """One more kernel run of a path (``run()``) under torch.profiler:
    device time by kernel name, the share of the port's kernels, the
    device time under the ``lagrange_matrix_soa`` range (``bdf``: an
    ensemble BDF run forms W in its kernel, so the range must not be
    there) and the other ranges, and the device's busy share
    both of the profiled wall time and of ``plain_wall``, the same
    solve's wall time without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lagrange = RANGES[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    range_us, range_calls = dict.fromkeys(RANGES, 0.0), dict.fromkeys(RANGES, 0)
    for e in p.events():
        if e.device_type == DeviceType.CUDA and e.name not in RANGES:
            # (a range's own device-side span is not a kernel)
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CPU and e.name in RANGES:
            # kernels launched inside the range, children included
            range_us[e.name] += getattr(e, "device_time_total", None) \
                or e.cuda_time_total
            range_calls[e.name] += 1
    lagrange_us, lagrange_calls = range_us[lagrange], range_calls[lagrange]
    if bdf:
        check(lagrange_calls == 0 and lagrange_us == 0,
              f"{path}: the kernel run built W in plain code ({lagrange}: "
              f"{lagrange_calls} calls, {lagrange_us / 1e6:.3f} s)")
    dev_us = sum(by_name.values())
    check(dev_us > 0, f"{path}: the trace holds no device time")
    ours_us = sum(v for name, v in by_name.items()
                  if any(sym in name for sym in KERNEL_SYMBOLS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    OUT.mkdir(exist_ok=True)
    slug = path.split(":")[0].replace(" ", "_")
    (OUT / f"chip_smoke_profile_{slug}.txt").write_text(
        "\n".join(f"{us / 1e3:12.3f} ms  {name}" for name, us in top) + "\n")
    print(f"{path} profiled: wall {wall:.3f} s, device busy "
          f"{dev_us / 1e6:.3f} s ({100 * dev_us / 1e6 / wall:.1f} % of the "
          f"profiled wall, {100 * dev_us / 1e6 / plain_wall:.1f} % of the "
          f"unprofiled {plain_wall:.3f} s), of which the port's kernels "
          f"{ours_us / 1e6:.3f} s and {lagrange} {lagrange_us / 1e6:.3f} s "
          f"in {lagrange_calls} calls (trace); {len(by_name)} kernel names",
          flush=True)
    for name in RANGES[1:]:
        if range_calls[name]:
            print(f"    range {name}: {range_us[name] / 1e6:.3f} s device "
                  f"time in {range_calls[name]} calls "
                  f"({100 * range_us[name] / dev_us:.1f} % of busy)",
                  flush=True)
    for name, us in top[:6]:
        print(f"    {us / 1e3:10.3f} ms  {name[:110]}", flush=True)
    return {"wall_s": wall, "unprofiled_wall_s": plain_wall,
            "device_busy_s": dev_us / 1e6, "port_kernels_s": ours_us / 1e6,
            "lagrange_trace_s": lagrange_us / 1e6,
            "lagrange_calls": lagrange_calls,
            "ranges_s": {k: v / 1e6 for k, v in range_us.items()},
            "range_calls": range_calls,
            "top_ms": {name: us / 1e3 for name, us in top}}


def lagrange_alone_ms():
    """One ``lagrange_matrix_soa`` call at the main path's size, timed
    alone: the plain tensor code that builds W in the plain run (the
    kernel run forms it inside ``lagrange_rescale``)."""
    import torch
    from repro_torch.core import cvode
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    eta = 0.1 + 9.9 * torch.rand(NSYS, generator=gen, device="cuda",
                                 dtype=torch.float64)
    q = torch.full((NSYS,), cvode.QMAX, dtype=torch.int32, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    ms = time_ms(lambda: cvode.lagrange_matrix_soa(eta, q), flush)
    print(f"lagrange_matrix_soa alone: {ms:.4f} ms a call", flush=True)
    return ms


def profiled_paths(argv):
    """``--profile`` profiles every path, ``--profile=I,J`` only those
    named (``main`` for the main path): -> path name -> bool."""
    arg = next((a for a in argv if a.split("=")[0] == "--profile"), None)
    names = None if arg is None or "=" not in arg else \
        set(arg.split("=", 1)[1].split(","))
    return lambda name: arg is not None and (names is None or name in names)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.linsol import (SPBCGS, SPGMR, BlockDiagGJ,
                                         EnsembleSparseGJ)
    from repro_torch.core.precond import BlockJacobiPrecond, ILU0Precond
    from repro_torch.kernels import _build

    # 1. device
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    # 2. build
    t0 = time.perf_counter()
    took = _build.build_all(verbose="--ptxas" in argv)
    for name in _build.SOURCES:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items()) or 'cached'})",
          flush=True)
    phase_s = {"build": time.perf_counter() - t0}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    # 3. kernels against their plain versions, then timings
    table = kernel_table()
    phase("compare", phase_compare, table, dev)
    rows, more_rows = phase("timings", phase_timings, table, dev)
    # 4. the paths, each against its plain run
    profiled = profiled_paths(argv)
    paths = {"ensemble_bdf": phase("main path (ensemble_bdf)",
                                   phase_main_path, profiled("main"))}
    # the main path's problem in coupled legs: warm start, telemetry,
    # profiler, logger and the memory helper
    paths["L: coupled legs"] = phase(
        "path L (coupled legs)", phase_path_l,
        paths["ensemble_bdf"].pop("y"),
        paths["ensemble_bdf"]["kernels_run"]["loop"]["host_syncs"],
        profiled("L"))
    # the serving tier: bundles of up to 2**16 lanes at b = 3 and b = 6
    paths["M: serving"] = phase("path M (serving)", phase_path_m, card,
                                profiled("M"))
    paths["A: ensemble_dirk"] = phase("path A (ensemble_dirk)", phase_path_a,
                                      profiled("A"))
    paths["ensemble_bdf"]["reference"] = phase(
        "reference (ensemble_bdf)", classic_robertson_reference,
        "ensemble_bdf")
    paths["B: ensemble_bdf direct"] = phase(
        "path B (ensemble_bdf, factor_once=False)", phase_brusselator,
        "B: ensemble_bdf direct", "ensemble_bdf", 2.0,
        {"lin_solver": BlockDiagGJ(factor_once=False)}, profiled("B"),
        keep_y=True)
    # B's systems under the default lsolve: the saved b = 32 inverse
    # (row 7) and one blockdiag_spmv a Newton iteration
    paths["K: ensemble_bdf BlockDiagGJ"] = phase(
        "path K (ensemble_bdf, BlockDiagGJ())", phase_brusselator,
        "K: ensemble_bdf BlockDiagGJ", "ensemble_bdf", 2.0,
        {"lin_solver": BlockDiagGJ()}, profiled("K"),
        per_newton=("blockdiag_spmv",), keep_y=True)
    y_b = paths["B: ensemble_bdf direct"].pop("y")
    y_k = paths["K: ensemble_bdf BlockDiagGJ"].pop("y")
    k_vs_b = ((y_k - y_b).abs() / (RTOL * y_b.abs() + ATOL)).max().item()
    paths["K: ensemble_bdf BlockDiagGJ"]["agreement"]["vs_b_max_over_tol"] = \
        k_vs_b
    print(f"K against B (two lsolves of one problem): max |y_K - y_B|/"
          f"(rtol*|y_B|+atol) {k_vs_b:.3g}", flush=True)
    del y_b, y_k
    paths["C: ensemble_erk"] = phase(
        "path C (ensemble_erk)", phase_brusselator, "C: ensemble_erk",
        "ensemble_erk:bogacki_shampine", 2.0, {}, profiled("C"))
    # the sparse ensemble: one global Krylov iteration couples the lanes,
    # so the plain runs cover the same systems and the Krylov paths are
    # held to 100*(rtol*|y|+atol), the reference's own jnp/Pallas gate
    for path, ls, C in (
            ("D: ensemble_bdf SPGMR",
             SPGMR(tol=1e-10, restart=10, max_restarts=6,
                   precond=BlockJacobiPrecond(block_size=2)), 100),
            ("E: ensemble_bdf EnsembleSparseGJ", EnsembleSparseGJ(), 10),
            ("F: ensemble_bdf SPBCGS",
             SPBCGS(tol=1e-10, maxiter=200, precond=ILU0Precond()), 100)):
        paths[path] = phase(f"path {path}", phase_brusselator, path,
                            "ensemble_bdf", 2.0, {"lin_solver": ls},
                            profiled(path[0]), True, C)
    # the paper's §7 demonstration: the scalar IMEX stack at nx = 2**20
    paths["G: imex task-local"] = phase(
        "path G (imex:ark324, task-local)", phase_imex,
        "G: imex task-local", "task-local", 0.2, profiled("G"))
    paths["H: imex global"] = phase(
        "path H (imex:ark324, global)", phase_imex, "H: imex global",
        "global", 0.05, profiled("H"))
    # the scalar CVODE stack on the same mesh: a CSR Newton matrix
    # (row 11) under bdf, and adams
    paths["I: bdf csr"] = phase(
        "path I (bdf, CSR Newton matrix + GMRES)", phase_cvode, "I: bdf csr",
        "bdf", TF_I, profiled("I"))
    paths["J: adams"] = phase("path J (adams)", phase_cvode, "J: adams",
                              "adams", TF_J, profiled("J"))
    # 5. kernels line: launches summed over the kernel runs of the paths
    line = []
    for k, row in zip(table, rows):
        launches = sum(rec["kernels_run"]["counts"][k.name][0]
                       for rec in paths.values())
        line.append({"name": k.name, "route": row["route"],
                     "source": row["source"], "replaces": row["replaces"],
                     "launches": launches,
                     "max_abs_err": k.max_err, "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "phase_s": phase_s, "timings": rows, "more_timings": more_rows,
         "paths": paths}, indent=1))
    print(json.dumps({"kernels": line}), flush=True)
    # 6. ok line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
