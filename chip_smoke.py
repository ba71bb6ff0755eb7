#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile[=main,A,...,N]] [--ptxas]
                          [--only=R | --only=S | --only=T]

Run from the repository root.  It imports nothing of JAX or of the JAX
package.  Phases, each of which fails the run (non-zero exit), and each
of which prints the seconds it took:

1. device: prints the card's name and power limit (``nvidia-smi``);
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
   (one process per source, all at once) unless already built;
3. kernels: each ported kernel body against its plain PyTorch version
   on the card, in float64 and float32: the six of the ensemble-BDF path,
   the fused history rebuild ``lagrange_rescale`` (W formed from eta
   and q), the fused lsolve ``newton_residual_lsolve`` (rows 1 and 2
   and the gamma-drift correction in one launch, bit for bit), the
   whole Newton iteration ``newton_update`` (that and row 3 in one
   launch: z' bit for bit, and both outputs bit for bit rows 1+2f and
   3) and the fused lsetup ``newton_block_inverse`` (row 6 with the
   Newton blocks formed in it, bit for bit, and bit for bit row 6 on the
   plain blocks) at the main-path shape (2**20 systems, n = b = 3) and
   at ragged batches (7, 130, 516), the ten also at path M's decay
   chain, n = b = 6, over those and 16384 systems, the three fused
   Newton kernels also at b = 1, 2, 4, 5, 7, 8 over the ragged batches,
   ``newton_block_inverse`` also on stiff Robertson Jacobians over 2**20
   systems and with NaN, inf and singular systems planted at b = 1..8
   (non-finite output on exactly the plain version's systems), both
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
   B, K, D, E, F), the six of the ensemble-BDF path and the fused Newton
   iteration also at n = 6 over 16384 (path M's decay chain), the two
   rebuild entries also with every system active, the fused Newton
   iteration also as the route it replaced (rows 1 and 2 and the plain
   ``2/(1+gamrat)``), the
   dot also at 3*2**20 elements (paths H and I) and at 32 (the floor of
   one timed launch); ``newton_update`` also as rows 1+2f and 3, and
   ``newton_block_inverse`` also as the plain Newton blocks and row 6
   (and the blocks alone), the routes they replaced;
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
     numpy seed 0) to t = 10, one launch of ``newton_update`` a Newton
     trip and one of ``newton_block_inverse`` a lsetup, and none of rows
     1, 2, 1+2f, 3 and 6 (as on L, M, N.1 and O.3); held bit for bit (y,
     every stats field, host syncs and trips) to a run with
     ``masked_update_wrms_soa`` pinned to its kernel (rows 1+2f, then
     3) and to one with ``newton_residual_soa`` pinned to its plain
     version and ``block_inverse_soa`` to its kernel (the two-op route:
     the residual, ``blockdiag_spmv``, row 3; row 6 on the plain Newton
     blocks), each with one launch of those a trip or a lsetup; 256
     classic-Robertson lanes must match
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
     requests); every kernel bundle launching rows 1+2+3f, 4f, 5, 6f at b = 3 and
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
   - path N, the multi-device layer and the op registry, after D-F
     (float64, rtol 1e-5, atol 1e-10; each sub-phase prints its
     seconds): N.1 ``ensemble_bdf_integrate_sharded`` over the main
     path's 2**20 systems to t = 10 as a world of one, with no process
     group and under an NCCL group of one, each equal to the main
     path's kernel run bit for bit (y, every stats field, its host
     syncs), rows 1+2+3f, 4f, 5, 6f and no plain version; N.4 the Fig. 4 analog
     (the reference's ``benchmarks/meshvector_overhead.py``): host us a
     call over 200 calls ending in a synchronize, ``MeshVector``'s
     ``linear_sum`` and ``wrms_norm`` against the raw ``dispatch`` calls
     at 1e4, 1e5, 1e6 and 3*2**20 elements, gspmd and explicit under
     the group of one, printed, no gate; N.2 two processes of this
     script (``--path-n-rank``), gloo over a ``file://`` store, both on
     this card: the sharded run at 2**20 - 1 systems (one padded dummy),
     the gathered y and stats on each rank equal to the main path's
     lanes bit for bit, and path D's solver sharded two ways over
     ``problems.brusselator_family`` (every lane's nli and npsolves the
     sum of the ranks' own totals, y within 100*(rtol*|y|+atol) of D's
     unsharded kernel run); N.3 in those ranks, explicit ``MeshVector``
     reductions over 3*2**20 + 5 elements split unevenly (``linear_sum``
     bit for bit, ``dot``, ``wrms_norm``, ``l1_norm`` within 1e-13
     relative of the whole vector's, ``max_norm``, ``min`` exact), each
     one collective and its row's one launch (row 12, 16, 14); N.5
     the main path's problem at 2**16 systems under
     ``ExecPolicy().override(blockdiag_spmv_soa="torch")``: rows 1, 3,
     4f, 5, 6f launched, row 2 never (its plain version instead) and the
     fused Newton iterations (rows 1+2f, 1+2+3f) never, within
     10*(rtol*|y|+atol) of the main path's lanes, retcodes equal; a
     failed rank fails the run;
   - path O, the analysis layer, right after N: O.1 the ``h100_sxm``
     roofline row's constants measured on this card (the device time of
     one launch of a hand-written kernel and of one plain elementwise
     op, back to back, and the streamed bandwidth of a 1 GiB device copy
     and of a plain elementwise product), printed beside the row's, and
     ``device_for`` finding this card's row; O.2 ``autotune.tune()``
     over its grid (the reference tuner's signatures and the port's own
     ops', and :func:`path_o_grid`: the paths'
     shapes of phase 3) into a temporary directory,
     every time finite and above 0, the cache read back equal, each
     entry's winner and torch/cuda ratio, the model's agreement and
     every misprediction printed, the main path's signatures (rows 1-6,
     4f, 1+2f, 1+2+3f and 6f at 2**20 systems) won by the kernels and the model agreeing
     on at least 80 % of the entries; O.3 the main path under
     ``Context(policy=ExecPolicy())`` with that cache, bit for bit the
     main path's kernel run (y, every stats field, its host syncs),
     rows 1+2+3f, 4f, 5, 6f and no plain version, one decision a signature, each
     the kernel from the cache, their hits the op calls, the three
     ``repro_autotune_*`` gauges exported, its wall printed beside the
     main path's; O.4 sunlint's kernel-contract with the card present
     (each signature of its grid run on both implementations); the
     resolvers reset after.  Every other path runs under the default
     ``"auto"``, which runs the kernels whatever the resolver decides,
     with ``$REPRO_TORCH_AUTOTUNE_DIR`` set to an empty directory (so a
     cache left in the checkout changes no decision the paths report),
     and each path's launch checks hold as before;
   - path P, the model stack's serving half (``repro_torch.models``,
     ``serve.decode``), last: no kernel of the port lies on it (the
     reference's models reach no ``pallas_call``), and its launch count
     of every kernel and plain version must stay 0.  internlm2-1.8b's
     ``FULL`` config, weights drawn from a seeded generator on the card:
     P.1 greedy ``generate`` in bf16, batch 16, a 128-token prompt
     (numpy seed 0) and 128 new tokens (``max_len`` 256), every token in
     range and every step's logits finite, ms a decode step, tokens/s and
     peak memory printed; P.2 the same config in float32 at full depth
     and width: 32 tokens decoded one by one held to the forward pass
     within 2e-3 + 2e-3*|logit| (the reference's tolerance,
     ``tests/test_archs.py:94``), and greedy ``generate`` from their
     first 8 equal to the forward pass's argmax (a differing token only
     at a near-tie); P.3 those float32 weights cut to 2 layers: a forward
     pass and 4 decode steps on the card held to the port's CPU run
     within 1e-4 of each tensor's scale; P.4 one bf16 decode step at pos
     32767 over ``SHAPES["decode_32k"]``'s 32768-token cache, batch 8
     (25.8 GB of random K and V), median ms of 5 beside its bound (weight
     and cache bytes over 3.35 TB/s) and peak memory; P.5 the ten archs'
     smoke configs (bf16: forward, loss and a decode step finite;
     float32: decode against the forward pass for internlm2, starcoder2
     and qwen2); P.6 sunlint's dispatch walker (``hot-loop-layout``,
     ``dtype-drift``) over four ``ensemble_bdf`` and ``ensemble_dirk``
     steps of the main path's 2**20 systems under the kernels: no
     finding outside ``.sunlint-torch-baseline``;
   - path Q, the model stack's training half (``data/``, ``optim/``,
     ``train/``, ``launch/train.py``), after P: Q.1 the launcher's path
     at internlm2-1.8b's ``FULL`` width (bf16, remat): six AdamW steps
     of ``make_train_step`` over ``synthetic_batch`` (batch 8 x 512,
     seed 0, lr 3e-4, warmup 1), every loss and gradient norm finite
     and > 0 and the last loss below the first, row 16 (``dot``, AdamW's
     global norm) launched once a leaf a step; ms a step (median of steps
     2-6), tokens/s, the share of 989 TFLOP/s given by 6*N*T plus remat's
     2*N_layers*T, the device's busy share (one profiled step) and peak
     memory printed; row 16 on the full-width gradients against its plain
     version (each leaf's dot and the global norm within 1e-4 relative);
     Q.2 step 0's batch with 4 microbatches against one, both from the
     same initial weights (loss within 1e-4 relative, gradient norm 1e-3,
     the float32 gradient each fed AdamW 0.1 of each leaf's norm; params
     within 3e-2*|p| + 2*lr + one bf16 ulp, the reference's own check);
     Q.3 the width cut to 2 layers in float32 (weights drawn on the CPU),
     one step (batch 2 x 64) on the card against the port's CPU run with
     the same weights (loss within 1e-5 relative, params 2*lr + 1e-6,
     gradients, their norm and the moments within 3x the CPU's own
     float32 error + 1e-4) and remat on against off on the card bit for
     bit; Q.4 the launcher on
     ``internlm2-1.8b-smoke`` (6 steps, checkpoints every 3) run twice
     uninterrupted and once crashed after 3 steps (its data stream dies)
     then resumed: the resume line printed, the resumed losses and final
     checkpoint equal to the uninterrupted run's bit for bit when the two
     uninterrupted runs repeat their bits (else within Q.2's loss
     tolerance, printed); Q.5 ``gradflow.step`` (heun_euler, tau 0.1,
     max_steps 6) on Q.3's cut, rows 12 and 14 launched, its steps and
     attempts equal to a run with ``linear_combination``, ``wrms_norm``
     and ``dot`` pinned to their plain versions, params within
     10*(rtol*|p|+atol) of it, the loss falling;
   - path R, the model-parallel layer, after Q: R.1 dbrx-132b's MoE
     layer expert-parallel over an NCCL group of one against the dense
     oracle; R.2-R.4 in four ``--path-r-rank`` processes of this script
     on the card (gloo, data 2 x model 2): EP in both token layouts, the
     tp_fsdp train step of internlm2-1.8b's width cut to 2 layers
     against one card (row 16 on each rank's shards), a sharded
     checkpoint saved, restored and stepped bit for bit;
   - path S, after R: S.1 in four ``--path-s-rank`` processes (gloo,
     data 2 x model 2) ``gradflow.step`` over the mesh on Q.3's cut,
     its first 3 ERK attempts (rows 12 and 14 on every rank's float32
     shards, the gradients in
     float64 in both runs), its steps and attempts and its initial
     step's norms equal to one card's unsharded step, the gathered
     parameters after the first accepted attempt within 1 % of that
     attempt's movement from one card's (a planted no-op, half update
     and wrong stage sum past it), replicated blocks equal on every
     replica, each row held to its plain version on a rank's shard, and
     the fsdp profile's loss against one card's; S.2 the dry run
     (``launch.dryrun.lower_cell`` on meta tensors, fake groups of 256,
     4 and 1 in this process, while S.1's ranks run): internlm2-1.8b and dbrx-132b ``train_4k``
     and internlm2-1.8b's fsdp profile on the 256-rank mesh, R.3's cell
     (its collectives by kind and its state a rank equal to R.3's
     record of this call) and Q.1's; each cell's roofline row (data-sheet
     estimates) and seconds printed, no kernel launched and row 16's
     plain version only on abstract tensors;
   - path T, after S: T.1 in four ``--path-t-rank`` processes (gloo,
     data 2 x model 2) the fsdp profile's loss and gradients of zamba2-7b
     (1 Mamba layer and its shared-attention site), xlstm-125m (one pair),
     whisper-tiny and qwen2-vl-2b (2 layers, a vision prefix that ends
     inside a sequence block) at their FULL widths, float32 weights
     evaluated in float64, batch 2 x 256 (xlstm 2 x 64), against one
     card's (every gradient leaf, NaN where one card's is; one card's
     nudged runs inside the same gates, a planted fault past them), with
     a rank's ms, collectives, state and peak; T.2 on data 1 x model 4
     qwen2-vl-2b's 2-layer cut in float64, whose caches split head_dim 4
     ways: a
     4096-token prefill and 8 greedy steps against one card's, each
     rank's K/V a quarter of one card's;
     T.3 the dry run of the fsdp ``train_4k`` cells of zamba2-7b,
     whisper-tiny and qwen2-vl-2b and qwen2-72b ``decode_32k`` on the
     256-rank mesh, in this process while T.1-T.2's ranks run (their
     times include it); no kernel of the port on the path;
5. prints the ``{"kernels": [...]}`` line; 6. prints the ``ok`` line.

``--profile`` adds a profiled kernel run to each path (``--profile=I,J``
to the paths named; ``main`` is the main path; M profiles the drain of
one more full Robertson bundle; N its world-of-one sharded run; P a
32-step generate of P.1 and one P.4 step) and
writes its
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
import math
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
KERNEL_SYMBOLS = ("newton_residual_kernel", "newton_residual_lsolve_kernel",
                  "masked_update_wrms_kernel", "newton_update_kernel",
                  "history_rescale_kernel", "history_rescale_loop_kernel",
                  "wrms_soa_kernel",
                  "spmv_fixed_kernel", "spmv_rows_kernel",
                  "spmv_any_kernel",
                  "gj_inverse_unrolled_kernel", "newton_block_inverse_kernel",
                  "gj_inverse_warp_kernel",
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
#: the main path's kernels under BlockDiagGJ() at b <= 8: each Newton
#: iteration one launch of the whole iteration (row 1+2+3f), each lsetup
#: one of the fused inverse (row 6f)
MAIN_BDF = ("newton_update", "lagrange_rescale", "wrms_soa",
            "newton_block_inverse")
#: the kernels a path of MAIN_BDF's launches no time: rows 1, 2, 1+2f, 3
#: and 6, which the fused ones replace there
MAIN_REPLACED = ("newton_residual", "blockdiag_spmv", "newton_residual_lsolve",
                 "masked_update_wrms", "block_inverse")
#: path -> the kernel bodies (registry names) it must launch
PATH_KERNELS = {
    "ensemble_bdf": MAIN_BDF,
    # the main path with masked_update_wrms_soa pinned to its kernel: the
    # fused residual and lsolve, then row 3, held to the fused run bit
    # for bit
    "main: pinned update": ("newton_residual_lsolve", "masked_update_wrms",
                            "lagrange_rescale", "wrms_soa",
                            "newton_block_inverse"),
    # the main path with newton_residual_soa pinned to its plain version
    # and block_inverse_soa to its kernel: the two-op Newton iteration
    # and row 6 on the plain Newton blocks, held to the fused run bit for
    # bit
    "main: two-op route": ("blockdiag_spmv", "masked_update_wrms",
                           "lagrange_rescale", "wrms_soa", "block_inverse"),
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
    "L: coupled legs": MAIN_BDF,
    "M: serving": MAIN_BDF,
    "N: sharded ensemble_bdf": MAIN_BDF,
    "N.5: pinned": ("newton_residual", "masked_update_wrms",
                    "lagrange_rescale", "wrms_soa", "newton_block_inverse"),
    "O: auto main path": MAIN_BDF,
}
#: path -> the plain versions its kernel run takes by a per-op pin (and
#: must take); a kernel run of any other path takes none
PATH_PLAIN = {"N.5: pinned": ("blockdiag_spmv",),
              "main: two-op route": ("newton_residual",)}
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
#: path N: ranks of N.2 and N.3 (gloo, all on the card) and the seconds
#: they may take; N.3's vector length (split unevenly); N.4's vector
#: lengths and its calls a timing
N_WORLD, N_RANK_TIMEOUT = 2, 300
N3_SIZE = 3 * NXB + 5
N_OVERHEAD_SIZES = (10 ** 4, 10 ** 5, 10 ** 6, 3 * NXB)
N_REPS, N_ROUNDS = 200, 3
#: path O: launches a timing of one launch and rounds of such timings;
#: the spin before them (~10 ms, so the host enqueues all the launches
#: before the device reaches them); the bytes of the streamed copy
O_LAUNCHES, O_ROUNDS = 200, 5
O_SPIN_CYCLES = 20_000_000
O_GIB = 1 << 30
#: path O: the decay chain's and the mesh's lengths in the tuner's grid
#: (path M's n = 6 over 16384 systems; the §7 mesh's 3 * 2**20 unknowns)
O_DECAY_N, O_MESH_N = 6, 3 * NXB
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
        #: (a tuple: per output)
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
        exact = self.exact if isinstance(self.exact, tuple) else \
            (self.exact,) * len(got)
        for g, w, ex in zip(got, want, exact):
            err = (g - w).abs().max().item()
            check(not ex or torch.equal(g, w),
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
    J, gam = robertson_jacobians(nb, gen, dev, dtype)
    return torch.eye(3, device=dev, dtype=dtype)[:, :, None] - gam * J


def robertson_jacobians(nb, gen, dev, dtype):
    """(J, gamma) of :func:`robertson_newton_blocks`: Robertson's
    Jacobians (zeros in its third row) and gamma over eight decades."""
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
    return J.contiguous(), 10.0 ** u(-8, 0)


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
    nb), diagonally dominant, and r; the gamma ratios since lsetup,
    gamrat over [0.7, 1.3] (the fused Newton iteration's, with A as its
    saved inverse); Jacobians J (b, b, nb) whose Newton blocks I -
    gam*J are diagonally dominant (the fused lsetup's)."""
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    eta = 10.0 ** (2 * torch.rand(nb, generator=gen, device=dev,
                                  dtype=dtype) - 1)
    eta[::5] = 1.0
    q = torch.randint(0, 6, (nb,), generator=gen, device=dev,
                      dtype=torch.int32)
    d = {"z": r(b, nb), "f": r(b, nb), "psi": r(b, nb),
         "gam": r(nb).abs(), "w": r(b, nb).abs() + 0.1,
         "mask": torch.rand(nb, generator=gen, device=dev) > 0.4,
         "W": r(6, 6, nb), "Z": r(6, b, nb), "r": r(b, nb),
         "eta": eta, "q": q,
         "A": r(b, b, nb) + b * torch.eye(b, device=dev,
                                           dtype=dtype)[:, :, None]}
    d["gamrat"] = 0.7 + 0.6 * torch.rand(nb, generator=gen, device=dev,
                                         dtype=dtype)
    d["J"] = r(b, b, nb) / (b * (d["gam"] + 1.0))
    return d


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
        # rows 1 and 2 fused with the correction: the Newton iteration of
        # BlockDiagGJ() at b <= 8, one launch for six; no single PyTorch
        # call computes it
        Kernel("newton_residual_lsolve", newton.newton_residual_lsolve,
               newton.newton_residual_lsolve_plain,
               ref + "newton.py:40, " + ref + "blockdiag_spmv.py:20",
               csrc + "newton.cu",
               lambda d: (d["z"], d["f"], d["psi"], d["gam"], d["gamrat"],
                          d["A"]), {},
               # per system 3b (residual), (2b - 1)b (SpMV), 3 (corr), b
               lambda d: (2 * b_of(d) ** 2 + 3 * b_of(d) + 3) * nb_of(d),
               b3 + b6 + [(b, nb) for b in (1, 2, 4, 5, 7, 8)
                          for nb in RAGGED], more_timings=n6, exact=True),
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
        # rows 1, 2 and 3 fused with the correction: the whole Newton
        # iteration of BlockDiagGJ() at b <= 8, one launch where rows 1+2f
        # and 3 took two; z' equals the plain version's bits, the norm
        # its tolerance (PyTorch's mean sums in its own order); no
        # single PyTorch call computes it
        Kernel("newton_update", newton.newton_update,
               newton.newton_update_plain,
               ref + "newton.py:40, " + ref + "blockdiag_spmv.py:20, "
               + ref + "newton.py:73", csrc + "newton.cu",
               lambda d: (d["z"], d["f"], d["psi"], d["gam"], d["gamrat"],
                          d["A"], d["w"], d["mask"]), {},
               # row 1+2f's, then per component a product, a square and
               # a sum, the masked sums, and a quotient and a root
               lambda d: (2 * b_of(d) ** 2 + 6 * b_of(d) + 5) * nb_of(d)
               + b_of(d) * int(d["mask"].sum()),
               b3 + b6 + [(b, nb) for b in (1, 2, 4, 5, 7, 8)
                          for nb in RAGGED], more_timings=n6,
               exact=(True, False)),
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
        # row 6 with the Newton blocks I - gam*J formed in the kernel: the
        # lsetup of BlockDiagGJ() at b <= 8; no single PyTorch call
        # computes it from J and gamma
        Kernel("newton_block_inverse", block_solve.newton_block_inverse_soa,
               block_solve.newton_block_inverse_soa_plain,
               ref + "block_solve.py:92", csrc + "block_solve.cu",
               lambda d: (d["J"], d["gam"]), {},
               lambda d: 2 * b_of(d) ** 2 * nb_of(d)
               + inverse_flops(b_of(d), nb_of(d)),
               b3 + b6 + [(b, nb) for b in (1, 2, 4, 5, 7, 8)
                          for nb in RAGGED], more_timings=n6, exact=True),
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
            if maker == "make_inputs" and b <= 8:
                compare_fused_routes(d, f"b={b} nb={nb} {dtype}")
    by_name = {k.name: k for k in table}
    M = robertson_newton_blocks(NSYS, gen, dev, torch.float64)
    r = torch.randn(3, NSYS, generator=gen, device=dev, dtype=M.dtype)
    stiff = {"A": M, "r": r}
    by_name["block_inverse"].compare(stiff, "Robertson Newton blocks")
    by_name["block_solve"].compare(stiff, "Robertson Newton blocks")
    J, gam = robertson_jacobians(NSYS, gen, dev, torch.float64)
    by_name["newton_block_inverse"].compare({"J": J, "gam": gam},
                                            "Robertson Jacobians")
    del J, gam
    compare_nonfinite_blocks(gen, dev)
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
          + ", ".join(k.name if k.exact is True else f"{k.name}'s first "
                      "output" for k in table if k.exact) + " bit for bit)",
          flush=True)


def compare_fused_routes(d, what):
    """Rows 1+2+3f and 6f against the launches they replace, bit for
    bit: rows 1+2f then 3 (both outputs), and row 6 on the plain Newton
    blocks."""
    import torch
    from repro_torch.core.linsol import newton_blocks_soa
    from repro_torch.kernels import block_solve, newton
    args = (d["z"], d["f"], d["psi"], d["gam"], d["gamrat"], d["A"])
    got = newton.newton_update(*args, d["w"], d["mask"])
    two = newton.masked_update_wrms(d["z"], newton.newton_residual_lsolve(
        *args), d["w"], d["mask"])
    check(all(torch.equal(g, t) for g, t in zip(got, two)),
          f"newton_update {what}: not the bits of rows 1+2f and 3")
    inv = block_solve.newton_block_inverse_soa(d["J"], d["gam"])
    check(torch.equal(inv, block_solve.block_inverse_soa(
        newton_blocks_soa(d["J"], d["gam"]))),
          f"newton_block_inverse {what}: not the bits of row 6 on the plain "
          "Newton blocks")


def compare_nonfinite_blocks(gen, dev):
    """Row 6f at b = 1..8 over 516 systems, both dtypes, with non-finite
    and singular systems planted (a NaN and an inf entry of J, an inf
    gamma, a zero row, an all-zero block): non-finite output on exactly
    the plain version's non-finite systems, the same NaN and inf
    entries, and the plain version's bits on every other."""
    import torch
    from repro_torch.kernels import block_solve
    nb = 516
    for dtype in (torch.float64, torch.float32):
        for b in range(1, 9):
            d = make_inputs(nb, dtype, gen, dev, b=b)
            J, gam = d["J"].clone(), d["gam"].clone()
            J[b - 1, 0, 1] = float("nan")
            J[0, b - 1, 2] = float("inf")
            gam[3] = float("inf")
            gam[4] = gam[5] = 1.0
            J[0, :, 4] = 0.0
            J[0, 0, 4] = 1.0
            J[:, :, 5] = torch.eye(b, device=dev, dtype=dtype)
            got = block_solve.newton_block_inverse_soa(J, gam)
            want = block_solve.newton_block_inverse_soa_plain(J, gam)
            what = f"newton_block_inverse b={b} {dtype}, planted systems"
            bad = (~want.isfinite()).reshape(-1, nb).any(dim=0)
            check(torch.equal(bad, (~got.isfinite()).reshape(-1, nb)
                              .any(dim=0)) and bool(bad[1:6].all()),
                  f"{what}: non-finite systems differ from the plain "
                  "version's")
            check(torch.equal(got.isnan(), want.isnan()) and
                  torch.equal(got.isinf(), want.isinf()),
                  f"{what}: NaN or inf entries differ")
            check(torch.equal(got[:, :, ~bad], want[:, :, ~bad]),
                  f"{what}: finite systems not bit for bit")


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
    shape its path gives it, float64, against its bound; rows 1+2f,
    1+2+3f and 6f also as the routes they replaced."""
    import torch
    from repro_torch.kernels import blockdiag_spmv, newton
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
    # the fused Newton iteration beside the route it replaced: rows 1
    # and 2 and the plain correction (six launches)
    for row in rows + more:
        if row["name"] != "newton_residual_lsolve":
            continue
        d = inputs[("make_inputs", (row["b"], row["nb"]))]
        row["ms_two_op"] = time_ms(lambda: (2.0 / (1.0 + d["gamrat"]))[
            None, :] * blockdiag_spmv.blockdiag_spmv_soa(
                d["A"], newton.newton_residual(
                    d["z"], d["f"], d["psi"], d["gam"], negate=True)), flush)
        print(f"  newton_residual_lsolve, b={row['b']}: fused {row['ms']:.4f} "
              f"ms, rows 1 and 2 with the plain correction "
              f"{row['ms_two_op']:.4f} ms", flush=True)
    # the whole Newton iteration beside rows 1+2f and 3, the fused lsetup
    # beside the plain Newton blocks and row 6 (and the build alone)
    from repro_torch.core.linsol import newton_blocks_soa
    from repro_torch.kernels import block_solve
    for row in rows + more:
        if row["name"] not in ("newton_update", "newton_block_inverse"):
            continue
        d = inputs[("make_inputs", (row["b"], row["nb"]))]
        if row["name"] == "newton_update":
            args = (d["z"], d["f"], d["psi"], d["gam"], d["gamrat"], d["A"])
            row["ms_replaced"] = time_ms(lambda: newton.masked_update_wrms(
                d["z"], newton.newton_residual_lsolve(*args), d["w"],
                d["mask"]), flush)
            print(f"  newton_update, b={row['b']} nb={row['nb']}: one launch "
                  f"{row['ms']:.4f} ms, rows 1+2f and 3 "
                  f"{row['ms_replaced']:.4f} ms", flush=True)
        else:
            row["ms_build"] = time_ms(lambda: newton_blocks_soa(
                d["J"], d["gam"]), flush)
            row["ms_replaced"] = time_ms(lambda: block_solve.block_inverse_soa(
                newton_blocks_soa(d["J"], d["gam"])), flush)
            print(f"  newton_block_inverse, b={row['b']} nb={row['nb']}: one "
                  f"launch {row['ms']:.4f} ms, the plain Newton blocks and "
                  f"row 6 {row['ms_replaced']:.4f} ms (the blocks alone "
                  f"{row['ms_build']:.4f} ms)", flush=True)
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


def check_fused(path, counts, loop):
    """A kernel run of the main path's kernels: one launch of the whole
    Newton iteration a Newton trip, one of the fused inverse a lsetup,
    and none of the rows they replace."""
    trips, lsetups = loop["newton_trips"], loop["lsetups"]
    check(counts["newton_update"][0] == trips and
          counts["newton_block_inverse"][0] == lsetups,
          f"{path}: newton_update launched {counts['newton_update'][0]} times "
          f"in {trips} Newton trips, newton_block_inverse "
          f"{counts['newton_block_inverse'][0]} in {lsetups} lsetups")
    launched = {k: counts[k][0] for k in MAIN_REPLACED if counts[k][0]}
    check(not launched, f"{path}: launched {launched}, which the fused "
          "kernels replace")


def check_counts(path, counts, kernel_run, loop=None):
    """A kernel run launches every body of its path and no plain
    version, a run of the main path's kernels one fused launch a Newton
    trip and a lsetup (``loop`` given); a plain run launches nothing."""
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
    pinned = PATH_PLAIN.get(path, ())
    for name, (launched, plain_calls) in counts.items():
        if name in pinned:
            check(launched == 0 and plain_calls > 0, f"{path}: {name} is "
                  f"pinned to its plain version, but the kernel launched "
                  f"{launched} times and the plain version ran "
                  f"{plain_calls}")
        else:
            check(plain_calls == 0, f"{path}: plain {name} ran "
                  f"{plain_calls} times")
    if loop is not None and PATH_KERNELS[path] == MAIN_BDF:
        check_fused(path, counts, loop)


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
    check_counts(path, counts, label != "plain versions", rec["loop"])
    check(rec["lanes_ok"] == rec["lanes"],
          f"{path} [{label}]: {rec['lanes'] - rec['lanes_ok']} lanes failed")
    check(bool(torch.isfinite(sol.y).all()), f"{path}: non-finite y")
    return sol, rec


def agree(path, y, ref, retcodes=None, ref_retcodes=None, mass=False, C=10,
          what="the plain run"):
    """Kernel run against plain run (or ``what``): equal retcodes, y
    within C*(rtol*|y|+atol); optionally y1+y2+y3 = 1 within 10*rtol."""
    import torch
    if retcodes is not None:
        check(torch.equal(retcodes, ref_retcodes), f"{path}: retcodes differ")
    bound = C * (RTOL * ref.abs() + ATOL)
    ratio = ((y - ref).abs() / bound).max().item()
    check(ratio <= 1.0, f"{path}: y differs from {what} by {ratio} "
          f"of {C}*(rtol*|y|+atol)")
    out = {"max_diff_over_bound": ratio}
    if mass:
        out["mass_drift"] = (y.sum(dim=1) - 1.0).abs().max().item()
        check(out["mass_drift"] <= 10 * RTOL,
              f"{path}: y1+y2+y3 drifts from 1 by {out['mass_drift']}")
    print(f"{path} agrees with {what}: "
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
    import torch
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
    del ref
    # the routes the fused kernels replaced, each bit for bit the fused
    # run with the same syncs and trips: with masked_update_wrms_soa
    # pinned to its kernel, rows 1+2f and 3; with newton_residual_soa
    # pinned to its plain version (which rounds as row 1) and
    # block_inverse_soa to its kernel, the residual, rows 2 and 3, and
    # row 6 on the plain Newton blocks
    trips, lsetups = rec["loop"]["newton_trips"], rec["loop"]["lsetups"]
    routes = {}
    for route, label, pins, per_trip, per_lsetup in (
            ("main: pinned update", "kernels, masked_update_wrms_soa pinned",
             {"masked_update_wrms_soa": "cuda"},
             ("newton_residual_lsolve", "masked_update_wrms"),
             "newton_block_inverse"),
            ("main: two-op route", "kernels, newton_residual_soa and "
             "block_inverse_soa pinned",
             {"newton_residual_soa": "torch", "block_inverse_soa": "cuda"},
             ("blockdiag_spmv", "masked_update_wrms"), "block_inverse")):
        sol2, rec2 = run_path(route, label, prob, "ensemble_bdf", 10.0,
                              opts._replace(policy=ExecPolicy().override(
                                  **pins)))
        check(torch.equal(sol2.y, sol.y), f"{route}: y is not the fused "
              "run's bit for bit")
        same_stats(route, "the fused run", sol2.stats, sol.stats)
        check(rec2["loop"] == rec["loop"], f"{route}: loop counts "
              f"{rec2['loop']}, the fused run {rec['loop']}")
        counts = rec2["counts"]
        check(all(counts[k][0] == trips for k in per_trip) and
              counts[per_lsetup][0] == lsetups, f"{route}: one launch of "
              f"{per_trip} a Newton trip ({trips}) and of {per_lsetup} a "
              f"lsetup ({lsetups}): {[counts[k] for k in per_trip]}, "
              f"{counts[per_lsetup]}")
        routes[route] = rec2
        del sol2
    print(f"{path}: the fused Newton iteration and lsetup equal rows 1+2f "
          f"and 3, and the two-op route with row 6, bit for bit (y, stats, "
          f"{rec['loop']['host_syncs']} host syncs, {trips} Newton trips, "
          f"{lsetups} lsetups; one fused launch each)", flush=True)
    y, stats = sol.y, sol.stats
    del sol
    prof = None
    if profile:
        prof = profile_run(path, integrate_call(prob, "ensemble_bdf", 10.0,
                                                opts), rec["wall_s"], True)
        prof["lagrange_alone_ms"] = lagrange_alone_ms()
    return {"kernels_run": rec, "plain_run": ref_rec,
            "pinned_update_run": routes["main: pinned update"],
            "two_op_run": routes["main: two-op route"],
            "agreement": agreement, "profile": prof, "y": y, "stats": stats}


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
            if PATH_KERNELS[path] == MAIN_BDF:
                check_fused(where, r["counts"], r["loop"])
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


def robertson_family_problem(nsys, dev):
    """The main path's first ``nsys`` systems in the form the sharded
    ensemble takes: ``(f, jac, y0, params)``, the rates (numpy seed 0)
    as per-system data."""
    import torch
    from repro_torch.core import problems
    rates = problems.robertson_rates(NSYS, seed=0)
    params = {k: torch.as_tensor(v[:nsys], device=dev)
              for k, v in rates.items()}
    f, jac, _, _ = problems.robertson_family()
    y0 = torch.zeros((nsys, 3), dtype=torch.float64, device=dev)
    y0[:, 0] = 1.0
    return f, jac, y0, params


def n_run(path, label, run, kernel_path):
    """One call of path N's (``run()``) with the counts zeroed just
    before it and read just after; its kernels checked as those of
    ``kernel_path``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import batched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    batched.reset_loop_counts()
    start = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - start, "counts": kernels.counts(),
           "loop": dict(batched.loop_counts),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"{path} [{label}]: wall {rec['wall_s']:.3f} s, host syncs "
          f"{rec['loop']['host_syncs']}, step trips "
          f"{rec['loop']['step_trips']}, Newton trips "
          f"{rec['loop']['newton_trips']}, Krylov trips "
          f"{rec['loop']['krylov_trips']}, peak "
          f"{rec['peak_bytes'] / 2**20:.1f} MiB", flush=True)
    check_counts(kernel_path, rec["counts"], True, rec["loop"])
    return out, rec


def same_stats(path, what, st, ref, lanes=None):
    """Every field of two EnsembleStats equal bit for bit (``ref``'s
    first ``lanes``)."""
    import torch
    for name, a, b in zip(ref._fields, st, ref):
        if a is None or b is None:
            check(a is None and b is None, f"{path}: {what}: stats field "
                  f"{name} is None on one side only")
            continue
        b = b if lanes is None else b[:lanes]
        check(torch.equal(a.to(b.device), b), f"{path}: {what}: stats "
              f"field {name} differs from the main path's")


def sum_counts(recs):
    """Kernel launches and plain calls summed over runs."""
    names = recs[0]["counts"]
    return {n: (sum(r["counts"][n][0] for r in recs),
                sum(r["counts"][n][1] for r in recs)) for n in names}


def n_overhead(dev):
    """N.4, the Fig. 4 analog (the reference's
    ``benchmarks/meshvector_overhead.py``): host-side us per call over
    N_REPS calls ending in a synchronize, ``MeshVector.linear_sum`` and
    ``.wrms_norm`` against the raw ``dispatch`` calls, in gspmd mode and
    in explicit mode under the process group of one; N_ROUNDS rounds in
    turns, the ratio of the medians."""
    import torch
    from repro_torch.core import dispatch
    from repro_torch.core.vector import MeshVector, MeshVectorSpec
    from repro_torch.launch.mesh import make_ensemble_mesh
    mesh = make_ensemble_mesh()

    def per_call_us(fn):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / N_REPS * 1e6

    rows = []
    for n in N_OVERHEAD_SIZES:
        x = torch.arange(n, dtype=torch.float64, device=dev)
        w = torch.full((n,), 0.5, dtype=torch.float64, device=dev)
        calls = {("raw", "linear_sum"):
                 lambda: dispatch.linear_sum(2.0, x, -3.0, w),
                 ("raw", "wrms_norm"): lambda: dispatch.wrms_norm(x, w)}
        for mode, comm in (("gspmd", None), ("explicit", mesh)):
            spec = MeshVectorSpec(comm=comm, mode=mode)
            mx, mw = MeshVector(x, spec), MeshVector(w, spec)
            calls[mode, "linear_sum"] = functools.partial(
                mx.linear_sum, 2.0, -3.0, mw)
            calls[mode, "wrms_norm"] = functools.partial(
                mx.wrms_norm, mw, global_size=n)
        # rounds in turns, so drift reaches every form alike
        us = {k: [] for k in calls}
        for _ in range(N_ROUNDS):
            for k, fn in calls.items():
                us[k].append(per_call_us(fn))
        for mode in ("gspmd", "explicit"):
            for op in ("linear_sum", "wrms_norm"):
                mv, raw = us[mode, op], us["raw", op]
                ratio = statistics.median(mv) / statistics.median(raw)
                rows.append({"n": n, "mode": mode, "op": op,
                             "meshvector_us": mv, "raw_us": raw,
                             "ratio_of_medians": ratio})
                print(f"N.4 {op} n={n} {mode}: MeshVector "
                      f"{', '.join(f'{v:.2f}' for v in mv)} us, raw "
                      f"{', '.join(f'{v:.2f}' for v in raw)} us, ratio of "
                      f"medians {ratio:.3f}", flush=True)
    return rows


def spawn_ranks(world, profile, flag="--path-n-rank", tmp=None,
                timeout=N_RANK_TIMEOUT, path="N"):
    """N.2 and N.3 (R.2-R.4 with ``flag="--path-r-rank"``): ``world``
    processes of this script, gloo over a ``file://`` store in a fresh
    directory under chip_smoke_out/ (or ``tmp``), all on this card; each
    must exit 0 within ``timeout`` s (else all are killed and the run
    fails).  ``profile`` adds a profiled run of each N.2 solve to each
    rank.  Returns each rank's record."""
    import shutil
    import tempfile
    OUT.mkdir(exist_ok=True)
    own = tmp is None
    if own:
        tmp = Path(tempfile.mkdtemp(prefix="path_n_", dir=OUT))
    outs = wait_ranks(start_ranks(world, profile, flag, tmp), tmp, timeout,
                      path)
    if own:
        shutil.rmtree(tmp)
    return outs


def start_ranks(world, profile, flag, tmp):
    """Start ``world`` rank processes of this script (``flag RANK WORLD
    tmp``), each writing to ``tmp/rank{R}.log``: -> (processes, logs)."""
    # each rank writes to a file of its own: a rank blocked on a full
    # pipe would stall the other at its next collective
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               flag, str(r), str(world), str(tmp),
                               *(["--profile"] if profile else [])],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True, cwd=ROOT) for r in range(world)]
    return procs, logs


def wait_ranks(started, tmp, timeout, path):
    """Wait for the ranks :func:`start_ranks` started, at most ``timeout``
    s (then every one left is killed), print their logs and fail unless
    each exited 0: -> each rank's record (``tmp/rank{R}.pt``)."""
    import torch
    procs, logs = started
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        log = (tmp / f"rank{r}.log").read_text()
        print("\n".join(f"  [rank {r}] {line}" for line in log.splitlines()),
              flush=True)
        check(p.returncode == 0, f"{path}: rank {r} exited {p.returncode}")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(len(procs))]


def phase_path_n(y_main, st_main, syncs_main, y_d, profile):
    """Path N, the multi-device layer and the op registry on the card:
    N.1 the sharded ensemble BDF as a world of one, with no group and
    under an NCCL group of one, each bit for bit the main path's kernel
    run with its host syncs; N.4 the MeshVector overhead under that
    group; N.2 and N.3 in two gloo ranks on this card (the sharded
    Robertson run at 2**20 - 1 systems and path D's solver, and
    explicit MeshVector reductions); N.5 a per-op pin."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import batched, ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    from repro_torch.launch.mesh import WorldOfOne, make_ensemble_mesh
    from repro_torch.parallel import collectives as coll
    path, key = "N: multi-device", "N: sharded ensemble_bdf"
    dev = y_main.device
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    sub_s, runs, out = {}, [], {}
    # N.1: a world of one, in this process
    t = time.perf_counter()
    f, jac, y0, params = robertson_family_problem(NSYS, dev)

    def sharded(mesh=None):
        return lambda: batched.ensemble_bdf_integrate_sharded(
            f, jac, y0, 0.0, 10.0, params=params, mesh=mesh, opts=opts)

    check(isinstance(make_ensemble_mesh(), WorldOfOne),
          f"{path}: no group, but the layout is not a world of one")
    n1 = {}
    for label in ("no group", "NCCL group of one"):
        if label != "no group":
            dist.init_process_group("nccl", rank=0, world_size=1,
                                    store=dist.HashStore())
            mesh = make_ensemble_mesh()
            check(mesh.size() == 1 and mesh.mesh_dim_names == ("systems",),
                  f"{path}: the group of one's layout is {mesh}")
        (y, st), rec = n_run(path, f"N.1 {label}", sharded(), key)
        check(torch.equal(y, y_main), f"{path}: N.1 ({label}): y is not "
              "the main path's kernel run bit for bit")
        same_stats(path, f"N.1 ({label})", st, st_main)
        check(rec["loop"]["host_syncs"] == syncs_main,
              f"{path}: N.1 ({label}) made {rec['loop']['host_syncs']} "
              f"host syncs, the main path {syncs_main}")
        runs.append(rec)
        n1[label] = rec
        del y, st
    print(f"{path}: N.1 both runs equal the main path bit for bit, "
          f"{syncs_main} host syncs", flush=True)
    sub_s["N.1"] = time.perf_counter() - t
    print(f"N.1: {sub_s['N.1']:.1f} s", flush=True)
    out["N.1"] = n1
    prof = {}
    if profile:
        prof["N.1"] = profile_run("N.1 world of one", sharded(),
                                  n1["no group"]["wall_s"], True)
    # N.4: MeshVector's overhead, gspmd and explicit (group of one)
    t = time.perf_counter()
    out["N.4"] = n_overhead(dev)
    coll.close()
    sub_s["N.4"] = time.perf_counter() - t
    print(f"N.4: {sub_s['N.4']:.1f} s", flush=True)
    del f, jac, y0, params
    torch.cuda.empty_cache()
    # N.2 and N.3: two gloo ranks on this card
    t = time.perf_counter()
    ranks = spawn_ranks(N_WORLD, profile)
    nsys = NSYS - 1
    for r, rk in enumerate(ranks):
        check(torch.equal(rk["rob_y"].to(dev), y_main[:nsys]),
              f"{path}: N.2 rank {r}: the gathered y is not the main "
              "path's lanes bit for bit")
        same_stats(path, f"N.2 rank {r}", batched.EnsembleStats(
            *rk["rob_stats"]), st_main, lanes=nsys)
        nli, nps = rk["d_nli"], rk["d_npsolves"]
        own_nli = sum(o["d_own"][0] for o in ranks)
        own_nps = sum(o["d_own"][1] for o in ranks)
        check(bool((nli == own_nli).all()) and bool((nps == own_nps).all()),
              f"{path}: N.2 rank {r}: nli / npsolves are not the ranks' "
              f"totals {own_nli} / {own_nps} on every lane")
        agree(f"{path} N.2 D rank {r}", rk["d_y"].to(dev), y_d, C=100,
              what="path D's unsharded kernel run")
        runs.extend(rk["runs"])
    sub_s["N.2+N.3"] = time.perf_counter() - t
    print(f"{path}: N.2 both ranks' gathered y and stats equal the main "
          f"path's first {nsys} lanes bit for bit; D sharded: nli "
          f"{own_nli}, npsolves {own_nps} (the ranks' "
          f"{[o['d_own'] for o in ranks]}); N.3 within 1e-13, one "
          f"collective a reduction", flush=True)
    print(f"N.2+N.3: {sub_s['N.2+N.3']:.1f} s", flush=True)
    out["ranks"] = [{k: v for k, v in rk.items()
                     if k in ("timings", "n3", "d_own", "profile")}
                    for rk in ranks]
    # N.5: a per-op pin, the BDF lsolve's SpMV on its plain version
    t = time.perf_counter()
    rates = problems.robertson_rates(NSYS, seed=0)
    sub = {k: v[:NSUB] for k, v in rates.items()}
    pinned = ExecPolicy().override(blockdiag_spmv_soa="torch")
    def n5():
        return ivp.integrate(robertson_problem(NSUB, sub), 0.0, 10.0,
                             "ensemble_bdf", opts=opts._replace(policy=pinned))

    sol, rec = n_run(path, "N.5 pinned", n5, "N.5: pinned")
    out["N.5"] = {"run": rec, "agreement": agree(
        f"{path} N.5", sol.y, y_main[:NSUB], sol.retcodes,
        st_main.retcodes[:NSUB], what="the main path's kernel run")}
    runs.append(rec)
    if profile:
        prof["N.5"] = profile_run("N.5 pinned", n5, rec["wall_s"], True)
    sub_s["N.5"] = time.perf_counter() - t
    print(f"N.5: {sub_s['N.5']:.1f} s", flush=True)
    out.update({"kernels_run": {"counts": sum_counts(runs)}, "sub_s": sub_s,
                "profile": prof})
    return out


def path_n_rank(argv) -> int:
    """One rank of path N.2 and N.3 (``--path-n-rank RANK WORLD DIR
    [--profile]``): joins the gloo group through ``DIR/store``, runs its
    share and saves its record to ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import collectives as coll
    rank, world, tmp = int(argv[0]), int(argv[1]), Path(argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        rec = n_rank_work(rank, world, "--profile" in argv)
        torch.save(rec, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        coll.close()
    return 0


def n_rank_work(rank, world, profile):
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core import batched, dispatch, problems, vector
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.linsol import SPGMR
    from repro_torch.core.precond import BlockJacobiPrecond
    from repro_torch.launch.mesh import make_ensemble_mesh, mesh_device
    path = f"N rank {rank}"
    mesh = make_ensemble_mesh()
    dev = mesh_device(mesh)
    check(mesh.size() == world and dev.type == "cuda",
          f"{path}: layout {mesh}, device {dev}")
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    rec = {"runs": [], "timings": {}, "profile": {}}
    # N.2: the main path's systems but the last, sharded (one dummy)
    f, jac, y0, params = robertson_family_problem(NSYS - 1, dev)

    def rob():
        return batched.ensemble_bdf_integrate_sharded(
            f, jac, y0, 0.0, 10.0, params=params, mesh=mesh, opts=opts)

    (y, st), r = n_run(path, "N.2 Robertson", rob, "N: sharded ensemble_bdf")
    rec["runs"].append(r)
    rec["timings"]["N.2 Robertson"] = r["wall_s"]
    if profile:
        rec["profile"]["N.2 Robertson"] = profile_run(
            f"N.2 Robertson rank {rank}", rob, r["wall_s"], True)
    rec["rob_y"], rec["rob_stats"] = y.cpu(), tuple(
        None if v is None else v.cpu() for v in st)
    del f, jac, y0, params, y, st
    # N.2: path D's solver, sharded; each rank's own inner totals
    fb, jb, P = problems.brusselator_family(NX, device=dev)
    yb0 = problems.ensemble_brusselator(NBRUSS, nx=NX, device=dev)[3]
    pb = {"b": problems.brusselator_b(NBRUSS, device=dev)}
    own, real = [], batched.ensemble_bdf_integrate

    def spy(*a, **k):
        res = real(*a, **k)
        own.append((int(res[1].nli[0]), int(res[1].npsolves[0])))
        return res

    def d_run():
        return batched.ensemble_bdf_integrate_sharded(
            fb, jb, yb0, 0.0, 2.0, params=pb, mesh=mesh, opts=opts,
            jac_sparsity=P, linear_solver=SPGMR(
                tol=1e-10, restart=10, max_restarts=6,
                precond=BlockJacobiPrecond(block_size=2)))

    batched.ensemble_bdf_integrate = spy
    try:
        (y, st), r = n_run(path, "N.2 D", d_run, "D: ensemble_bdf SPGMR")
    finally:
        batched.ensemble_bdf_integrate = real
    if profile:
        rec["profile"]["N.2 D"] = profile_run(f"N.2 D rank {rank}", d_run,
                                              r["wall_s"], True)
    check(bool(st.ok.all()), f"{path}: N.2 D: a lane failed")
    rec["runs"].append(r)
    rec["timings"]["N.2 D"] = r["wall_s"]
    rec["d_y"], rec["d_own"] = y.cpu(), own[-1]
    rec["d_nli"], rec["d_npsolves"] = st.nli.cpu(), st.npsolves.cpu()
    del fb, jb, yb0, pb, y, st
    # N.3: explicit MeshVector reductions over an uneven split
    t0 = time.perf_counter()
    n = N3_SIZE
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    w = torch.rand(n, generator=gen, dtype=torch.float64, device=dev) + 0.1
    cuts = [0] + [n * (2 * k + 1) // (2 * world + 1) for k in range(1, world)] \
        + [n]
    lo, hi = cuts[rank], cuts[rank + 1]
    spec = vector.MeshVectorSpec(comm=mesh, mode="explicit")
    mx = vector.MeshVector(x[lo:hi].clone(), spec)
    mw = vector.MeshVector(w[lo:hi].clone(), spec)
    torch.cuda.synchronize()
    kernels.reset_counts()
    z = mx.linear_sum(0.5, -2.0, mw).data
    counts = kernels.counts()
    check(counts["linear_combination"] == (1, 0), f"{path}: N.3 linear_sum "
          f"ran row 12 as {counts['linear_combination']} (launches, plain)")
    rec["runs"].append({"counts": counts})
    check(torch.equal(z, dispatch.linear_sum(0.5, x, -2.0, w)[lo:hi]),
          f"{path}: N.3 linear_sum differs from the whole vector's")
    calls, all_reduce = [0], dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return all_reduce(*a, **k)

    dist.all_reduce = counted
    n3 = {}
    try:
        for name, fn, whole, kernel in (
                ("dot", lambda: mx.dot(mw), dispatch.dot(x, w), "dot"),
                ("wrms_norm", lambda: mx.wrms_norm(mw, global_size=n),
                 dispatch.wrms_norm(x, w), "wrms_ss"),
                ("l1_norm", mx.l1_norm, vector.l1_norm(x), None),
                ("max_norm", mx.max_norm, vector.max_norm(x), None),
                ("min", mx.min, vector.vmin(x), None)):
            torch.cuda.synchronize()
            kernels.reset_counts()
            c0 = calls[0]
            got = float(fn())
            counts = kernels.counts()
            check(calls[0] - c0 == 1, f"{path}: N.3 {name} issued "
                  f"{calls[0] - c0} collectives")
            if kernel is not None:
                check(counts[kernel][0] == 1, f"{path}: N.3 {name} launched "
                      f"{kernel} {counts[kernel][0]} times")
            check(all(c[1] == 0 for c in counts.values()),
                  f"{path}: N.3 {name} ran a plain version")
            want = float(whole)
            rel = abs(got - want) / abs(want)
            check(rel <= 1e-13 if kernel or name == "l1_norm" else
                  got == want, f"{path}: N.3 {name}: {got!r} against the "
                  f"whole vector's {want!r} (relative {rel:.3g})")
            n3[name] = {"value": got, "whole": want, "relative": rel}
            rec["runs"].append({"counts": counts})
    finally:
        dist.all_reduce = all_reduce
    rec["n3"] = n3
    rec["timings"]["N.3"] = time.perf_counter() - t0
    print(f"{path}: N.3 shard [{lo}, {hi}) of {n}: " + ", ".join(
        f"{k} rel {v['relative']:.2g}" for k, v in n3.items()), flush=True)
    return rec


def launch_floor_ms(fn, rounds=O_ROUNDS, launches=O_LAUNCHES):
    """Device milliseconds a launch of ``fn`` (a call that launches one
    kernel on a tiny input) back to back: a spin holds the device while
    the host enqueues ``launches`` calls between two events; the median
    over ``rounds``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        torch.cuda._sleep(O_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def stream_bytes_per_s(fn, moved, rounds=O_ROUNDS):
    """Bytes a second of ``fn`` moving ``moved`` bytes (median of
    ``rounds`` event-timed calls)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return moved / statistics.median(times)


def o_constants(card, dev):
    """O.1: the roofline row's constants measured on this card: one
    launch of a hand-written kernel (``newton_residual`` over 32
    systems), one plain elementwise launch (a product over 32
    elements), and the streamed bandwidth of a 1 GiB device copy and of
    a plain elementwise product over 1 GiB; the card's row by
    ``device_for``."""
    import torch
    from repro_torch.analysis.roofline import device_for, get_device
    from repro_torch.kernels import newton
    row = get_device(device_for(dev))
    z = torch.ones(1, 32, dtype=torch.float64, device=dev)
    g = torch.ones(32, dtype=torch.float64, device=dev)
    x = torch.ones(32, dtype=torch.float64, device=dev)
    out = {"row": row.name,
           "kernel_launch_s": launch_floor_ms(
               lambda: newton.newton_residual(z, z, z, g)) / 1e3,
           "plain_launch_s": launch_floor_ms(lambda: x * 1.5) / 1e3}
    n = O_GIB // 8
    a = torch.empty(n, dtype=torch.float64, device=dev).uniform_()
    b = torch.empty_like(a)
    out["copy_bytes_per_s"] = stream_bytes_per_s(lambda: b.copy_(a),
                                                 2 * O_GIB)
    out["elementwise_bytes_per_s"] = stream_bytes_per_s(
        lambda: torch.mul(a, 1.5, out=b), 2 * O_GIB)
    del a, b
    torch.cuda.empty_cache()
    props = torch.cuda.get_device_properties(dev)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    out["smem_optin_bytes"] = optin
    if optin is not None:
        check(optin >= row.smem_optin_bytes, f"O.1: the card lets a block "
              f"opt into {optin} B of shared memory, the row states "
              f"{row.smem_optin_bytes}")
    print(f"O.1 on {card}: row {row.name}; one kernel launch "
          f"{out['kernel_launch_s'] * 1e6:.3f} us (row "
          f"{row.kernel_launch * 1e6:.3f}), one plain elementwise launch "
          f"{out['plain_launch_s'] * 1e6:.3f} us (row "
          f"{row.plain_launch * 1e6:.3f}); 1 GiB copy "
          f"{out['copy_bytes_per_s'] / 1e12:.4f} TB/s (row cuda_bw "
          f"{row.cuda_bw / 1e12:.4f}), plain product "
          f"{out['elementwise_bytes_per_s'] / 1e12:.4f} TB/s (row torch_bw "
          f"{row.torch_bw / 1e12:.4f}); shared memory a block may opt "
          f"into {optin} B (row {row.smem_optin_bytes})", flush=True)
    return out


def main_path_grid():
    """The main path's signatures: rows 1-6, 4f, 1+2f, 1+2+3f and 6f at
    2**20 systems, n = b = 3 (and rows 1, 2, 1+2f, 3, 4 and 6, whose
    entries its loop no longer calls)."""
    from repro_torch.analysis.opcost import OpSig

    def sig(op, **kw):
        return OpSig(op, "float64", n=3, nsys=NSYS, **kw)
    return [sig("newton_update_soa", b=3),
            sig("newton_block_inverse_soa", b=3),
            sig("newton_residual_lsolve_soa", b=3),
            sig("newton_residual_soa"), sig("blockdiag_spmv_soa", b=3),
            sig("masked_update_wrms_soa"), sig("history_rescale_soa", k=6),
            sig("lagrange_rescale_soa", k=6), sig("wrms_soa"),
            sig("block_inverse_soa", b=3)]


def path_o_grid():
    """The tuner's grid of path O: ``autotune.tune_grid()`` (the
    reference tuner's signatures and the port's own ops'), then
    the paths' shapes of phase 3: the main path's, path M's decay chain,
    the n = 32 Brusselator ensemble of B, K, D-F, the §7 mesh's vectors
    and stage sums of G-J (a signature in both measured once)."""
    from repro_torch.analysis.opcost import OpSig
    from repro_torch.core import autotune

    def sig(op, n=0, nsys=0, b=0, k=0, nnz=0):
        return OpSig(op, "float64", n=n, nsys=nsys, b=b, k=k, nnz=nnz)
    out = autotune.tune_grid() + main_path_grid()
    for op in ("newton_residual_lsolve_soa", "newton_update_soa",
               "newton_block_inverse_soa"):
        out.append(sig(op, n=O_DECAY_N, nsys=NDECAY, b=O_DECAY_N))
    for n, nb in ((O_DECAY_N, NDECAY), (32, NBRUSS)):
        out += [sig("newton_residual_soa", n=n, nsys=nb),
                sig("masked_update_wrms_soa", n=n, nsys=nb),
                sig("lagrange_rescale_soa", n=n, nsys=nb, k=6),
                sig("wrms_soa", n=n, nsys=nb)]
    out.append(sig("history_rescale_soa", n=32, nsys=NBRUSS, k=6))
    for b, nb in ((O_DECAY_N, NDECAY), (2, NSYS), (16, NBRUSS),
                  (24, NBRUSS), (32, NBRUSS)):
        out.append(sig("blockdiag_spmv_soa", n=b, nsys=nb, b=b))
        out.append(sig("block_inverse_soa", n=b, nsys=nb, b=b))
    out.append(sig("block_solve_soa", n=3, nsys=NSYS, b=3))
    for b in (16, 24, 32):
        out.append(sig("block_solve_soa", n=b, nsys=NBRUSS, b=b))
    out.append(sig("bsr_spmv_soa", n=32, nsys=NBRUSS, b=1, nnz=124))
    out.append(sig("csr_spmv", n=O_MESH_N, nnz=4 * O_MESH_N))
    out.append(sig("linear_combination", n=32 * NBRUSS, k=3))
    # the §7 mesh's stage sums: one term (a stage's copy of y) to five
    for k in (1, 2, 5):
        out.append(sig("linear_combination", n=O_MESH_N, k=k))
    for n in (32, 32 * NBRUSS, O_MESH_N):
        out.append(sig("dot", n=n, k=1))
    out += [sig("scale_add_multi", n=O_MESH_N, k=3),
            sig("wrms_ss", n=O_MESH_N, k=1),
            sig("wrms_norm_mask", n=O_MESH_N, k=1),
            sig("dot_prod_multi", n=O_MESH_N, k=3)]
    return list({s.key(): s for s in out}.values())


def o_tune(card, tmp):
    """O.2: ``tune()`` over its grid into ``tmp``; every time finite and
    above 0; the file read back equal; the main path's signatures won by
    the kernels; the model agreeing on at least 80 % of the entries."""
    import math
    from repro_torch.core import autotune
    cache = autotune.tune(cases=path_o_grid(), reps=25)
    check(str(cache.path).startswith(str(tmp)),
          f"O.2: the cache went to {cache.path}, not under {tmp}")
    for e in cache.entries.values():
        check(all(math.isfinite(t) and t > 0 for t in (e.t_torch, e.t_cuda)),
              f"O.2: {e.sig.key()}: times {e.t_torch}, {e.t_cuda}")
    back = autotune.AutotuneCache(cache.device, path=cache.path).load()
    check(not back.stale and {k: (e.t_torch, e.t_cuda) for k, e in
                              back.entries.items()} ==
          {k: (e.t_torch, e.t_cuda) for k, e in cache.entries.items()},
          "O.2: save and load do not round-trip the entries")
    for sig in main_path_grid():
        e = cache.get(sig)
        check(e is not None and e.winner == "cuda",
              f"O.2: the main path's {sig.key()}: measured winner "
              f"{None if e is None else e.winner}")
    audit = autotune.model_audit(cache)
    print(f"O.2 on {card}: {len(cache.entries)} entries, model agreement "
          f"{audit['model_agree']}/{audit['model_total']} = "
          f"{audit['model_agreement']:.3f}; measured winners: "
          + ", ".join(f"{w} {sum(e.winner == w for e in cache.entries.values())}"
                      for w in autotune.BACKENDS), flush=True)
    for m in audit["mispredictions"]:
        print(f"  misprediction {m['sig']}: measured {m['measured']} "
              f"(torch/cuda {m['measured_ratio']}), predicted "
              f"{m['predicted']} ({m['predicted_ratio']})", flush=True)
    check(audit["model_agreement"] >= 0.8, f"O.2: the model agrees on "
          f"{audit['model_agreement']:.3f} of the entries, under 0.8")
    return {"entries": {k: e.to_json() for k, e in cache.entries.items()},
            **audit}


def o_auto_main(card, y_main, st_main, syncs_main, main_wall):
    """O.3: the main path under ``Context(policy=ExecPolicy())`` with the
    tuned cache: bit for bit the main path's kernel run with its host
    syncs, rows 1+2+3f, 4f, 5, 6f and no plain version; one decision a
    signature, each the kernel from the cache, their hits the op calls;
    the autotune gauges exported."""
    import torch
    from repro_torch.core import problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.context import Context
    from repro_torch.core.policies import ExecPolicy
    from repro_torch.observability import MetricsRegistry, context_metrics
    path = "O: auto main path"
    prob = robertson_problem(NSYS, problems.robertson_rates(NSYS, seed=0))
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)
    ctx = Context(policy=ExecPolicy())
    sol, rec = run_path(path, "kernels, tuned auto", prob, "ensemble_bdf",
                        10.0, opts, ctx=ctx)
    check(torch.equal(sol.y, y_main), f"{path}: y is not the main path's "
          "kernel run bit for bit")
    same_stats(path, "tuned auto", sol.stats, st_main)
    check(rec["loop"]["host_syncs"] == syncs_main, f"{path}: "
          f"{rec['loop']['host_syncs']} host syncs, the main path "
          f"{syncs_main}")
    rep = ctx.dispatch_report()
    decs = rep["decisions"]
    check(len({d["sig"] for d in decs}) == len(decs) and
          all(d["backend"] == "cuda" and d["source"] == "cache"
              for d in decs),
          f"{path}: decisions {[(d['sig'], d['backend'], d['source']) for d in decs]}")
    calls = sum(rec["counts"][k][0] + rec["counts"][k][1]
                for k in PATH_KERNELS[path])
    hits = sum(d["hits"] for d in decs)
    check(hits == calls, f"{path}: the decisions' hits {hits}, the op calls "
          f"{calls}")
    reg = MetricsRegistry()
    context_metrics(reg, ctx)
    text = reg.render()
    for name in ("repro_autotune_cache_entries",
                 "repro_autotune_decisions_total",
                 "repro_autotune_model_agreement"):
        check(f"\n{name} " in "\n" + text, f"{path}: context_metrics "
              f"exports no {name}")
    print(f"{path} on {card}: bit for bit the main path, {syncs_main} host "
          f"syncs; {len(decs)} decisions (cuda, from the cache), hits "
          f"{hits} = op calls; wall {rec['wall_s']:.3f} s against the main "
          f"path's {main_wall:.3f} s in this call", flush=True)
    return {"run": rec, "decisions": decs, "main_wall_s": main_wall}


def phase_path_o(card, y_main, st_main, syncs_main, main_wall):
    """Path O, the analysis layer: O.1 the roofline row's constants on
    this card, O.2 the autotuner over its grid into a temporary
    directory, O.3 the main path under the tuned ``"auto"``, O.4 sunlint's
    kernel-contract with the card present; the resolvers reset after."""
    import os
    import tempfile
    import torch
    from repro_torch.analysis import lint
    from repro_torch.core import autotune
    dev = y_main.device
    sub_s, out = {}, {}
    t = time.perf_counter()
    out["O.1"] = o_constants(card, dev)
    sub_s["O.1"] = time.perf_counter() - t
    old = os.environ.get("REPRO_TORCH_AUTOTUNE_DIR")
    OUT.mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=OUT) as tmp:
            os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = tmp
            t = time.perf_counter()
            out["O.2"] = o_tune(card, tmp)
            sub_s["O.2"] = time.perf_counter() - t
            torch.cuda.empty_cache()
            t = time.perf_counter()
            autotune.reset_resolver()
            out["O.3"] = o_auto_main(card, y_main, st_main, syncs_main,
                                     main_wall)
            sub_s["O.3"] = time.perf_counter() - t
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_DIR", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = old
        autotune.reset_resolver()
    t = time.perf_counter()
    ctx = lint.LintContext()
    check(ctx.cuda, "O.4: the lint context sees no card")
    found = lint.run_rules(ctx, ["kernel-contract"])
    check(not found, "O.4: kernel-contract on the card: "
          + "; ".join(f"{v.where}: {v.message}" for v in found))
    sub_s["O.4"] = time.perf_counter() - t
    print(f"O.4 on {card}: kernel-contract clean with the card present "
          f"({sum(len(s) for s in ctx.contract_sigs.values())} signatures "
          f"run on both implementations)", flush=True)
    for k, v in sub_s.items():
        print(f"{k}: {v:.1f} s", flush=True)
    out.update({"kernels_run": {"counts": out["O.3"]["run"]["counts"]},
                "sub_s": sub_s})
    return out


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


# ---------------------------------------------------------------------------
# path P: the model stack's serving half (models/, configs/, serve/decode)
# ---------------------------------------------------------------------------

#: path P's architecture (its FULL config: 24 layers, d_model 2048, 16
#: heads over 8 KV heads, d_ff 8192, vocab 92544); P.1's batch, prompt
#: and new tokens (numpy seed 0); P.2's sequence (numpy seed 1) and the
#: prompt its greedy generate starts from; P.3's layers and decode steps;
#: P.4's batch and cache (SHAPES["decode_32k"]'s 32768 tokens) and timed
#: steps; the smoke configs' batch and sequence (P.5)
P_ARCH = "internlm2-1.8b"
P_BATCH, P_PROMPT, P_NEW = 16, 128, 128
P2_LEN, P2_PROMPT = 32, 8
P3_LAYERS, P3_STEPS = 2, 4
P4_BATCH, P4_REPS = 8, 5
P4_LEN = None                    # None: SHAPES["decode_32k"].seq_len
P5_B, P5_S = 2, 16
#: decode against the forward pass: the reference's own tolerance
#: (|a - b| <= P_TOL + P_TOL*|b|, tests/test_archs.py:94); the card
#: against the CPU (P.3): max |card - cpu| <= P3_TOL * max(1, max |cpu|),
#: float32 on both
P_TOL, P3_TOL = 2e-3, 1e-4
#: the archs whose decode P.5 holds to their forward pass (float32), as
#: the reference's test does
P5_AGREE = ("internlm2-1.8b", "starcoder2-7b", "qwen2-72b")


def p_sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def p_peak_reset():
    import torch
    p_sync()
    torch.cuda.reset_peak_memory_stats()


def p_peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


class FiniteSteps:
    """A ``Model`` that also notes, on the device, whether each decode
    step's logits are finite (no host read); everything else is the
    model's."""

    def __init__(self, model):
        self.model, self.finite = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, batch, caches, *pctx):
        import torch
        logits, caches = self.model.decode_step(params, batch, caches, *pctx)
        self.finite.append(torch.isfinite(logits).all())
        return logits, caches


def p_model(name, dtype=None):
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(name)
    return FiniteSteps(Model(cfg if dtype is None else
                             cfg.replace(dtype=dtype)))


def p_tokens(seed, shape, vocab, dev):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape, np.int32)).to(dev)


def p_bytes(tree):
    from repro_torch.models import spec
    return sum(t.numel() * t.element_size() for t in spec.tree_leaves(tree))


def p_aten_calls(run):
    """The aten calls (views included) that ``run()`` dispatches: the
    host's work of a decode step in eager PyTorch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    return Count.calls


def p_generate(model, params, dev):
    """P.1: greedy generate at the full width, bf16."""
    import torch
    from repro_torch.serve import decode
    cfg = model.cfg
    warm = time.perf_counter()
    decode.generate(model, params, p_tokens(0, (P_BATCH, 4), cfg.vocab_size,
                                            dev), 4, device=dev)
    p_sync()
    warm = time.perf_counter() - warm
    model.finite.clear()
    prompt = p_tokens(0, (P_BATCH, P_PROMPT), cfg.vocab_size, dev)
    p_peak_reset()
    t0 = time.perf_counter()
    out = decode.generate(model, params, prompt, P_NEW, device=dev)
    p_sync()
    wall = time.perf_counter() - t0
    steps = P_PROMPT + P_NEW
    check(out.shape == (P_BATCH, steps), f"P.1: tokens of shape {out.shape}")
    check(torch.equal(out[:, :P_PROMPT], prompt), "P.1: the prompt changed")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          "P.1: a token out of range")
    check(len(model.finite) == steps and bool(torch.stack(
        model.finite).all()), "P.1: non-finite logits")
    caches = model.init_cache(P_BATCH, steps, device=dev)
    calls = p_aten_calls(lambda: model.decode_step(
        params, {"tokens": prompt[:, :1], "pos": 0}, caches))
    rec = {"batch": P_BATCH, "prompt": P_PROMPT, "new": P_NEW,
           "wall_s": wall, "warmup_s": warm, "steps": steps,
           "aten_calls_per_step": calls,
           "ms_per_step": 1e3 * wall / steps,
           "new_tokens_per_s": P_BATCH * P_NEW / wall,
           "tokens_per_s": P_BATCH * steps / wall,
           "peak_gib": p_peak_gib()}
    print(f"P.1 generate {cfg.name} bf16, batch {P_BATCH}, prompt "
          f"{P_PROMPT} + {P_NEW} new (max_len {steps}): wall {wall:.3f} s "
          f"(first call {warm:.3f} s), {rec['ms_per_step']:.3f} ms a "
          f"decode step, {rec['new_tokens_per_s']:.1f} new tokens/s "
          f"({rec['tokens_per_s']:.1f} tokens/s with the prefill), peak "
          f"{rec['peak_gib']:.2f} GiB; {calls} aten calls a step", flush=True)
    return rec


def p_decode_all(model, params, toks, dev):
    """Logits (B, S, V) of decoding ``toks`` token by token."""
    import torch
    B, S = toks.shape
    caches = model.init_cache(B, S, device=dev)
    return torch.cat([model.decode_step(params, {"tokens": toks[:, i:i + 1],
                                                 "pos": i}, caches)[0]
                      for i in range(S)], dim=1), caches


def p_float32(model32, params32, dev):
    """P.2: float32 at full depth and width: decode against the forward
    pass, greedy generate against its argmax."""
    import torch
    from repro_torch.serve import decode
    V = model32.cfg.vocab_size
    toks = p_tokens(1, (1, P2_LEN), V, dev)
    t0 = time.perf_counter()
    full = model32.forward(params32, {"tokens": toks})
    dec, _ = p_decode_all(model32, params32, toks, dev)
    p_sync()
    wall = time.perf_counter() - t0
    diff = (dec - full).abs()
    check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
          "P.2: non-finite logits")
    over = float((diff - (P_TOL + P_TOL * full.abs())).max())
    check(over <= 0, f"P.2: decode against the forward pass exceeds "
          f"{P_TOL} + {P_TOL}*|forward| by {over:.3g}")
    seq = decode.generate(model32, params32, toks[:, :P2_PROMPT],
                          P2_LEN - P2_PROMPT, device=dev)
    lg = model32.forward(params32, {"tokens": seq})[0, P2_PROMPT - 1:-1]
    want = seq[0, P2_PROMPT:].long()
    top = lg.argmax(-1)
    bad = (top != want).nonzero().flatten().tolist()
    # a differing token is allowed only where the forward pass's top two
    # logits lie within the tolerance of each other (a near-tie)
    gaps = [float(lg[i, top[i]] - lg[i, want[i]]) for i in bad]
    check(all(g <= 2 * (P_TOL + P_TOL * float(lg[i].abs().max()))
              for i, g in zip(bad, gaps)),
          f"P.2: greedy generate differs from the forward pass's argmax at "
          f"{bad} (gaps {gaps})")
    rec = {"len": P2_LEN, "max_abs_diff": float(diff.max()),
           "max_abs_logit": float(full.abs().max()),
           "generate_mismatches": len(bad), "near_tie_gaps": gaps,
           "wall_s": wall, "peak_gib": p_peak_gib()}
    print(f"P.2 float32 {model32.cfg.name} full depth: decode against the "
          f"forward pass over {P2_LEN} tokens: max |diff| "
          f"{rec['max_abs_diff']:.3g} (max |logit| "
          f"{rec['max_abs_logit']:.3g}, gate {P_TOL} + {P_TOL}*|logit|); "
          f"greedy generate {P2_PROMPT} + {P2_LEN - P2_PROMPT} against the "
          f"forward argmax: {len(bad)} differing (near-ties {gaps}); "
          f"{wall:.3f} s, peak {rec['peak_gib']:.2f} GiB", flush=True)
    return rec


def p_card_vs_cpu(model32, params32, dev):
    """P.3: the same float32 weights cut to P3_LAYERS layers, one forward
    pass and P3_STEPS decode steps on the card and on the CPU."""
    import torch
    from repro_torch.models import spec
    from repro_torch.models.transformer import Model
    cfg = model32.cfg.replace(n_layers=P3_LAYERS)
    model = Model(cfg)
    cut = {k: (spec.tree_map(lambda a: a[:P3_LAYERS], v) if k == "layers"
               else v) for k, v in params32.items()}
    toks = p_tokens(2, (2, 16), cfg.vocab_size, dev)
    runs = {}
    for where in (dev, torch.device("cpu")):
        params = spec.tree_map(lambda a: a.to(where), cut)
        t = toks.to(where)
        full = model.forward(params, {"tokens": t})
        dec, caches = p_decode_all(model, params, t[:, :P3_STEPS], where)
        runs[where.type] = (full, dec, caches["k"], caches["v"])
    errs = {}
    for name, a, b in zip(("forward", "decode", "cache k", "cache v"),
                          runs[dev.type], runs["cpu"]):
        a = a.cpu()
        scale = max(1.0, float(b.abs().max()))
        errs[name] = float((a - b).abs().max()) / scale
        check(errs[name] <= P3_TOL, f"P.3: {name} on the card differs from "
              f"the CPU by {errs[name]:.3g} of its scale (gate {P3_TOL})")
    print(f"P.3 {P3_LAYERS} layers float32, card against CPU, max |diff| / "
          f"max(1, max |cpu|): " + ", ".join(f"{k} {v:.3g}" for k, v in
                                              errs.items())
          + f" (gate {P3_TOL})", flush=True)
    return {"layers": P3_LAYERS, "steps": P3_STEPS, "rel_err": errs}


def p_long_cache(model, params, dev, profile=False):
    """P.4: one decode step against a SHAPES["decode_32k"] cache, bf16."""
    import torch
    from repro_torch.models import SHAPES
    length = P4_LEN or SHAPES["decode_32k"].seq_len
    p_peak_reset()
    caches = model.init_cache(P4_BATCH, length, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for leaf in (caches["k"], caches["v"]):
        leaf.normal_(generator=gen)
    kv_bytes = caches["k"].numel() * caches["k"].element_size() * 2
    w_bytes = p_bytes(params)
    toks = p_tokens(3, (P4_BATCH, 1), model.cfg.vocab_size, dev)
    pos = length - 1
    def step():
        caches["pos"].fill_(pos)
        return model.decode_step(params, {"tokens": toks, "pos": pos},
                                 caches)[0]

    calls = p_aten_calls(step)       # also the warm-up step
    times = []
    for _ in range(P4_REPS):
        p_sync()
        t0 = time.perf_counter()
        logits = step()
        p_sync()
        times.append(1e3 * (time.perf_counter() - t0))
    check(logits.shape == (P4_BATCH, 1, model.cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), "P.4: non-finite logits")
    check(caches["pos"].tolist() == [length] * model.cfg.n_layers,
          "P.4: the cache position did not advance")
    ms = statistics.median(times)
    prof = p_profile("P.4 long cache", step) if profile else None
    bound = 1e3 * (w_bytes + kv_bytes) / HBM_BYTES_PER_S
    rec = {"batch": P4_BATCH, "cache_len": length, "pos": pos,
           "kv_gb": kv_bytes / 1e9, "weight_gb": w_bytes / 1e9,
           "ms_per_step": ms, "ms_all": times, "bound_ms": bound,
           "aten_calls": calls, "peak_gib": p_peak_gib(), "profile": prof}
    print(f"P.4 one decode step at pos {pos} over a {length}-token cache, "
          f"batch {P4_BATCH}, bf16: {ms:.3f} ms (median of {P4_REPS}: "
          + ", ".join(f"{t:.3f}" for t in times) + f"); KV cache "
          f"{rec['kv_gb']:.2f} GB + weights {rec['weight_gb']:.2f} GB, "
          f"bound {bound:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s "
          f"({100 * bound / ms:.1f} % of it); peak {rec['peak_gib']:.2f} "
          f"GiB; {calls} aten calls", flush=True)
    del caches
    return rec


def p_smoke(dev):
    """P.5: every arch's smoke config: a forward pass and a decode step
    (bf16, finite); decode against the forward pass for P5_AGREE
    (float32, the reference's tolerance)."""
    import numpy as np
    import torch
    from repro_torch import configs
    out = {}
    for arch in configs.ARCH_IDS:
        model = p_model(f"{arch}-smoke")
        cfg = model.cfg
        params = model.init(0, device=dev)
        rng = np.random.default_rng(5)
        batch = {"tokens": p_tokens(5, (P5_B, P5_S), cfg.vocab_size, dev),
                 "targets": p_tokens(6, (P5_B, P5_S), cfg.vocab_size, dev)}
        if cfg.mrope:
            batch["vis_embeds"] = torch.from_numpy(0.02 * rng.standard_normal(
                (P5_B, 4, cfg.d_model))).to(dev, cfg.dtype)
        if cfg.enc_dec:
            batch["frames"] = torch.from_numpy(0.02 * rng.standard_normal(
                (P5_B, 8, cfg.d_model))).to(dev, cfg.dtype)
        logits = model.forward(params, batch)
        loss = model.loss(params, batch)
        db = {"tokens": batch["tokens"][:, :1], "pos": 0}
        if cfg.enc_dec:
            db["enc_out"] = 0.02 * torch.ones((P5_B, 8, cfg.d_model),
                                              dtype=cfg.dtype, device=dev)
        step, _ = model.decode_step(params, db, model.init_cache(
            P5_B, P5_S, device=dev))
        check(bool(torch.isfinite(logits.float()).all()
                   and torch.isfinite(step.float()).all()
                   and torch.isfinite(loss)), f"P.5 {arch}: non-finite")
        check(step.shape == (P5_B, 1, cfg.vocab_size), f"P.5 {arch}: shape")
        rec = {"loss": float(loss)}
        if arch in P5_AGREE:
            m32 = p_model(f"{arch}-smoke", torch.float32)
            p32 = m32.init(0, device=dev)
            toks = batch["tokens"][:1, :6]
            full = m32.forward(p32, {"tokens": toks})
            dec, _ = p_decode_all(m32, p32, toks, dev)
            over = float(((dec - full).abs() - (P_TOL + P_TOL *
                                                 full.abs())).max())
            check(over <= 0, f"P.5 {arch}: decode against the forward pass "
                  f"exceeds the tolerance by {over:.3g}")
            rec["decode_vs_forward"] = float((dec - full).abs().max())
        out[arch] = rec
    print("P.5 smoke configs on the card (forward, loss, decode step finite"
          "; decode against forward, float32): " + ", ".join(
              f"{a} loss {r['loss']:.4g}" + (
                  f" |diff| {r['decode_vs_forward']:.2g}"
                  if "decode_vs_forward" in r else "")
              for a, r in out.items()), flush=True)
    return out


def p_walker(dev):
    """P.6: sunlint's dispatch walker over the main path's first BDF (and
    DIRK) steps on the card, under the kernels."""
    from repro_torch import kernels
    from repro_torch.analysis import hotloop, lint
    ctx = lint.LintContext()
    ctx.hot_loop_targets = hotloop.robertson_targets(nsys=NSYS, device=dev,
                                                     steps=4)
    kernels.reset_counts()
    found = lint.run_rules(ctx, ["hot-loop-layout", "dtype-drift"])
    counts = kernels.counts()
    for name in ("newton_update", "newton_block_inverse", "newton_residual",
                 "block_solve"):
        check(counts[name][0] > 0, f"P.6: kernel {name} was not launched")
    check(all(v[1] == 0 for v in counts.values()),
          "P.6: a plain version ran on the card")
    baseline = lint.load_baseline(ctx.baseline_path)
    kept = [v for v in found if not lint.is_suppressed(v, baseline)]
    calls = {t.name: ctx.hot_loop_trace(t).calls
             for t in ctx.hot_loop_targets}
    for v in kept:
        print(f"P.6 {v.rule}: {v.where}: {v.message}", flush=True)
    check(not kept, f"P.6: {len(kept)} findings outside the baseline")
    print(f"P.6 walker on the card ({NSYS} systems, 4 steps): aten calls "
          f"in the Newton trips {calls}, {len(found)} findings, "
          f"{len(found) - len(kept)} baselined", flush=True)
    return {"calls": calls, "findings": len(found),
            "kernel_launches": {k: v[0] for k, v in counts.items()
                                if v[0]}}


def p_profile(label, run):
    """``run()`` once unprofiled (timed) and once under the profiler
    (:func:`profile_run`): the device's busy share of its wall."""
    p_sync()
    t0 = time.perf_counter()
    run()
    p_sync()
    return profile_run(label, run, time.perf_counter() - t0)


def phase_path_p(card, profile=False):
    """Path P: the model stack's serving half at internlm2-1.8b's full
    width (P.1-P.4), every arch's smoke config (P.5), and the walker on
    the card (P.6).  P.1-P.5 launch no kernel of the port.  ``profile``
    adds a profiled run of P.1's generate (32 decode steps) and of one
    P.4 step."""
    import torch
    from repro_torch import kernels
    dev = torch.device("cuda")
    print(card, flush=True)
    torch.cuda.empty_cache()
    rec = {}
    kernels.reset_counts()
    with torch.no_grad():
        model = p_model(P_ARCH)
        t0 = time.perf_counter()
        params = model.init(0, device=dev)
        p_sync()
        rec["init_s"] = time.perf_counter() - t0
        rec["weight_gb"] = p_bytes(params) / 1e9
        print(f"P {P_ARCH}: weights {rec['weight_gb']:.3f} GB bf16 drawn "
              f"on the card in {rec['init_s']:.3f} s", flush=True)
        rec["P.1"] = p_generate(model, params, dev)
        if profile:
            from repro_torch.serve import decode
            prompt = p_tokens(0, (P_BATCH, 16), model.cfg.vocab_size, dev)
            rec["P.1"]["profile"] = p_profile(
                "P.1 generate", lambda: decode.generate(
                    model, params, prompt, 16, device=dev))
        model32 = p_model(P_ARCH, torch.float32)
        params32 = model32.init(0, device=dev)
        rec["P.2"] = p_float32(model32, params32, dev)
        rec["P.3"] = p_card_vs_cpu(model32, params32, dev)
        del params32
        torch.cuda.empty_cache()
        rec["P.4"] = p_long_cache(model, params, dev, profile)
        del params
        torch.cuda.empty_cache()
        rec["P.5"] = p_smoke(dev)
    counts = kernels.counts()
    check(all(v == (0, 0) for v in counts.values()),
          f"path P launched a kernel or a plain version: {counts}")
    print("path P: kernel launches " + ", ".join(
        f"{k} {v[0]}" for k, v in counts.items()), flush=True)
    rec["kernels_run"] = {"counts": counts}
    rec["P.6"] = p_walker(dev)
    return rec


# ---------------------------------------------------------------------------
# path Q: the model stack's training half (data/, optim/, train/, launch/)
# ---------------------------------------------------------------------------

#: path Q's architecture (P's: internlm2-1.8b FULL, bf16, remat on); Q.1's
#: batch, sequence, steps and learning rate (warmup 1, total_steps Q_STEPS,
#: synthetic_batch seed 0); Q.2's microbatches; Q.3's layers (the FULL
#: width cut), batch and sequence (float32); Q.4's smoke arch, steps,
#: crash point, batch and sequence; Q.5's gradient flow (heun_euler,
#: tests/test_train_infra.py:149-160)
Q_ARCH = "internlm2-1.8b"
Q_BATCH, Q_SEQ, Q_STEPS, Q_LR = 8, 512, 6, 3e-4
Q2_MICRO = 4
Q3_LAYERS, Q3_BATCH, Q3_SEQ = 2, 2, 64
Q4_ARCH, Q4_STEPS, Q4_CRASH, Q4_BATCH, Q4_SEQ = \
    "internlm2-1.8b-smoke", 6, 3, 8, 64
Q5_TAU, Q5_MAX_STEPS = 0.1, 6
#: the H100 SXM's dense bf16 tensor-core peak (FLOP/s)
BF16_DENSE_FLOPS = 989e12
#: Q.1: row 16 against its plain version on the full-width gradients,
#: each leaf's dot and the global norm within Q_DOT_RTOL relative.
#: Q.2 (the reference's own microbatch check, tests/test_train_infra.py:
#: 53-62, with atol 2*lr + one bf16 ulp): the loss within Q2_LOSS_RTOL
#: relative, params within Q2_RTOL*|p| + 2*lr + ulp(max(|p|, |p'|)), the
#: ulp of the larger of the two bf16 results.  The float32 gradient each
#: run fed AdamW (its first moment over (1 - b1) times the clip scale),
#: leaf by leaf within Q2_GRAD_RTOL of its norm, and the gradient norm
#: within Q2_NORM_RTOL relative.  The bounds sit below the smallest
#: accumulation fault: a lost or doubled microbatch of four moves a
#: leaf's gradient by 25 % or more and the norm by 13 % or more, a
#: missing 1/microbatches scale both by 300 %, a flipped sign the
#: gradient by 200 %.  Legitimately the bf16 backward differs with the
#: batch it runs (its GEMMs' shapes): 2.0-2.3 % a leaf and 1.2e-4 in the
#: norm at this width, well inside the bf16 gradient's own distance from
#: a float32 run of the same weights (printed beside them; 1.3 of its
#: norm on the layers' leaves).  Q.3 (card against CPU, float32): the
#: loss within 1e-5 relative, params within 2*lr + 1e-6; the gradients,
#: by leaf in the norm, within Q3_SPREAD times the CPU's own float32
#: error (its float32 gradient against one with float64 weights) + 1e-4,
#: the gradient norm likewise + 1e-4 relative, and the moments within
#: the bound of their gradients and clip scales.  The "scaled" init
#: reads a stacked leaf's layers axis as its fan-in (the reference's
#: too), so the attention softmax is one-hot and its backward cancels:
#: float32 loses about 1 % of those gradients on either device and in
#: either package (tools/grad_float64_witness.py: the same weights
#: against a float64 truth), so a fixed 1e-4 cannot hold, while a wrong
#: gradient misses by far more
Q_DOT_RTOL = 1e-4
Q2_LOSS_RTOL, Q2_GRAD_RTOL, Q2_NORM_RTOL, Q2_RTOL = 1e-4, 0.1, 1e-3, 3e-2
Q3_LOSS_RTOL, Q3_NORM_RTOL, Q3_MOMENT_TOL, Q3_PARAM_ATOL = \
    1e-5, 1e-4, 1e-4, 1e-6
Q3_SPREAD = 3.0
#: the kernels each sub-run of Q launches (rows 16; 12 and 14)
Q_KERNELS = {"Q.1": ("dot",), "Q.5": ("linear_combination", "wrms_ss")}


def q_counted(what, run, kernels_of=(), launched=None):
    """``run()`` with the launch counts zeroed just before and read just
    after: every kernel of ``kernels_of`` launched (``launched``: name ->
    the exact count), no plain version on the card.  -> (out, counts)."""
    from repro_torch import kernels
    p_sync()
    kernels.reset_counts()
    out = run()
    p_sync()
    counts = kernels.counts()
    for name in kernels_of:
        check(counts[name][0] > 0, f"{what}: kernel {name} was not launched")
    for name, n in (launched or {}).items():
        check(counts[name][0] == n, f"{what}: kernel {name} launched "
              f"{counts[name][0]} times, not {n}")
    check(all(v[1] == 0 for v in counts.values()),
          f"{what}: a plain version ran on the card: {counts}")
    return out, counts


def q_add(total, counts):
    for k, (a, b) in counts.items():
        x, y = total.get(k, (0, 0))
        total[k] = (x + a, y + b)


def q_batches(vocab, seq, batch, steps, dev, seed=0):
    import torch
    from repro_torch.data import pipeline
    d = pipeline.DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch,
                            seed=seed)
    return [{k: torch.from_numpy(v).to(dev) for k, v in
             pipeline.synthetic_batch(d, i).items()} for i in range(steps)]


def q_ulp_bf16(t):
    """One bfloat16 ulp of each element's magnitude (8 significant bits)."""
    import torch
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def q_train(card, dev, total):
    """Q.1: the launcher's path at the full width: Q_STEPS AdamW steps of
    make_train_step over synthetic_batch, bf16, remat on."""
    import torch
    from repro_torch import configs
    from repro_torch.models import Model, spec
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    cfg = configs.get(Q_ARCH)
    check(cfg.remat and cfg.dtype == torch.bfloat16, "Q: the FULL config "
          "is not bf16 with remat on")
    model = Model(cfg)
    ocfg = adamw.AdamWConfig(lr=Q_LR, warmup_steps=1, total_steps=Q_STEPS)
    batches = q_batches(cfg.vocab_size, Q_SEQ, Q_BATCH, Q_STEPS, dev)
    p_peak_reset()
    state = tstep.init_state(model, 0, ocfg, device=dev)
    n_params = spec.param_count(model.specs())
    n_layer = spec.param_count(model.specs()["layers"])
    n_leaves = len(spec.tree_leaves(state.params))
    train = tstep.make_train_step(model, ocfg=ocfg)
    times, mets = [], []

    def steps():
        nonlocal state
        for b in batches:
            p_sync()
            t0 = time.perf_counter()
            state, met = train(state, b)
            p_sync()
            times.append(1e3 * (time.perf_counter() - t0))
            mets.append(met)

    _, counts = q_counted("Q.1", steps, Q_KERNELS["Q.1"],
                          {"dot": n_leaves * Q_STEPS})
    q_add(total, counts)
    peak = p_peak_gib()
    norm_check = q_norm_check(model, state, batches[-1])
    loss = [float(m["loss"]) for m in mets]
    gnorm = [float(m["grad_norm"]) for m in mets]
    lr = [float(m["lr"]) for m in mets]
    check(all(math.isfinite(x) and x > 0 for x in loss + gnorm),
          f"Q.1: a loss or grad norm not finite and > 0: {loss} {gnorm}")
    check(loss[-1] < loss[0], f"Q.1: the loss did not fall: {loss}")
    ms = statistics.median(times[1:])
    tokens = Q_BATCH * Q_SEQ
    flops = 6 * n_params * tokens + 2 * n_layer * tokens
    prof = p_profile("Q.1 train step", lambda: train(state, batches[0]))
    busy = prof["device_busy_s"] / prof["unprofiled_wall_s"]
    rec = {"arch": Q_ARCH, "params": n_params, "leaves": n_leaves,
           "batch": Q_BATCH, "seq": Q_SEQ, "loss": loss, "grad_norm": gnorm,
           "lr": lr, "ms_all": times, "ms_per_step": ms,
           "tokens_per_s": tokens / (ms / 1e3), "model_flops": flops,
           "peak_flops_share": flops / (ms / 1e3) / BF16_DENSE_FLOPS,
           "peak_gib": peak, "dot_launches": counts["dot"][0],
           "device_busy_share": busy, "profile": prof,
           "global_norm_check": norm_check}
    print(f"Q.1 {Q_ARCH} bf16 remat, {n_params / 1e9:.3f} B params in "
          f"{n_leaves} leaves, batch {Q_BATCH} x {Q_SEQ}, {Q_STEPS} AdamW "
          f"steps: loss " + " ".join(f"{x:.4f}" for x in loss) + ", grad "
          "norm " + " ".join(f"{x:.4g}" for x in gnorm) + f"; {ms:.2f} ms a "
          f"step (median of steps 2-{Q_STEPS}: " + ", ".join(
              f"{t:.2f}" for t in times) + f"), {rec['tokens_per_s']:.0f} "
          f"tokens/s, {100 * rec['peak_flops_share']:.1f} % of "
          f"{BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s (6*N*T + remat's 2*N_layers"
          f"*T = {flops / 1e12:.2f} TFLOP a step), device busy "
          f"{100 * busy:.1f} %, peak {peak:.2f} GiB; row 16 (dot) launched "
          f"{counts['dot'][0]} times ({n_leaves} a step)", flush=True)
    del state, train
    torch.cuda.empty_cache()
    return rec, model, ocfg, batches[0]


def q_norm_check(model, state, batch):
    """Row 16 at Q.1's shapes: the gradients at the last step's params
    and batch (every full-width leaf, 2048 to 189.5 M elements), each
    leaf's float32 dot by the kernel (``adamw.global_norm``'s route)
    against its plain version, and the global norm against theirs, each
    within Q_DOT_RTOL relative.  These launches compare and are not
    counted."""
    import torch
    from repro_torch.core import dispatch
    from repro_torch.core.policies import ExecPolicy
    from repro_torch.models import spec
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    _, grads = tstep.value_and_grad(model.loss, state.params, batch)
    pin = ExecPolicy().override(dot="torch")
    errs, plain, k64, p64 = [], [], [], []
    for g in spec.tree_leaves(grads):
        g32 = g.to(torch.float32)
        k = float(dispatch.dot(g32, g32))
        w = float(dispatch.dot(g32, g32, pin))
        errs.append((g.numel(), abs(k - w) / abs(w)))
        plain.append(w)
        # both against a float64 dot of the same float32 leaf
        d = g32.double().ravel()
        exact = float(torch.dot(d, d))
        k64.append(abs(k - exact) / exact)
        p64.append(abs(w - exact) / exact)
        del g32, d
    gn = float(adamw.global_norm(grads))
    want = math.sqrt(sum(plain))
    norm_err = abs(gn - want) / want
    bad = [(i, n, e) for i, (n, e) in enumerate(errs) if not e <= Q_DOT_RTOL]
    check(not bad, f"Q.1: row 16 against its plain version past "
          f"{Q_DOT_RTOL} relative (leaf, elements, rel): {bad}")
    check(norm_err <= Q_DOT_RTOL, f"Q.1: global_norm {gn} against the "
          f"plain dots' {want} (rel {norm_err:.3g})")
    fault = [(i, a, b) for i, (a, b) in enumerate(zip(k64, p64))
             if a > R_DOT_FAULT * b + 1e-6]
    print("Q.1 row 16 and its plain version against a float64 dot of the "
          "same leaf, rel per leaf (kernel/plain): " + ", ".join(
              f"{a:.2g}/{b:.2g}" for a, b in zip(k64, p64)), flush=True)
    check(not fault, f"Q.1: row 16's error past {R_DOT_FAULT}x its plain "
          f"version's (leaf, kernel, plain): {fault}")
    del grads
    torch.cuda.empty_cache()
    print(f"Q.1 row 16 (dot) against its plain version on the last step's "
          f"gradients, per leaf (elements: rel) "
          + ", ".join(f"{n}: {e:.2g}" for n, e in errs)
          + f"; global norm {gn:.6g} against {want:.6g} (rel "
          f"{norm_err:.3g}, gate {Q_DOT_RTOL})", flush=True)
    return {"leaf_rel": [e for _, e in errs],
            "leaf_elements": [n for n, _ in errs], "norm_rel": norm_err,
            "kernel_rel_f64": k64, "plain_rel_f64": p64}


def q_microbatches(model, ocfg, batch, loss_q1, dev, total):
    """Q.2: step 0's batch with Q2_MICRO microbatches against one, each
    from the same initial weights: the loss, the gradient norm, the
    float32 gradient AdamW took (read back from the first moment, so a
    fault in the float32 sum or the 1/microbatches scale shows there) and
    the params; beside them the one-microbatch bf16 gradient against a
    float32 run of the same weights."""
    import torch
    from repro_torch.models import Model, spec
    from repro_torch.train import step as tstep
    runs = {}
    for micro in (1, Q2_MICRO):
        state = tstep.init_state(model, 0, ocfg, device=dev)
        train = tstep.make_train_step(model, ocfg=ocfg, microbatches=micro)
        (state, met), counts = q_counted(f"Q.2 ({micro})",
                                         lambda: train(state, batch),
                                         ("dot",))
        q_add(total, counts)
        runs[micro] = (state, met)
        del train
    (one, met1), (four, met4) = runs[1], runs[Q2_MICRO]
    loss, want = float(met4["loss"]), float(met1["loss"])
    check(abs(loss - want) <= Q2_LOSS_RTOL * abs(want),
          f"Q.2: loss {loss} with {Q2_MICRO} microbatches against {want}")
    gn, gn1 = float(met4["grad_norm"]), float(met1["grad_norm"])
    gn_rel = abs(gn - gn1) / gn1
    check(gn_rel <= Q2_NORM_RTOL, f"Q.2: gradient norm {gn} with "
          f"{Q2_MICRO} microbatches against {gn1} (rel {gn_rel:.3g})")

    def grads(state, gnorm):
        # m = (1 - b1) * g * min(1, clip / |g|) after one step from m = 0
        k = (1 - ocfg.b1) * min(1.0, ocfg.clip_norm / max(gnorm, 1e-9))
        return [m / k for m in spec.tree_leaves(state.opt.m)]

    g1, g4 = grads(one, gn1), grads(four, gn)
    g_rel = [q_rel(a, b) for a, b in zip(g4, g1)]
    del g4
    bad = [(i, r) for i, r in enumerate(g_rel) if not r <= Q2_GRAD_RTOL]
    check(not bad, f"Q.2: gradients (leaf, norm-relative) past "
          f"{Q2_GRAD_RTOL}: {bad}")
    lr = float(met4["lr"])
    over, strict = -math.inf, 0.0
    for a, b in zip(spec.tree_leaves(four.params),
                    spec.tree_leaves(one.params)):
        diff = (a.float() - b.float()).abs()
        # each side rounded to bf16 at its own magnitude: one ulp of the
        # larger
        slack = 2 * lr + q_ulp_bf16(torch.maximum(a.float().abs(),
                                                  b.float().abs()))
        over = max(over, float((diff - slack - Q2_RTOL * b.float().abs())
                               .max()))
        strict = max(strict, float((diff - slack).max()))
    check(over <= 0, f"Q.2: params past the reference's bound by {over:.3g}")
    del runs, one, four
    torch.cuda.empty_cache()
    # the bf16 gradient's own distance from float32 on the same weights
    m32 = Model(model.cfg.replace(dtype=torch.float32))
    p32 = spec.tree_map(lambda a: a.float(), model.init(0, device=dev))
    _, gf = tstep.value_and_grad(m32.loss, p32, batch)
    del p32
    bf16_rel = [q_rel(a, b) for a, b in zip(g1, spec.tree_leaves(gf))]
    del g1, gf
    torch.cuda.empty_cache()
    print(f"Q.2 {Q2_MICRO} microbatches against 1, step 0: loss {loss:.6f} "
          f"against {want:.6f} (rel {abs(loss - want) / want:.3g}, gate "
          f"{Q2_LOSS_RTOL}; Q.1's step 0 {loss_q1:.6f}); gradient norm "
          f"{gn:.7g} against {gn1:.7g} (rel {gn_rel:.3g}, gate "
          f"{Q2_NORM_RTOL}); gradients per leaf (norm-relative, gate "
          f"{Q2_GRAD_RTOL}) " + " ".join(f"{r:.3g}" for r in g_rel)
          + "; one microbatch's bf16 gradient against float32 on the same "
          "weights " + " ".join(f"{r:.3g}" for r in bf16_rel)
          + f"; params max(|diff| - 2*lr - ulp) {strict:.3g} (gate also "
          f"{Q2_RTOL}*|p|)", flush=True)
    return {"loss": loss, "loss_one": want, "grad_norm": gn,
            "grad_norm_one": gn1, "grad_rel": g_rel,
            "bf16_vs_float32_rel": bf16_rel, "param_excess": strict}


def q_cut_model(dev):
    """Q.3's and Q.5's model: the FULL width cut to Q3_LAYERS layers,
    float32, remat on; weights drawn on the CPU (seed 0, the weights of
    ``tools/grad_float64_witness.py``) and moved to the card."""
    import torch
    from repro_torch import configs
    from repro_torch.models import Model, spec
    cfg = configs.get(Q_ARCH).replace(n_layers=Q3_LAYERS,
                                      dtype=torch.float32)
    model = Model(cfg)
    params = spec.tree_map(lambda a: a.to(dev),
                           model.init(0, device="cpu"))
    return model, params


def q_rel(a, b) -> float:
    """||a - b|| / ||b||, in float64 on ``b``'s device."""
    import torch
    b = b.detach().double()
    a = a.detach().to(b.device, torch.float64)
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def q_card_vs_cpu(model, params, dev, total):
    """Q.3: one float32 step on the card against the port's CPU run with
    the same weights; the card's gradients against the CPU's within
    Q3_SPREAD times the CPU's own float32 error; remat on against off on
    the card, bit for bit."""
    import torch
    from repro_torch.models import Model, spec
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    ocfg = adamw.AdamWConfig(lr=Q_LR, warmup_steps=1, total_steps=Q_STEPS)
    batch = q_batches(model.cfg.vocab_size, Q3_SEQ, Q3_BATCH, 1, dev, 3)[0]
    cpu = torch.device("cpu")
    runs = {}
    for where in (dev, cpu):
        p = spec.tree_map(lambda a: a.to(where, copy=True), params)
        st = tstep.TrainState(p, adamw.init(p, ocfg))
        b = {k: v.to(where) for k, v in batch.items()}
        train = tstep.make_train_step(model, ocfg=ocfg)
        t0 = time.perf_counter()
        if where.type == "cuda":
            (st, met), counts = q_counted("Q.3", lambda: train(st, b),
                                          ("dot",))
            q_add(total, counts)
        else:
            st, met = train(st, b)
        runs[where.type] = (st, met, time.perf_counter() - t0)
    (cs, cm, cwall), (hs, hm, hwall) = runs[dev.type], runs["cpu"]
    errs = {"loss": abs(float(cm["loss"]) - float(hm["loss"])) /
            abs(float(hm["loss"]))}
    check(errs["loss"] <= Q3_LOSS_RTOL, f"Q.3: loss rel {errs['loss']:.3g}")
    lr = float(hm["lr"])
    errs["params"] = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        spec.tree_leaves(cs.params), spec.tree_leaves(hs.params)))
    check(errs["params"] <= 2 * lr + Q3_PARAM_ATOL,
          f"Q.3: params differ by {errs['params']:.3g} (gate 2*lr + "
          f"{Q3_PARAM_ATOL})")
    errs["lr"] = abs(float(cm["lr"]) - lr) / lr
    # the gradients: the card's (remat on and off), the CPU's in float32
    # and with float64 weights (its matmuls in float64; the model's own
    # float32 casts stay): the CPU's own float32 error per leaf
    off = Model(model.cfg.replace(remat=False))
    card = [tstep.value_and_grad(m.loss, params, batch) for m in (model, off)]
    same = torch.equal(card[0][0], card[1][0]) and all(
        torch.equal(a, b) for a, b in zip(spec.tree_leaves(card[0][1]),
                                          spec.tree_leaves(card[1][1])))
    check(same, "Q.3: remat on and off differ on the card")
    gc = [g.cpu() for g in spec.tree_leaves(card[0][1])]
    del card
    torch.cuda.empty_cache()
    hb = {k: v.cpu() for k, v in batch.items()}
    p32 = spec.tree_map(lambda a: a.cpu(), params)
    g32 = spec.tree_leaves(tstep.value_and_grad(model.loss, p32, hb)[1])
    m64 = Model(model.cfg.replace(dtype=torch.float64))
    g64 = spec.tree_leaves(tstep.value_and_grad(
        m64.loss, spec.tree_map(torch.Tensor.double, p32), hb)[1])
    spread = [q_rel(a, b) for a, b in zip(g32, g64)]
    grad = [q_rel(a, b) for a, b in zip(gc, g32)]
    bad = [(i, d, e) for i, (d, e) in enumerate(zip(grad, spread))
           if d > Q3_SPREAD * e + Q3_MOMENT_TOL]
    check(not bad, f"Q.3: gradient leaves (index, card rel, CPU float32 "
          f"rel) past {Q3_SPREAD}x the CPU's own error + "
          f"{Q3_MOMENT_TOL}: {bad}")

    def norm(gs):
        return math.sqrt(sum(float(g.double().pow(2).sum()) for g in gs))

    n_card, n32, n64 = norm(gc), norm(g32), norm(g64)
    gn_gate = Q3_SPREAD * abs(n32 - n64) + Q3_NORM_RTOL * n32
    errs["grad_norm"] = abs(float(cm["grad_norm"]) - float(hm["grad_norm"]))
    check(abs(n_card - n32) <= gn_gate and errs["grad_norm"] <= gn_gate,
          f"Q.3: gradient norm {n_card} (step {float(cm['grad_norm'])}) "
          f"against the CPU's {n32} (step {float(hm['grad_norm'])}; float64 "
          f"weights {n64})")
    errs["grad_norm"] /= float(hm["grad_norm"])
    # the moments follow the gradient and the clip scale min(1, 1/norm)
    clip = abs(min(1.0, 1 / float(cm["grad_norm"])) /
               min(1.0, 1 / float(hm["grad_norm"])) - 1)
    for name, power in (("m", 1), ("v", 2)):
        rel = [q_rel(a, b) for a, b in zip(
            spec.tree_leaves(getattr(cs.opt, name)),
            spec.tree_leaves(getattr(hs.opt, name)))]
        over = [(i, r) for i, (r, e) in enumerate(zip(rel, spread))
                if r > power * (Q3_SPREAD * e + clip) + Q3_MOMENT_TOL]
        check(not over, f"Q.3: {name} leaves past their gradients' bound: "
              f"{over}")
        errs[name] = max(rel)
    errs["gradient"] = max(grad)
    errs["cpu_float32_spread"] = max(spread)
    checksum = sum(float(a.double().sum()) for a in spec.tree_leaves(p32))
    del runs, cs, hs, g32, g64, p32
    print(f"Q.3 {Q3_LAYERS} layers float32 remat, batch {Q3_BATCH} x "
          f"{Q3_SEQ}, one step, card against CPU (norm-relative by leaf, "
          f"the largest): " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()) + "; per leaf card "
          + " ".join(f"{x:.2g}" for x in grad) + ", CPU float32 against "
          "float64 weights " + " ".join(f"{x:.2g}" for x in spread)
          + f" (walls card {cwall:.2f} s, CPU {hwall:.2f} s); remat on "
          "against off on the card: loss and gradients bit for bit; "
          f"weights' sum {checksum!r}", flush=True)
    # "_grads": the card's gradients (host copies), R.3's single-card
    # reference, taken out before the record is written
    return {"rel_err": errs, "gradient_rel": grad, "cpu_spread": spread,
            "card_s": cwall, "cpu_s": hwall, "remat_bitwise": same,
            "weights_sum": checksum, "_grads": gc}


class QCrash(Exception):
    """The launcher's data stream dying, as a crashed process would."""


def q_launch(args, crash_after=None):
    """``launch.train.main(args)`` with its stdout kept; ``crash_after``
    kills its data stream after that many batches. -> (losses, stdout)."""
    import contextlib
    import io
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    real = pipeline.batches

    def dying(*a, **kw):
        for i, b in enumerate(real(*a, **kw)):
            if i == crash_after:
                raise QCrash
            yield b

    buf = io.StringIO()
    if crash_after is not None:
        pipeline.batches = dying
    try:
        with contextlib.redirect_stdout(buf):
            hist = train.main(args)
    except QCrash:
        hist = None
    finally:
        pipeline.batches = real
    return hist, buf.getvalue()


def q_final(ckpt_dir):
    """The final checkpoint's leaves (numpy) and meta."""
    import numpy as np
    d = Path(ckpt_dir) / f"step_{Q4_STEPS:08d}"
    return ({f.name: np.load(f) for f in sorted(d.glob("*.npy"))},
            json.loads((d / "meta.json").read_text()))


def q_resume(dev, total):
    """Q.4: crash and resume through the launcher on the card: two
    uninterrupted runs (to learn whether the card repeats its bits), one
    run crashed after Q4_CRASH steps and resumed."""
    import shutil
    import tempfile
    import numpy as np
    OUT.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="path_q_", dir=OUT))
    args = ["--device", str(dev), "--arch", Q4_ARCH, "--steps", str(Q4_STEPS),
            "--batch", str(Q4_BATCH), "--seq", str(Q4_SEQ), "--ckpt-every",
            str(Q4_CRASH), "--lr", "1e-3"]
    try:
        def runs():
            out = {}
            for name in ("a", "b"):
                out[name] = q_launch(args + ["--ckpt-dir", str(tmp / name)])
            crashed = q_launch(args + ["--ckpt-dir", str(tmp / "c")],
                               crash_after=Q4_CRASH)
            check(crashed[0] is None, "Q.4: the crash did not happen")
            out["c"] = q_launch(args + ["--ckpt-dir", str(tmp / "c")])
            return out

        out, counts = q_counted("Q.4", runs, ("dot",))
        q_add(total, counts)
        check(f"resuming from checkpoint step {Q4_CRASH}" in out["c"][1],
              "Q.4: no resume line")
        finals = {k: q_final(tmp / k) for k in "abc"}

        def same(x, y):
            return out[x][0][-len(out[y][0]):] == out[y][0] and \
                finals[x][1] == finals[y][1] and all(
                    np.array_equal(finals[x][0][f], finals[y][0][f])
                    for f in finals[x][0])

        repeat = same("a", "b")
        if repeat:
            check(same("a", "c"), "Q.4: the resumed run differs from the "
                  "uninterrupted one")
            gate = "bit for bit"
        else:
            # the card does not repeat its own bits: hold the resumed run
            # to Q.2's tolerance
            la, lc = out["a"][0][Q4_CRASH:], out["c"][0]
            check(all(abs(x - y) <= Q2_LOSS_RTOL * abs(x)
                      for x, y in zip(la, lc)), f"Q.4: losses {la} {lc}")
            gate = "within Q.2's tolerance (two uninterrupted runs differ)"
        print(f"Q.4 launcher {Q4_ARCH} on the card, {Q4_STEPS} steps, crash "
              f"after {Q4_CRASH} and resume: resumed losses "
              + " ".join(f"{x:.6f}" for x in out["c"][0])
              + f", uninterrupted " + " ".join(f"{x:.6f}" for x in
                                               out["a"][0][Q4_CRASH:])
              + f"; two uninterrupted runs repeat their bits: {repeat}; "
              f"resumed against uninterrupted {gate}", flush=True)
        return {"losses_full": out["a"][0], "losses_resumed": out["c"][0],
                "repeat_bitwise": repeat, "gate": gate}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def q_gradflow(model, params, dev, total):
    """Q.5: gradflow.step on Q.3's cut, the kernels against a run with
    the integrator's vector ops pinned to their plain versions."""
    import torch
    from repro_torch.core.policies import ExecPolicy
    from repro_torch.models import spec
    from repro_torch.optim import gradflow
    batch = q_batches(model.cfg.vocab_size, Q3_SEQ, Q3_BATCH, 1, dev, 3)[0]
    cfg = gradflow.GradFlowConfig(tau=Q5_TAU, max_steps=Q5_MAX_STEPS)

    def lf(p):
        return model.loss(p, batch)

    t0 = time.perf_counter()
    (p2, st), counts = q_counted(
        "Q.5", lambda: gradflow.step(lf, params, cfg), Q_KERNELS["Q.5"])
    wall = time.perf_counter() - t0
    q_add(total, counts)
    pin = ExecPolicy().override(linear_combination="torch",
                                wrms_norm="torch", dot="torch")
    from repro_torch import kernels
    kernels.reset_counts()
    p3, st3 = gradflow.step(lf, params, cfg, policy=pin)
    pinned = kernels.counts()
    check(all(pinned[k][0] == 0 and pinned[k][1] > 0
              for k in Q_KERNELS["Q.5"]), f"Q.5: the pinned run launched a "
          f"kernel or skipped a plain version: {pinned}")
    check(int(st.steps) == int(st3.steps) and
          int(st.attempts) == int(st3.attempts),
          f"Q.5: steps/attempts {int(st.steps)}/{int(st.attempts)} against "
          f"the plain run's {int(st3.steps)}/{int(st3.attempts)}")
    over = max(float(((a - b).abs() - 10 * (cfg.rtol * b.abs() + cfg.atol))
                     .max()) for a, b in zip(spec.tree_leaves(p2),
                                             spec.tree_leaves(p3)))
    check(over <= 0, f"Q.5: params past 10*(rtol*|p|+atol) by {over:.3g}")
    with torch.no_grad():
        before, after = float(lf(params)), float(lf(p2))
    check(after < before, f"Q.5: the loss did not fall ({before} -> {after})")
    print(f"Q.5 gradflow (heun_euler, tau {Q5_TAU}, max_steps "
          f"{Q5_MAX_STEPS}) on the cut: {int(st.steps)} steps, "
          f"{int(st.attempts)} attempts, loss {before:.5f} -> {after:.5f}, "
          f"{wall:.2f} s; rows 12 and 14 launched "
          f"{counts['linear_combination'][0]} and {counts['wrms_ss'][0]} "
          f"times; the plain run's steps and attempts equal, params within "
          f"10*(rtol*|p|+atol) (max excess {over:.3g})", flush=True)
    return {"steps": int(st.steps), "attempts": int(st.attempts),
            "loss": [before, after], "wall_s": wall,
            "launches": {k: counts[k][0] for k in Q_KERNELS["Q.5"]}}


def phase_path_q(card):
    """Path Q: the model stack's training half at internlm2-1.8b's full
    width (Q.1, Q.2), on its 2-layer float32 cut (Q.3, Q.5), and through
    the launcher on the smoke config (Q.4).  AdamW's global norm launches
    row 16 (``dot``) once a leaf a step; gradient flow's ERK rows 12
    (``linear_combination``) and 14 (``wrms_ss``)."""
    import torch
    dev = torch.device("cuda")
    print(card, flush=True)
    torch.cuda.empty_cache()
    total = {}
    rec = {"seconds": {}}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        rec["seconds"][name] = time.perf_counter() - t0
        return out

    rec["Q.1"], model, ocfg, batch0 = timed("Q.1", q_train, card, dev,
                                            total)
    rec["Q.2"] = timed("Q.2", q_microbatches, model, ocfg, batch0,
                       rec["Q.1"]["loss"][0], dev, total)
    del batch0
    torch.cuda.empty_cache()
    cut, params = q_cut_model(dev)
    rec["Q.3"] = timed("Q.3", q_card_vs_cpu, cut, params, dev, total)
    rec["Q.4"] = timed("Q.4", q_resume, dev, total)
    rec["Q.5"] = timed("Q.5", q_gradflow, cut, params, dev, total)
    del params
    torch.cuda.empty_cache()
    print("path Q seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rec["seconds"].items()), flush=True)
    print("path Q: kernel launches " + ", ".join(
        f"{k} {v[0]}" for k, v in total.items() if v[0]), flush=True)
    rec["kernels_run"] = {"counts": total}
    return rec


# ---------------------------------------------------------------------------
# path R: the model-parallel layer (parallel/, models/moe_ep.py, the
# sharded train step and checkpoints)
# ---------------------------------------------------------------------------

#: R.1/R.2: dbrx-132b's FULL MoE layer (d 6144, 16 experts, top 4,
#: moe_d_ff 10752), bf16, drawn from R_SEED (one generator an expert, so
#: that a rank draws only its own); the split layout's batch x sequence
#: and the replicated layout's; the cap factors tried in turn until no
#: item drops.  EP against the dense oracle: every token's output within
#: R_TOKEN_RTOL of the oracle's in the 2-norm.  Both run bf16 GEMMs (f32
#: accumulation) over differently shaped operands, so a token differs by
#: the rounding of its last bf16 products (2^-9 an element, a few 1e-3 in
#: a token's norm); an item routed to a wrong expert, dropped or combined
#: with a wrong weight moves its token by a quarter of its norm or more
R_MOE_ARCH, R_SEED = "dbrx-132b", 7
R1_SPLIT, R1_REPL = (4, 512), (16, 1)
R1_CAPS = (1.25, 2.0, 4.0, 8.0, 16.0)
R_TOKEN_RTOL = 3e-2
#: R.2-R.4: four gloo ranks on the card, mesh data=2 x model=2
R_WORLD, R_DATA, R_MODEL, R_RANK_TIMEOUT = 4, 2, 2, 600
#: R.3: Q's architecture at its FULL width cut to R3_LAYERS layers
#: (depth only, for the time of gloo through the host), bf16, remat,
#: Q.1's batch; R3_STEPS AdamW steps from Q's seeded init (R.4 saves
#: before the last).  The sharded losses against the single-device run
#: of the same init: step 0 within Q2_LOSS_RTOL (Q.2's gate: one batch,
#: the same weights, only the order of the sums differs), the later
#: steps within R3_DRIFT_RTOL (after a step the weights themselves
#: differ by the bf16 rounding of the update).  The gradient norms
#: within Q2_GRAD_RTOL, Q.2's gate on a bf16 gradient: at this init the
#: bf16 gradient lies ~1.3 of its norm from float32's (PERF.md, PR 25),
#: so its rounding moves the norm by a few % with the GEMMs' shapes; a
#: data-parallel half lost or doubled moves it by 30 % or more.  The
#: float32 cut holds the gradients leaf by leaf
R3_LAYERS, R3_STEPS = 2, 3
R3_DRIFT_RTOL = 2e-3
#: row 16 against a float64 dot of the same leaf: a fault when the
#: kernel's error exceeds its plain version's by more than R_DOT_FAULT
#: times (and 1e-6, float32's floor of such a sum)
R_DOT_FAULT = 4.0


def r_moe_params(cfg, experts, dev):
    """One MoE layer's ffn: the router (every rank's, float32) and the
    experts ``experts`` (a range), each drawn from its own generator."""
    import torch
    d, f = cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(R_SEED)
    p = {"router": torch.randn((d, cfg.n_experts), generator=gen,
                               device=dev) / math.sqrt(d)}
    ws = {"w1": [], "w3": [], "w2": []}
    for e in experts:
        gen.manual_seed(R_SEED + 1 + e)
        for n, shape, fan in (("w1", (d, f), d), ("w3", (d, f), d),
                              ("w2", (f, d), f)):
            ws[n].append((torch.randn(shape, generator=gen, device=dev)
                          / math.sqrt(fan)).to(cfg.dtype))
    p.update({n: torch.stack(v) for n, v in ws.items()})
    return p


def r_inputs(cfg, dev):
    """The split layout's x (R1_SPLIT + (d,)) and the replicated one's."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(R_SEED + 1000)
    return tuple(torch.randn(shape + (cfg.d_model,), generator=gen,
                             device=dev).to(cfg.dtype)
                 for shape in (R1_SPLIT, R1_REPL))


def r_token_rel(y, want) -> float:
    """max over tokens of ||y_t - want_t|| / ||want_t|| (float64)."""
    a = y.double().reshape(-1, y.shape[-1])
    b = want.to(a.device).double().reshape(-1, y.shape[-1])
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30))
                 .max())


def r_ms(run, reps=3):
    """Median wall ms of ``run()`` between device syncs."""
    times = []
    for _ in range(reps):
        p_sync()
        t0 = time.perf_counter()
        run()
        p_sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def r_ep(cfg, p, x, mesh, layout, ep_axis, caps, comm=None):
    """moe_ep_apply at each cap factor of ``caps`` until no item drops
    (over every rank when ``comm``): -> (y, cap factor, dropped share at
    each cap factor tried)."""
    import torch
    from repro_torch.models import moe_ep
    from repro_torch.parallel import collectives as coll
    shares = {}
    for cf in caps:
        stats = {}
        y = moe_ep.moe_ep_apply(p, cfg.replace(moe_cap_factor=cf), x, mesh,
                                dp_axes=("data",), ep_axis=ep_axis,
                                token_layout=layout, stats=stats)
        counts = torch.stack([torch.as_tensor(stats["dropped"],
                                              device=x.device).double(),
                              torch.tensor(float(stats["items"]),
                                           device=x.device,
                                           dtype=torch.float64)])
        if comm is not None:
            counts = coll.all_reduce(counts, comm, comm.names)
        shares[cf] = float(counts[0] / counts[1])
        if shares[cf] == 0:
            return y, cf, shares
    check(False, f"R: items still drop at cap factor {caps[-1]}: {shares}")


def r1_world_of_one(dev, tmp):
    """R.1: moe_ep_apply over an NCCL group of one (a (1, 1) debug mesh)
    at dbrx-132b's full width against the dense oracle; saves the inputs
    and the oracle for R.2."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers, moe_ep
    from repro_torch.parallel import collectives as coll
    cfg = configs.get(R_MOE_ARCH)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = make_debug_mesh(1, 1)
        p_peak_reset()
        p = r_moe_params(cfg, range(cfg.n_experts), dev)
        w_bytes = sum(p[n].numel() * p[n].element_size()
                      for n in ("w1", "w3", "w2"))
        xs, xr = r_inputs(cfg, dev)
        rec = {"expert_bytes": w_bytes, "layouts": {}}
        save = {"xs": xs.cpu(), "xr": xr.cpu()}
        with torch.no_grad():
            for layout, x, tag in (("split", xs, "s"), ("replicated", xr,
                                                        "r")):
                dense = layers.moe_dense_apply(p, cfg, x)
                coll.reset_counts()
                y, cf, shares = r_ep(cfg, p, x, mesh, layout, "model",
                                     R1_CAPS)
                colls = coll.counts()
                rel = r_token_rel(y, dense)
                check(rel <= R_TOKEN_RTOL, f"R.1 {layout}: a token's EP "
                      f"output is {rel:.3g} from the dense oracle's (gate "
                      f"{R_TOKEN_RTOL})")
                c = cfg.replace(moe_cap_factor=cf)
                ms = r_ms(lambda: moe_ep.moe_ep_apply(
                    p, c, x, mesh, token_layout=layout))
                dense_ms = r_ms(lambda: layers.moe_dense_apply(p, cfg, x))
                save[f"dense_{tag}"], save[f"cap_{tag}"] = dense.cpu(), cf
                rec["layouts"][layout] = {
                    "tokens": x.shape[0] * x.shape[1], "dropped_share": shares,
                    "cap_factor": cf, "token_rel": rel, "ms": ms,
                    "dense_ms": dense_ms, "collectives": colls}
                print(f"R.1 {R_MOE_ARCH} MoE layer, NCCL group of one, "
                      f"{layout} {tuple(x.shape[:2])}: dropped share "
                      + ", ".join(f"{k}: {v:.4g}" for k, v in shares.items())
                      + f"; at cap factor {cf} no drop, max token rel "
                      f"{rel:.3g} against the dense oracle (gate "
                      f"{R_TOKEN_RTOL}); moe_ep_apply {ms:.2f} ms, dense "
                      f"{dense_ms:.2f} ms; collectives {colls}", flush=True)
                del dense, y
        rec["peak_gib"] = p_peak_gib()
        print(f"R.1 experts {w_bytes / 1e9:.2f} GB, peak "
              f"{rec['peak_gib']:.2f} GiB", flush=True)
    finally:
        coll.close()
    torch.save(save, tmp / "r_moe.pt")
    del p, xs, xr, save
    torch.cuda.empty_cache()
    return rec


def r_cut_config(dtype=None, layers=R3_LAYERS):
    from repro_torch import configs
    cfg = configs.get(Q_ARCH).replace(n_layers=layers)
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def r3_single(dev):
    """R.3's single-device run: the same init and batches, one card."""
    import torch
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    model = Model(r_cut_config())
    ocfg = adamw.AdamWConfig(lr=Q_LR, warmup_steps=1, total_steps=Q_STEPS)
    batches = q_batches(model.cfg.vocab_size, Q_SEQ, Q_BATCH, R3_STEPS, dev)
    state = tstep.init_state(model, 0, ocfg, device=dev)
    train = tstep.make_train_step(model, ocfg=ocfg)
    mets, times = [], []
    for b in batches:
        p_sync()
        t0 = time.perf_counter()
        state, met = train(state, b)
        p_sync()
        times.append(1e3 * (time.perf_counter() - t0))
        mets.append(met)
    out = {"loss": [float(m["loss"]) for m in mets],
           "grad_norm": [float(m["grad_norm"]) for m in mets],
           "ms": times}
    del state, train, batches
    torch.cuda.empty_cache()
    return out


def phase_path_r(card, q3, dev=None):
    """Path R, the model-parallel layer on the card: R.1 the expert-
    parallel MoE at dbrx-132b's width over an NCCL group of one; R.2-R.4
    in four gloo ranks on this card (data=2 x model=2, the collectives
    staged through the host): R.2 single- and multi-axis EP in both
    layouts against R.1's dense oracle, R.3 the sharded train step
    (tp_fsdp) at internlm2-1.8b's width against the single-device run,
    with its float32 cut's gradients against Q.3's, R.4 a sharded
    checkpoint saved, restored into its layout and stepped."""
    import shutil
    import tempfile
    import torch
    dev = dev or torch.device("cuda")
    print(card, flush=True)
    torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="path_r_", dir=OUT))
    rec = {"seconds": {}}
    try:
        t = time.perf_counter()
        rec["R.1"] = r1_world_of_one(dev, tmp)
        rec["seconds"]["R.1"] = time.perf_counter() - t
        t = time.perf_counter()
        single = r3_single(dev)
        grads, spread = q3.pop("_grads"), q3["cpu_spread"]
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        torch.save({"grads": grads, "spread": spread, "norm": norm},
                   tmp / "r3_grads.pt")
        del grads
        rec["seconds"]["R.3 single"] = time.perf_counter() - t
        t = time.perf_counter()
        ranks = spawn_ranks(R_WORLD, False, "--path-r-rank", tmp,
                            R_RANK_TIMEOUT, "R")
        rec["seconds"]["R.2-R.4 ranks"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r_check_ranks(ranks, single, spread, rec)
    print("path R seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rec["seconds"].items()), flush=True)
    return rec


def r_check_ranks(ranks, single, spread, rec):
    """R.2-R.4's records printed, then their gates."""
    total = {}
    for rk in ranks:
        q_add(total, rk["R.3"]["counts"])
    r3 = ranks[0]["R.3"]
    loss, gn = r3["loss"], r3["grad_norm"]
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, single["loss"])]
    gn_rel = [abs(a - b) / abs(b) for a, b in zip(gn, single["grad_norm"])]
    print(f"R.3 internlm2-1.8b width, {R3_LAYERS} layers, tp_fsdp data="
          f"{R_DATA} x model={R_MODEL}, {R3_STEPS} steps: losses "
          + " ".join(f"{x:.6f}" for x in loss) + " against one card's "
          + " ".join(f"{x:.6f}" for x in single["loss"]) + " (rel "
          + " ".join(f"{x:.3g}" for x in rel) + "); grad norms "
          + " ".join(f"{x:.6g}" for x in gn) + " against "
          + " ".join(f"{x:.6g}" for x in single["grad_norm"]) + " (rel "
          + " ".join(f"{x:.3g}" for x in gn_rel) + "); ms a step "
          + " ".join(f"{x:.1f}" for x in r3["ms"]) + " (gloo through the "
          "host, four ranks on one card: not a measure of NCCL; one card "
          + " ".join(f"{x:.1f}" for x in single["ms"]) + ")", flush=True)
    for r, rk in enumerate(ranks):
        x = rk["R.3"]
        print(f"R rank {r}: R.3 state {x['state_bytes'] / 2**30:.3f} GiB "
              f"(Q.1's one card: 31.7 GiB peak at 24 layers), peak "
              f"{x['peak_gib']:.2f} GiB, collectives a step "
              f"{x['collectives_per_step']}; R.2 expert bytes "
              f"{rk['R.2']['expert_bytes']}, peak {rk['R.2']['peak_gib']:.2f}"
              f" GiB; seconds {rk['seconds']}", flush=True)
    cut = r3["cut"]
    print(f"R.3 float32 cut ({Q3_LAYERS} layers, Q.3's weights and batch), "
          f"sharded gradients against Q.3's single-card ones, per leaf "
          + " ".join(f"{x:.2g}" for x in cut["leaf_rel"]) + " (Q.3's CPU "
          "spread " + " ".join(f"{x:.2g}" for x in spread) + f"); global "
          f"norm rel {cut['norm_rel']:.3g}", flush=True)
    dots = [rk["R.3"]["dot64"] for rk in ranks]
    print("R.3 row 16 and its plain version against a float64 dot of the "
          "same float32 shard (the cut's gradients), max rel per rank: "
          + ", ".join(f"kernel {d['kernel_max']:.3g} plain "
                      f"{d['plain_max']:.3g}" for d in dots)
          + f" (fault past {R_DOT_FAULT}x the plain's)", flush=True)
    r4 = ranks[0]["R.4"]
    print(f"R.4 sharded checkpoint of step {R3_STEPS - 1}: save "
          f"{r4['save_s']:.2f} s, restore into the layout "
          f"{r4['restore_s']:.2f} s; the step from it bit for bit: "
          f"{[rk['R.4']['stepped_bitwise'] for rk in ranks]}; param leaves "
          f"and step of the unsharded restore (one process) differing from "
          f"the gathered state: {r4['unsharded_mismatches']} of "
          f"{r4['leaves']}",
          flush=True)
    print("path R: kernel launches " + ", ".join(
        f"{k} {v[0]}" for k, v in total.items() if v[0]), flush=True)
    rec.update({"R.2": [rk["R.2"] for rk in ranks],
                "R.3": {"single": single, "loss_rel": rel,
                        "grad_norm_rel": gn_rel,
                        "ranks": [{k: v for k, v in rk["R.3"].items()
                                   if k != "counts"} for rk in ranks]},
                "R.4": [rk["R.4"] for rk in ranks],
                "rank_seconds": [rk["seconds"] for rk in ranks],
                "kernels_run": {"counts": total}})
    # the gates
    for r, rk in enumerate(ranks):
        for case, c in rk["R.2"]["cases"].items():
            check(c["token_rel"] <= R_TOKEN_RTOL, f"R.2 rank {r} {case}: "
                  f"token rel {c['token_rel']:.3g}")
        check(rk["R.3"]["counts"]["dot"][0] > 0 and all(
            v[1] == 0 for v in rk["R.3"]["counts"].values()),
            f"R.3 rank {r}: row 16 not launched, or a plain version ran: "
            f"{rk['R.3']['counts']}")
        check(rk["R.3"]["loss"] == loss, "R.3: the ranks' losses differ")
    check(rel[0] <= Q2_LOSS_RTOL, f"R.3: step 0's loss rel {rel[0]:.3g} "
          f"(gate {Q2_LOSS_RTOL})")
    check(all(x <= R3_DRIFT_RTOL for x in rel),
          f"R.3: losses past {R3_DRIFT_RTOL}: {rel}")
    check(all(x <= Q2_GRAD_RTOL for x in gn_rel),
          f"R.3: grad norms past {Q2_GRAD_RTOL}: {gn_rel}")
    bad = [(i, g, e) for i, (g, e) in enumerate(zip(cut["leaf_rel"], spread))
           if g > Q3_SPREAD * e + Q3_MOMENT_TOL]
    check(not bad, f"R.3 float32 cut: gradient leaves (index, sharded rel, "
          f"CPU float32 spread) past Q.3's gate: {bad}")
    check(cut["norm_rel"] <= Q3_NORM_RTOL + Q3_SPREAD * max(spread),
          f"R.3 float32 cut: global norm rel {cut['norm_rel']:.3g}")
    fault = [d for d in dots if d["kernel_max"] > R_DOT_FAULT *
             d["plain_max"] + 1e-6]
    check(not fault, f"R.3: row 16's error past {R_DOT_FAULT}x its plain "
          f"version's: {fault}")
    check(all(rk["R.4"]["stepped_bitwise"] for rk in ranks),
          "R.4: the step from the restored checkpoint differs from the "
          "uninterrupted step")
    check(r4["unsharded_mismatches"] == 0, f"R.4: {r4['unsharded_mismatches']}"
          " leaves of the unsharded restore differ from the gathered state")


def path_r_rank(argv) -> int:
    """One rank of R.2-R.4 (``--path-r-rank RANK WORLD DIR``): joins the
    gloo group through ``DIR/store`` and saves its record to
    ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import collectives as coll
    rank, world, tmp = int(argv[0]), int(argv[1]), Path(argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh, mesh_device
        mesh = make_debug_mesh(R_DATA, R_MODEL)
        dev = mesh_device(mesh)
        check(dev.type == "cuda", f"R rank {rank}: device {dev}")
        t0 = time.perf_counter()
        rec = {"R.2": r2_ep(mesh, dev, tmp)}
        sec = {"R.2": time.perf_counter() - t0}
        rec.update(r3_train(mesh, dev, tmp, rank, sec))
        rec["seconds"] = {k: round(v, 2) for k, v in sec.items()}
        torch.save(rec, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        coll.close()
    return 0


def r2_ep(mesh, dev, tmp):
    """R.2: single-axis EP over model (8 experts a rank) and multi-axis
    over (model, data) (4 a rank), both layouts, against R.1's dense
    oracle (this rank's rows)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import moe_ep
    from repro_torch.parallel import collectives as coll
    cfg = configs.get(R_MOE_ARCH)
    comm = coll.comm_of(mesh)
    mi, di = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    p_peak_reset()
    per = cfg.n_experts // R_MODEL
    p8 = r_moe_params(cfg, range(per * mi, per * (mi + 1)), dev)
    q = per // R_DATA            # (model, data) block m*D + d: its experts
    p4 = {"router": p8["router"], **{n: p8[n][q * di:q * (di + 1)]
                                     for n in ("w1", "w3", "w2")}}
    ref = torch.load(tmp / "r_moe.pt")
    out = {"expert_bytes": {
        "model": sum(p8[n].numel() * 2 for n in ("w1", "w3", "w2")),
        "model,data": sum(p4[n].numel() * 2 for n in ("w1", "w3", "w2"))},
        "cases": {}}
    with torch.no_grad():
        for layout, tag in (("split", "s"), ("replicated", "r")):
            x, want = ref[f"x{tag}"], ref[f"dense_{tag}"]
            rows = x.shape[0] // R_DATA
            x = x[rows * di:rows * (di + 1)].to(dev)
            want = want[rows * di:rows * (di + 1)]
            caps = tuple(c for c in R1_CAPS if c >= ref[f"cap_{tag}"])
            for ax, p in (("model", p8), (("model", "data"), p4)):
                name = f"{layout} {ax}"
                coll.reset_counts()
                y, cf, shares = r_ep(cfg, p, x, mesh, layout, ax, caps,
                                     comm)
                colls = coll.counts()
                c = cfg.replace(moe_cap_factor=cf)
                ms = r_ms(lambda: moe_ep.moe_ep_apply(
                    p, c, x, mesh, ep_axis=ax, token_layout=layout))
                out["cases"][name] = {
                    "cap_factor": cf, "dropped_share": shares,
                    "token_rel": r_token_rel(y, want), "ms": ms,
                    "collectives": colls}
    out["peak_gib"] = p_peak_gib()
    print(f"R.2 rank {comm.index(comm.names)}: " + "; ".join(
        f"{k}: cap {v['cap_factor']}, token rel {v['token_rel']:.3g}, "
        f"{v['ms']:.1f} ms" for k, v in out["cases"].items())
        + f"; expert bytes {out['expert_bytes']}, peak "
        f"{out['peak_gib']:.2f} GiB", flush=True)
    del p8, p4
    torch.cuda.empty_cache()
    return out


def r3_train(mesh, dev, tmp, rank, sec):
    """R.3 and R.4 on this rank; ``sec`` gets their seconds."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import dispatch
    from repro_torch.core.policies import ExecPolicy
    from repro_torch.launch.train import make_pctx
    from repro_torch.models import Model, spec
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import step as tstep
    comm = coll.comm_of(mesh)
    model = Model(r_cut_config())
    pctx = make_pctx(model.cfg, mesh)
    sh = tstep.state_shardings(model, pctx)
    ocfg = adamw.AdamWConfig(lr=Q_LR, warmup_steps=1, total_steps=Q_STEPS)
    batches = q_batches(model.cfg.vocab_size, Q_SEQ, Q_BATCH, R3_STEPS, dev)
    p_peak_reset()
    t_all = time.perf_counter()
    state = tstep.init_state(model, 0, ocfg, device=dev, shardings=sh)
    state_bytes = sum(p_bytes(t) for t in (state.params, state.opt.m,
                                           state.opt.v))
    train = tstep.make_train_step(model, pctx, ocfg,
                                  grad_shardings=sh.params)
    ckdir = str(tmp / "ckpt")
    mets, times, r4 = [], [], {}
    p_sync()
    kernels.reset_counts()
    coll.reset_counts()
    for i, b in enumerate(batches):
        if i == R3_STEPS - 1:
            counts, colls = kernels.counts(), coll.counts()
            t0 = time.perf_counter()
            ckpt.save(state, ckdir, i, shardings=sh)
            r4["save_s"] = time.perf_counter() - t0
            kernels.reset_counts()
            coll.reset_counts()
        p_sync()
        t0 = time.perf_counter()
        state, met = train(state, b)
        p_sync()
        times.append(1e3 * (time.perf_counter() - t0))
        mets.append(met)
    counts = {k: (v[0] + kernels.counts()[k][0], v[1] +
                  kernels.counts()[k][1]) for k, v in counts.items()}
    last = coll.counts()
    colls = {k: (colls[k][0] + last[k][0], colls[k][1] + last[k][1])
             for k in colls}
    peak = p_peak_gib()
    out = {"loss": [float(m["loss"]) for m in mets],
           "grad_norm": [float(m["grad_norm"]) for m in mets],
           "ms": times, "state_bytes": state_bytes, "peak_gib": peak,
           "counts": counts,
           "collectives_per_step": {k: (c // R3_STEPS, b // R3_STEPS)
                                    for k, (c, b) in colls.items()}}
    sec["R.3 steps"] = time.perf_counter() - t_all - r4["save_s"]
    # R.4: the checkpoint of step R3_STEPS - 1 restored into the layout
    t_all = time.perf_counter()
    abstract = tstep.abstract_state(model, ocfg)
    t0 = time.perf_counter()
    st = ckpt.restore(abstract, ckdir, R3_STEPS - 1, shardings=sh,
                      device=dev)
    p_sync()
    r4["restore_s"] = time.perf_counter() - t0
    # one process (rank 0) restores it unsharded, on the host: its params
    # and step against the gathered restored state (the moments reach
    # the bitwise step below)
    whole = ckpt.restore(abstract, ckdir, R3_STEPS - 1, device="cpu") \
        if rank == 0 else None
    refs = spec.tree_leaves(whole.params) if rank == 0 else None
    mism = 0 if rank else int(not torch.equal(whole.opt.step,
                                              st.opt.step.cpu()))
    n = 1
    for i, (x, s) in enumerate(zip(spec.tree_leaves(st.params),
                                   spec.tree_leaves(sh.params))):
        full = coll.gather_full(x, comm, s.dim_axes(x.dim()))
        if refs is not None:
            mism += not torch.equal(full.cpu(), refs[i])
        n += 1
        del full
    del whole, refs
    st, met = train(st, batches[-1])
    same = float(met["loss"]) == out["loss"][-1] and all(
        torch.equal(a, b) for a, b in zip(
            spec.tree_leaves(st.params) + spec.tree_leaves(st.opt.m)
            + spec.tree_leaves(st.opt.v),
            spec.tree_leaves(state.params) + spec.tree_leaves(state.opt.m)
            + spec.tree_leaves(state.opt.v)))
    r4.update({"unsharded_mismatches": mism, "leaves": n,
               "stepped_bitwise": same})
    out_r4 = r4
    del st, state, train
    torch.cuda.empty_cache()
    sec["R.4"] = time.perf_counter() - t_all + r4["save_s"]
    t_all = time.perf_counter()
    # R.3's float32 cut: Q.3's weights and batch, sharded gradients
    cut = Model(r_cut_config(torch.float32, Q3_LAYERS))
    cpctx = make_pctx(cut.cfg, mesh)
    clay = cut.layout(cpctx)
    params = spec.tree_map(lambda t, s: s.shard(t).to(dev),
                           cut.init(0, device="cpu"), clay.shardings)
    batch = q_batches(cut.cfg.vocab_size, Q3_SEQ, Q3_BATCH, 1, dev, 3)[0]
    _, g = tstep.value_and_grad(lambda p, bb: cut.loss(p, bb, cpctx),
                                params, batch)
    g = clay.reduce_grads(g)
    want = torch.load(tmp / "r3_grads.pt", mmap=True)
    sums = []
    for x, s, w in zip(spec.tree_leaves(g), spec.tree_leaves(clay.shardings),
                       want["grads"]):
        wb = w[s.block(w.shape)].to(dev).double()
        d2 = (x.double() - wb).pow(2).sum() if s.is_primary() else \
            torch.zeros((), dtype=torch.float64, device=dev)
        w2 = wb.pow(2).sum() if s.is_primary() else torch.zeros_like(d2)
        sums.append(torch.stack([d2, w2]))
    sums = coll.all_reduce(torch.stack(sums), comm, comm.names)
    gn = float(adamw.global_norm(g, clay.shardings))
    out["cut"] = {"leaf_rel": [float((a / b.clamp(min=1e-300)).sqrt())
                               for a, b in sums],
                  "norm_rel": abs(gn - want["norm"]) / want["norm"]}
    # row 16 and its plain version against a float64 dot of the same
    # float32 shard (these launches compare and are not counted)
    pin = ExecPolicy().override(dot="torch")
    ke, pe, sizes = [], [], []
    for x in spec.tree_leaves(g):
        d = x.double().ravel()
        w = float(torch.dot(d, d))
        ke.append(abs(float(dispatch.dot(x, x)) - w) / w)
        pe.append(abs(float(dispatch.dot(x, x, pin)) - w) / w)
        sizes.append(x.numel())
    out["dot64"] = {"kernel": ke, "plain": pe, "elements": sizes,
                    "kernel_max": max(ke), "plain_max": max(pe)}
    del g
    sec["R.3 cut"] = time.perf_counter() - t_all
    print(f"R.3 rank {rank}: losses {out['loss']}, ms {times}, state "
          f"{state_bytes / 2**30:.3f} GiB, peak {peak:.2f} GiB", flush=True)
    return {"R.3": out, "R.4": out_r4}


# ---------------------------------------------------------------------------
# path S: gradient flow and the fsdp profile over a mesh, and the dry run
# (launch/dryrun.py, analysis/stepcost.py, analysis/roofline.py)
# ---------------------------------------------------------------------------

#: S.1: four gloo ranks on the card (data 2 x model 2), Q.3's cut of
#: internlm2-1.8b (full width, Q3_LAYERS layers, its float32 weights
#: drawn on the CPU) and Q.5's gradient flow, whose ERK state is the
#: float32 parameters (rows 12 and 14 in float32), on a batch that
#: splits over data (S_BATCH x Q3_SEQ).  The gradient each stage takes
#: is evaluated in float64, in both runs alike (the float32 parameters
#: cast up inside the loss, the model's float32 accumulations widened):
#: the first float32 gradient's norm lies ~0.5 % from the float64 one in
#: either layout, on opposite sides (printed as "float32 gradients"),
#: enough to flip an attempt of the flow, so only float64 gradients make
#: the two layouts' steps comparable.  Gates: the ERK's steps and
#: attempts equal one card's unsharded step's; its initial step's two
#: norms (the mesh norm of the same vectors: the weights and their first
#: gradient) within S_NORM_RTOL; the parameters after the first accepted
#: attempt within S_FIRST_GATE of that step's own movement from the
#: weights (2-norm over every leaf); every replicated block equal, bit
#: for bit, on each of its replicas.  Three planted faults of one card's
#: step must lie past that gate: the weights unchanged, half the
#: update, and a wrong stage sum (the heun_euler table's second weight
#: halved).  The end parameters and the last norms are printed beside
#: those of runs of one card whose every norm was nudged by about the
#: mesh norm's own rounding (S_NUDGE, signs drawn from each run's seed),
#: which show how far that rounding alone carries the flow.  The
#: fsdp profile's loss within S_FSDP_RTOL of one card's (the reference's
#: GSPMD check, tests/test_distribution.py)
S_WORLD, S_DATA, S_MODEL, S_RANK_TIMEOUT = 4, 2, 2, 300
S_BATCH = 2
S_FSDP_RTOL = 1e-4
S_NORM_RTOL = 1e-6
S_FIRST_GATE = 0.01
S_NUDGE, S_NUDGE_RUNS = 1e-7, 8
#: S.1's attempts (Q.5 takes 6): its first accepted attempt is the 3rd
#: (PR 27), so 3 hold every gate at 7 float64 gradients through the
#: host, not 13 (with 6, S.1's ranks took 233 s and the whole script
#: 1095 s on an H100, past its 900 s budget: PERF.md, PR 28)
S_MAX_STEPS = 3
#: S.2: the dry run's cells on fake groups of this process (meta
#: tensors): two production cells on the 256-rank single mesh, the
#: fsdp profile of the first, R.3's cell on the 2 x 2 debug mesh and
#: Q.1's on a mesh of one
S2_CELLS = (("internlm2-1.8b", "train_4k", "tp_fsdp"),
            ("dbrx-132b", "train_4k", "tp_fsdp"),
            ("internlm2-1.8b", "train_4k", "fsdp"))
#: R.3's per-step collectives and state a rank (PERF.md, PR 26) when
#: path R did not run in this call: (calls, bytes rounded to MB), GiB
S_R3_PR26 = {"all_gather": (39, 315), "reduce_scatter": (21, 505),
             "all_to_all": (0, 0), "all_reduce": (17, 101)}
S_R3_STATE_GIB_PR26 = 1.176
S_KERNELS = ("linear_combination", "wrms_ss")


class SWatch:
    """Inside ``with``: ``gradflow.step``'s integrator watched.  Every
    WRMS norm it takes (the initial step's two, then one an attempt) is
    noted in ``values``, after it is multiplied by ``1 + d`` when
    ``nudge`` (a seed) is given, ``d`` of size S_NUDGE with a sign and a
    factor in [0.5, 1.5] drawn from the seed; ``first`` holds a copy of
    the state after the first accepted attempt."""

    def __init__(self, nudge=None):
        self.nudge = nudge

    def __enter__(self):
        import random
        from repro_torch.core import arkode
        from repro_torch.core import dispatch as dv
        self.values, self.first, self._mod = [], None, arkode
        self._real = real = arkode.erk_integrate
        self._real_step = real_step = arkode._erk_step
        rng = None if self.nudge is None else random.Random(self.nudge)
        pending = []

        def step(*a, **kw):
            out = real_step(*a, **kw)
            pending[:] = [out[0]]
            return out

        def erk(*a, norm=None, **kw):
            inner = norm or dv.wrms_norm

            def noted(v, w, policy=None):
                out = inner(v, w, policy)
                if rng is not None:
                    d = S_NUDGE * rng.choice((-1, 1)) * rng.uniform(0.5, 1.5)
                    out = out * (1 + d)
                self.values.append(float(out))
                if pending and self.first is None and self.values[-1] <= 1:
                    self.first = tuple(x.clone() for x in pending[0])
                pending.clear()
                return out
            return real(*a, norm=noted, **kw)

        arkode.erk_integrate, arkode._erk_step = erk, step
        return self

    def __exit__(self, *exc):
        self._mod.erk_integrate = self._real
        self._mod._erk_step = self._real_step
        return False


def s_batch(dev):
    return q_batches(r_cut_config().vocab_size, Q3_SEQ, S_BATCH, 1, dev, 3)[0]


class SWide:
    """Inside ``with``: the model's float32 accumulations (``f32`` of
    ``layers``, ``transformer``, ``moe_ep``, ``ssm`` and
    ``optim.adamw``) are float64, as
    ``tests/test_torch_sharded_train.py`` widens them."""

    def __enter__(self):
        import torch
        from repro_torch.models import layers, moe_ep, ssm, transformer
        from repro_torch.optim import adamw
        self._mods = (layers, transformer, moe_ep, ssm, adamw)
        for m in self._mods:
            m.f32 = torch.float64
        return self

    def __exit__(self, *exc):
        import torch
        for m in self._mods:
            m.f32 = torch.float32
        return False


def s_model(dtype=None):
    """S.1's model (Q.3's cut; float64 by default, for the loss of
    float32 weights) and its float32 weights drawn on the CPU."""
    import torch
    from repro_torch.models import Model
    weights = Model(r_cut_config(torch.float32, Q3_LAYERS)).init(
        0, device="cpu")
    return Model(r_cut_config(dtype or torch.float64, Q3_LAYERS)), weights


def s_loss(model, batch, pctx=None):
    """The loss of float32 parameters evaluated at the model's dtype."""
    from repro_torch.models import ParallelCtx, spec
    pctx = pctx or ParallelCtx()
    dt = model.cfg.dtype
    return lambda p: model.loss(spec.tree_map(lambda a: a.to(dt), p),
                                batch, pctx)


def s_grad_norm(loss, params, norm, lay=None):
    """The norm the ERK's initial step takes of the first gradient
    (``gradflow.step``'s right-hand side at ``params``): ``norm`` of the
    float32 gradient in the error weights of ``params``."""
    import torch
    from repro_torch.models import spec
    from repro_torch.optim import gradflow
    cfg = gradflow.GradFlowConfig()
    leaves = [x.detach().requires_grad_() for x in spec.tree_leaves(params)]
    with torch.enable_grad():
        val = loss(spec.tree_unflatten(params, leaves)).to(torch.float32)
        g = torch.autograd.grad(val, leaves, allow_unused=True,
                                materialize_grads=True)
    if lay is not None:
        g = spec.tree_leaves(lay.reduce_grads(spec.tree_unflatten(
            params, list(g))))
    w = tuple(1.0 / (cfg.rtol * x.detach().abs() + cfg.atol) for x in leaves)
    return float(norm(tuple(x.to(torch.float32) for x in g), w))


def s_dist(a, b) -> float:
    """||a - b|| / ||b|| over every leaf, in float64."""
    num = sum(float((x.double() - y.double()).pow(2).sum())
              for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return math.sqrt(num / den)


def s_single(dev):
    """S.1's single-card runs: the unsharded gradient-flow step (its
    kernels launched, no plain version), its first accepted attempt,
    the float32 gradient's norm, three planted faults and the runs with
    nudged norms."""
    import torch
    from repro_torch.core import butcher
    from repro_torch.core import dispatch as dv
    from repro_torch.models import spec
    from repro_torch.optim import gradflow
    model, weights = s_model()
    params = spec.tree_map(lambda a: a.to(dev), weights)
    start = spec.tree_leaves(params)
    batch = s_batch(dev)
    cfg = gradflow.GradFlowConfig(tau=Q5_TAU, max_steps=S_MAX_STEPS)
    t0 = time.perf_counter()
    with SWide(), SWatch() as watch:
        (p2, st), counts = q_counted(
            "S.1 single", lambda: gradflow.step(
                s_loss(model, batch), params, cfg), S_KERNELS)
        wall = time.perf_counter() - t0
        with torch.no_grad():
            loss = float(s_loss(model, batch)(params))
    check(watch.first is not None, "S.1 single: no attempt was accepted")
    first, end = watch.first, spec.tree_leaves(p2)
    moved1 = s_dist(first, start)
    out = {"steps": int(st.steps), "attempts": int(st.attempts),
           "first": [x.cpu() for x in first], "start": [x.cpu()
                                                       for x in start],
           "params": [x.cpu() for x in end], "moved": s_dist(end, start),
           "moved_first": moved1, "loss": loss, "wall_s": wall,
           "counts": counts, "norms": watch.values}
    # the first gradient's norm in float32 against float64
    m32 = s_model(torch.float32)[0]
    with SWide():
        g64 = s_grad_norm(s_loss(model, batch), params, dv.wrms_norm)
    g32 = s_grad_norm(s_loss(m32, batch), params, dv.wrms_norm)
    out["grad_norms"] = {"float32": g32, "float64": g64}
    # planted faults: the gate must fail each of them
    half = [s + 0.5 * (f - s) for s, f in zip(start, first)]
    plants = {"no-op": s_dist(start, first) / moved1,
              "half update": s_dist(half, first) / moved1}
    del half
    wrong = butcher.ERK_TABLES[cfg.table]._replace(
        b=(butcher.ERK_TABLES[cfg.table].b[0],
           0.5 * butcher.ERK_TABLES[cfg.table].b[1]))
    real_tables = butcher.ERK_TABLES
    butcher.ERK_TABLES = dict(real_tables, **{cfg.table: wrong})
    try:
        with SWide(), SWatch() as w:
            gradflow.step(s_loss(model, batch), params, cfg)
    finally:
        butcher.ERK_TABLES = real_tables
    plants["wrong stage sum"] = float("inf") if w.first is None else \
        s_dist(w.first, first) / moved1
    out["plants"] = plants
    # the flow's own sensitivity: the same step with every norm nudged
    out["nudged"] = []
    for seed in range(S_NUDGE_RUNS):
        with SWide(), SWatch(nudge=seed) as w:
            p3, st3 = gradflow.step(s_loss(model, batch), params, cfg)
        out["nudged"].append({
            "seed": seed, "steps": int(st3.steps),
            "attempts": int(st3.attempts), "norms": w.values,
            "first_rel": float("inf") if w.first is None else
            s_dist(w.first, first) / moved1,
            "end_dist": s_dist(spec.tree_leaves(p3), end)})
        del p3, w
    del params, p2, first, end, start
    torch.cuda.empty_cache()
    return out


def s_replica_drift(leaves, shardings, comm) -> float:
    """The largest difference between the replicas of a block (the
    blocks of a leaf over the mesh axes its sharding does not use),
    over the block's largest entry: 0 when every replica holds the same
    bits, as one program's replicated values do."""
    from repro_torch.parallel import collectives as coll
    worst = 0.0
    for x, s in zip(leaves, shardings):
        rep = tuple(a for a in comm.names if a not in s.used_axes())
        if not rep:
            continue
        every = coll.all_gather(x.reshape(1, -1), comm, rep, 0)
        worst = max(worst, float((every - every[:1]).abs().max()
                                 / every.abs().max().clamp(min=1e-30)))
    return worst


def s_gradflow_rank(mesh, dev, rank, tmp):
    """S.1 on this rank: gradflow.step over the mesh, counted; rows 12
    and 14 held to their plain versions on this rank's shards; the
    float32 gradient's norm; the fsdp profile's loss."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import vecops
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import make_pctx
    from repro_torch.models import spec
    from repro_torch.optim import gradflow
    from repro_torch.parallel import collectives as coll
    comm = coll.comm_of(mesh)
    model, full = s_model()
    pctx = make_pctx(model.cfg, mesh)
    lay = model.layout(pctx)
    local = spec.tree_map(lambda t, s: s.shard(t).to(dev), full,
                          lay.shardings)
    batch = s_batch(dev)
    cfg = gradflow.GradFlowConfig(tau=Q5_TAU, max_steps=S_MAX_STEPS)
    p_peak_reset()
    t0 = time.perf_counter()
    with SWide(), SWatch() as watch:
        (p2, st), counts = q_counted(
            f"S.1 rank {rank}", lambda: gradflow.step(
                s_loss(model, batch, pctx), local, cfg, layout=lay),
            S_KERNELS)
    wall = time.perf_counter() - t0
    out = {"steps": int(st.steps), "attempts": int(st.attempts),
           "norms": watch.values,
           "wall_s": wall, "peak_gib": p_peak_gib(),
           "counts": {k: list(v) for k, v in counts.items()},
           "state_bytes": p_bytes(local)}
    check(watch.first is not None, f"S.1 rank {rank}: no attempt was "
          f"accepted")
    sh = spec.tree_leaves(lay.shardings)
    for name, leaves in (("first", watch.first),
                         ("params", spec.tree_leaves(p2))):
        out[f"drift_{name}"] = s_replica_drift(leaves, sh, comm)
        gathered = [coll.gather_full(x, comm, s.dim_axes(x.dim())).cpu()
                    for x, s in zip(leaves, sh)]
        if rank == 0:
            torch.save(gathered, tmp / f"s1_{name}.pt")
        del gathered
    # the first gradient's norm in float32 (the mesh norm)
    m32 = s_model(torch.float32)[0]
    out["grad_norm32"] = s_grad_norm(s_loss(m32, batch, pctx), local,
                                     gradflow.mesh_norm(lay.shardings), lay)
    # rows 12 and 14 against their plain versions on this rank's shards
    # (these launches compare, after the counts were read)
    leaves = [x for x in spec.tree_leaves(p2)]
    big = max(leaves, key=lambda t: t.numel())
    xs = [big, big.flip(0).contiguous(), (big * 0.5).contiguous()]
    cs = [0.5, -1.25, 2.0]
    k12 = vecops.linear_combination(cs, xs)
    p12 = vecops.linear_combination_plain(cs, xs)
    w = 1.0 / (1e-3 * big.abs() + 1e-6)
    k14, p14 = vecops.wrms_ss(big, w), vecops.wrms_ss_plain(big, w)
    scale = float(p12.abs().max())
    out["compare"] = {
        "elements": big.numel(),
        "lincomb_max_abs_err": float((k12 - p12).abs().max()),
        "lincomb_scale": scale,
        "wrms_ss_rel_err": abs(float(k14) - float(p14)) / abs(float(p14))}
    # the fsdp profile's loss on this rank's shards
    fp = dryrun.make_pctx(model.cfg, mesh, "train", "fsdp")
    fsh = model.param_shardings(fp)
    fl = spec.tree_map(lambda t, s: s.shard(t).to(dev), full, fsh)
    coll.reset_counts()
    kernels.reset_counts()
    with SWide(), torch.no_grad():
        t0 = time.perf_counter()
        out["fsdp_loss"] = float(s_loss(model, batch, fp)(fl))
        out["fsdp_s"] = time.perf_counter() - t0
    out["fsdp_collectives"] = coll.counts()
    out["fsdp_state_bytes"] = p_bytes(fl)
    check(all(v == (0, 0) for v in kernels.counts().values()),
          f"S.1 rank {rank}: the fsdp loss reached a kernel row")
    del local, p2, fl, full, xs, k12, p12, w, watch
    torch.cuda.empty_cache()
    print(f"S.1 rank {rank}: {out['steps']} steps / {out['attempts']} "
          f"attempts, {wall:.2f} s, rows 12 and 14 launched "
          f"{counts['linear_combination'][0]} and {counts['wrms_ss'][0]} "
          f"times; fsdp loss {out['fsdp_loss']:.7f} in {out['fsdp_s']:.2f} "
          f"s", flush=True)
    return out


def path_s_rank(argv) -> int:
    """One rank of S.1 (``--path-s-rank RANK WORLD DIR``): joins the gloo
    group through ``DIR/store`` and saves its record to
    ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import collectives as coll
    rank, world, tmp = int(argv[0]), int(argv[1]), Path(argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh, mesh_device
        mesh = make_debug_mesh(S_DATA, S_MODEL)
        dev = mesh_device(mesh)
        check(dev.type == "cuda", f"S rank {rank}: device {dev}")
        rec = {"S.1": s_gradflow_rank(mesh, dev, rank, tmp)}
        torch.save(rec, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        coll.close()
    return 0


def s_fmt(values):
    return " ".join(f"{v:.9g}" for v in values)


def s_check_ranks(ranks, single, tmp):
    """S.1's records printed, then its gates: equal ERK counts, the
    initial norms, the first accepted attempt's parameters within the
    gate and every planted fault past it, rows 12 and 14 launched on
    every rank and held to their plain versions, the fsdp loss."""
    import torch
    got1 = torch.load(tmp / "s1_first.pt")
    got = torch.load(tmp / "s1_params.pt")
    moved1 = single["moved_first"]
    rel1 = s_dist(got1, single["first"]) / moved1
    end = s_dist(got, single["params"])
    del got1, got
    x0 = ranks[0]["S.1"]
    nudged = single["nudged"]
    # the initial step's two norms read the same vectors in both runs (the
    # weights, their first gradient): only the mesh norm's sum differs
    n0 = [abs(a - b) / abs(b) for a, b in zip(x0["norms"][:2],
                                              single["norms"][:2])]
    g = single["grad_norms"]
    total = dict(single["counts"])
    print("S.1 the ERK's WRMS norms (the initial step's two, then one an "
          "attempt; an attempt passes at <= 1): one card "
          + s_fmt(single["norms"]) + "; sharded " + s_fmt(x0["norms"])
          + f" (the initial step's two: rel {n0[0]:.3g}, {n0[1]:.3g}); "
          f"with every norm nudged by ~{S_NUDGE:g}: "
          + "; ".join(s_fmt(n["norms"]) for n in nudged), flush=True)
    print(f"S.1 float32 gradients: the first gradient's norm {g['float32']:.9g}"
          f" on one card, " + ", ".join(f"{rk['S.1']['grad_norm32']:.9g}"
                                       for rk in ranks)
          + f" sharded, against {g['float64']:.9g} in float64 on one card "
          f"(rel {abs(g['float32'] / g['float64'] - 1):.3g}, "
          + ", ".join(f"{abs(rk['S.1']['grad_norm32'] / g['float64'] - 1):.3g}"
                      for rk in ranks) + ")", flush=True)
    for r, rk in enumerate(ranks):
        x = rk["S.1"]
        q_add(total, {k: tuple(v) for k, v in x["counts"].items()})
        c = x["compare"]
        print(f"S.1 rank {r}: {x['steps']} steps / {x['attempts']} "
              f"attempts; rows 12 and 14 against their plain versions "
              f"on a {c['elements']}-element shard: lincomb max abs err "
              f"{c['lincomb_max_abs_err']:.3g} (scale "
              f"{c['lincomb_scale']:.3g}), wrms_ss rel err "
              f"{c['wrms_ss_rel_err']:.3g} (tolerance "
              f"{TOL['torch.float32']}); replicas' largest difference "
              f"after the first accepted attempt {x['drift_first']:.3g}, "
              f"after the step {x['drift_params']:.3g}; peak "
              f"{x['peak_gib']:.2f} GiB, "
              f"state {x['state_bytes'] / 2**30:.3f} GiB, fsdp state "
              f"{x['fsdp_state_bytes'] / 2**30:.3f} GiB, fsdp loss's "
              f"collectives {x['fsdp_collectives']}", flush=True)
    fsdp_rel = max(abs(rk["S.1"]["fsdp_loss"] - single["loss"]) /
                   abs(single["loss"]) for rk in ranks)
    plants = single["plants"]
    print(f"S.1 gradflow over data={S_DATA} x model={S_MODEL} (heun_euler, "
          f"tau {Q5_TAU}, max_steps {S_MAX_STEPS}, Q.3's cut, batch "
          f"{S_BATCH} x {Q3_SEQ}): one card {single['steps']} steps / "
          f"{single['attempts']} attempts ({single['wall_s']:.2f} s), "
          f"sharded " + ", ".join(f"{rk['S.1']['steps']} / "
                                  f"{rk['S.1']['attempts']}" for rk in ranks)
          + " (" + ", ".join(f"{rk['S.1']['wall_s']:.2f}" for rk in ranks)
          + f" s a rank); the first accepted attempt moved the params "
          f"{moved1:.3g} (relative), the sharded run's lie {rel1:.3g} of "
          f"that movement from one card's (gate {S_FIRST_GATE}), the "
          f"nudged runs' " + ", ".join(f"{n['first_rel']:.3g}"
                                       for n in nudged)
          + "; planted faults " + ", ".join(f"{k} {v:.3g}"
                                            for k, v in plants.items())
          + f"; after the step (moved {single['moved']:.3g}): sharded "
          f"{end:.3g} from one card's, nudged " + ", ".join(
              f"{n['end_dist']:.3g}" for n in nudged) + "; counts nudged "
          + ", ".join(f"{n['steps']} / {n['attempts']}" for n in nudged)
          + f"; fsdp loss max rel {fsdp_rel:.3g} (gate {S_FSDP_RTOL}); "
          f"rows 12 and 14 launched " + ", ".join(
              f"{k} {total[k][0]}" for k in S_KERNELS) + " over the ranks",
          flush=True)
    for r, rk in enumerate(ranks):
        x, c = rk["S.1"], rk["S.1"]["compare"]
        check(x["steps"] == single["steps"] and
              x["attempts"] == single["attempts"],
              f"S.1 rank {r}: {x['steps']}/{x['attempts']} steps/attempts "
              f"against one card's {single['steps']}/{single['attempts']}")
        check(all(x["counts"][k][0] > 0 for k in S_KERNELS) and
              all(v[1] == 0 for v in x["counts"].values()),
              f"S.1 rank {r}: rows 12 and 14 not launched, or a plain "
              f"version ran on the card: {x['counts']}")
        check(x["drift_first"] == 0 and x["drift_params"] == 0,
              f"S.1 rank {r}: the replicas of a block differ: after the "
              f"first accepted attempt {x['drift_first']:.3g}, after the "
              f"step {x['drift_params']:.3g}")
        check(c["lincomb_max_abs_err"] <= TOL["torch.float32"] *
              c["lincomb_scale"] and c["wrms_ss_rel_err"] <=
              TOL["torch.float32"], f"S.1 rank {r}: a row disagrees with "
              f"its plain version: {c}")
    check(max(n0) <= S_NORM_RTOL, f"S.1: the initial step's norms lie "
          f"{n0} from one card's (gate {S_NORM_RTOL})")
    check(fsdp_rel <= S_FSDP_RTOL, f"S.1: the fsdp loss is {fsdp_rel:.3g} "
          f"from one card's (gate {S_FSDP_RTOL})")
    check(rel1 <= S_FIRST_GATE, f"S.1: after the first accepted attempt "
          f"the gathered params lie {rel1:.3g} of the step's movement from "
          f"one card's (gate {S_FIRST_GATE})")
    check(all(v > S_FIRST_GATE for v in plants.values()), f"S.1: a planted "
          f"fault passes the gate {S_FIRST_GATE}: {plants}")
    return {"steps": x0["steps"], "attempts": x0["attempts"],
            "first_rel": rel1, "moved_first": moved1,
            "end_dist": end, "moved": single["moved"],
            "plants": plants, "grad_norms": g,
            "initial_norms_rel": n0,
            "fsdp_loss_rel": fsdp_rel, "single": {
                k: v for k, v in single.items()
                if k not in ("params", "start", "first", "counts",
                             "nudged")},
            "nudged": nudged,
            "ranks": [{k: v for k, v in rk["S.1"].items() if k != "counts"}
                      for rk in ranks]}, total


def s_cell(label, run, rows, path="S.2"):
    """One dry-run cell: run it, print its roofline row and seconds."""
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = run()
    sec = time.perf_counter() - t0
    counts = kernels.counts()
    check(res["ok"], f"{path} {label}: {res.get('error')}")
    check(all(v[0] == 0 for v in counts.values()),
          f"{path} {label}: a kernel launched on abstract tensors: {counts}")
    abstract = res["stepcost"]["rows"].get("dot", {}).get("calls", 0)
    check(counts["dot"][1] == abstract, f"{path} {label}: row 16's plain "
          f"version ran {counts['dot'][1]} times, {abstract} of them on "
          f"abstract tensors")
    mem = res["memory"]
    print(f"{path} {label}: {sec:.2f} s; flops "
          f"{res['stepcost']['flops']:.4g}, "
          f"bytes {res['stepcost']['bytes']:.4g}, ring bytes "
          f"{res['stepcost']['coll_total']:.4g} "
          f"({res['stepcost']['coll_net']:.4g} across nodes) a rank; "
          f"collectives {res['collectives']}; arguments "
          f"{mem['argument_bytes'] / 2**30:.4f} GiB, state "
          f"{mem['state_bytes'] / 2**30:.4f} GiB, peak "
          f"{mem['peak_bytes'] / 2**30:.2f} GiB a rank; row 16 on abstract "
          f"tensors {abstract} calls; roofline (estimates) "
          + dryrun.row_line(res["roofline"]), flush=True)
    rows[label] = dict(res, seconds=sec)
    return res


def s_dryrun(r3):
    """S.2: the dry run's cells in this process, each on a fake group of
    its mesh's size; R.3's cell against R.3's own counts (``r3``: path
    R's record of this call, or None for PR 26's figures)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    rows = {}
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        for arch, shape, profile in S2_CELLS:
            s_cell(f"{arch} {shape} single {profile}",
                   lambda: dryrun.lower_cell(arch, shape, mesh, "single",
                                             profile=profile), rows)
    ocfg = adamw.AdamWConfig(lr=Q_LR, warmup_steps=1, total_steps=Q_STEPS)
    q1 = ShapeConfig("q1", Q_SEQ, Q_BATCH, "train")
    with dryrun.fake_world(R_WORLD):
        mesh = make_debug_mesh(R_DATA, R_MODEL)
        res = s_cell("R.3's cell (2 layers, data 2 x model 2, tp_fsdp)",
                     lambda: dryrun.lower_cell(Q_ARCH, q1, mesh, "debug",
                                               ocfg=ocfg,
                                               cfg=r_cut_config()), rows)
    with dryrun.fake_world(1):
        mesh = make_debug_mesh(1, 1)
        q1res = s_cell("Q.1's cell (one card)", lambda: dryrun.lower_cell(
            Q_ARCH, q1, mesh, "one", ocfg=ocfg), rows)
    got = {k: tuple(v) for k, v in res["collectives"].items()}
    state = res["memory"]["state_bytes"]
    if r3 is not None:
        want = {k: tuple(v) for k, v in
                r3["ranks"][0]["collectives_per_step"].items()}
        want_state = r3["ranks"][0]["state_bytes"]
        check(got == want, f"S.2: R.3's cell counts {got}, R.3 counted "
              f"{want} a step")
        check(state == want_state, f"S.2: R.3's cell holds {state} bytes "
              f"of state a rank, R.3 measured {want_state}")
        source = "path R.3's own record in this call"
    else:
        mb = {k: (c, round(b / 1e6)) for k, (c, b) in got.items()}
        check(mb == S_R3_PR26, f"S.2: R.3's cell counts {mb} (calls, MB), "
              f"R.3 counted {S_R3_PR26} (PR 26)")
        check(round(state / 2**30, 3) == S_R3_STATE_GIB_PR26,
              f"S.2: R.3's cell holds {state / 2**30:.4f} GiB a rank, R.3 "
              f"{S_R3_STATE_GIB_PR26}")
        source = "PR 26's R.3 figures (path R did not run)"
    print(f"S.2 R.3's cell: collectives {got} and state "
          f"{state / 2**30:.4f} GiB a rank equal {source}; Q.1's cell "
          f"counts {q1res['stepcost']['matmul_flops'] / 1e12:.2f} TFLOP of "
          f"matmuls a step ({q1res['stepcost']['flops'] / 1e12:.2f} with "
          f"row 16's), model flops 6*N*T "
          f"{q1res['roofline']['model_flops'] / 1e12:.2f} TFLOP", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_path_s(card, r3=None, dev=None):
    """Path S: S.1 gradient flow (and the fsdp profile's loss) over a
    2 x 2 mesh in four gloo ranks on this card, against one card; S.2 the
    dry run of production cells on fake groups in this process while the
    ranks run, R.3's cell against R.3's counts."""
    import shutil
    import tempfile
    import torch
    dev = dev or torch.device("cuda")
    print(card, flush=True)
    torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    rec = {"seconds": {}}
    t = time.perf_counter()
    single = s_single(dev)
    rec["seconds"]["S.1 single"] = time.perf_counter() - t
    tmp = Path(tempfile.mkdtemp(prefix="path_s_", dir=OUT))
    try:
        t = time.perf_counter()
        started = start_ranks(S_WORLD, False, "--path-s-rank", tmp)
        try:
            rec["S.2"] = s_dryrun(r3)
            rec["seconds"]["S.2 (beside the ranks)"] = \
                time.perf_counter() - t
        finally:
            ranks = wait_ranks(started, tmp, S_RANK_TIMEOUT, "S")
        rec["seconds"]["S.1 ranks"] = time.perf_counter() - t
        rec["S.1"], total = s_check_ranks(ranks, single, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("path S seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rec["seconds"].items()), flush=True)
    print("path S: kernel launches " + ", ".join(
        f"{k} {v[0]}" for k, v in total.items() if v[0]), flush=True)
    rec["kernels_run"] = {"counts": total}
    return rec


# ---------------------------------------------------------------------------
# path T: every family under the fsdp profile, the decode caches in the
# reference's layout
# ---------------------------------------------------------------------------

T_WORLD, T_DATA, T_MODEL, T_RANK_TIMEOUT = 4, 2, 2, 600
#: T.1: (arch, layers, tokens) of each family's FULL width cut in depth
#: (None: whole), float32 weights drawn on the CPU (seed 0) evaluated in
#: float64 (the modules' float32 accumulations widened); a batch of
#: T_BATCH rows (numpy seed 5), whose sequence splits over `model`;
#: qwen2-vl's first T_VIS positions a vision prefix, which ends inside
#: the first model rank's block; whisper's frames as many as its tokens.
#: xlstm-125m takes 64 tokens: its recurrence amplifies a rounding
#: error ~e^0.1 a token, so at 256 a nudge of the embedding by 1e-15
#: moves one card's float64 gradient 0.52 of its largest entry and by
#: 1e-13 0.127 (at 64: 8.7e-8 for both, the float32 rounding of the
#: gradient; tools/xlstm_nudge_witness.py), and no gate below 1 could
#: hold the sharded run to it
#: zamba2-7b takes one layer, which keeps its shared-attention site
#: (layer 0): the script's time (PERF.md, Open questions)
T1_CUTS = (("zamba2-7b", 1, 256), ("xlstm-125m", 2, 64),
           ("whisper-tiny", None, 256), ("qwen2-vl-2b", 2, 256))
T_BATCH, T_VIS = 2, 100
#: T.1's gates, fixed: the float64 loss's relative difference from one
#: card's; each float32 gradient leaf's largest difference over its
#: largest entry, where both are finite (the float64 gradients rounded
#: to float32: one ulp is 1.2e-7).  zamba2's and xlstm's gradients hold
#: NaN at these widths in both packages (ROADMAP C): the sharded ones
#: must hold it exactly where one card's do.  One card's own loss and
#: gradients with the embedding nudged by a factor 1 + each T1_NUDGES
#: must be finite and inside the same gates (else one card's result
#: cannot resolve them and T.1 fails), and on every rank a planted
#: fault, one gradient leaf halved, must lie past them
T1_LOSS_RTOL, T1_GRAD_RTOL = 1e-9, 1e-6
T1_NUDGES = (1e-15, 1e-13)
#: T.2: qwen2-vl-2b's width cut to T2_LAYERS, float32 weights evaluated
#: in float64, on data 1 x model 4 (12 heads split 4 ways; its 2 kv heads
#: do not, so the caches split head_dim 128 = 4 x 32); a prefill of
#: T2_PROMPT tokens (numpy seed 7) in one decode step, then T2_STEPS
#: greedy steps
T2_ARCH, T2_LAYERS, T2_DATA, T2_MODEL = "qwen2-vl-2b", 2, 1, 4
T2_PROMPT, T2_STEPS = 4096, 8
#: T.2's gate: each step's logits' largest difference from one card's
#: over their largest magnitude (the tokens must be equal; in float32
#: the two lay 1.49e-4 apart, past the 1e-4 first set: PERF.md, PR 28)
T2_LOGIT_RTOL = 1e-9
#: T.3: the dry run's cells (meta tensors, a fake group of 256 in this
#: process while T.1 and T.2's ranks run: the script's time budget
#: leaves no room to run it alone, so the ranks' times include its
#: share of the host); qwen2-72b
#: decode_32k's arguments a rank must fall below T3_ARG_GIB (80.68 GiB
#: with every kv head on every model rank, PR 27; about 5.7 GiB in the
#: reference's layout)
T3_CELLS = (("zamba2-7b", "train_4k", "fsdp"),
            ("whisper-tiny", "train_4k", "fsdp"),
            ("qwen2-vl-2b", "train_4k", "fsdp"),
            ("qwen2-72b", "decode_32k", "tp_fsdp"))
T3_ARG_GIB = 8.0


def t_model(arch, layers, dtype):
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return Model(cfg.replace(dtype=dtype))


def t_weights(arch, layers):
    """The float32 weights of a T config, drawn on the CPU."""
    import torch
    return t_model(arch, layers, torch.float32).init(0, device="cpu")


def t1_batch(cfg, seq, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    s = seq - T_VIS if cfg.mrope else seq
    batch = {k: rng.integers(0, cfg.vocab_size, (T_BATCH, s), np.int32)
             for k in ("tokens", "targets")}
    if cfg.mrope:
        batch["vis_embeds"] = 0.02 * rng.standard_normal(
            (T_BATCH, T_VIS, cfg.d_model))
    if cfg.enc_dec:
        batch["frames"] = 0.02 * rng.standard_normal(
            (T_BATCH, seq, cfg.d_model))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def t1_grads(model, params, batch, pctx=None, nudge=0.0):
    """(float64 loss, float32 gradients) of float32 ``params`` evaluated
    in float64 (the embedding times ``1 + nudge``); under a mesh each
    leaf's gradient in its layout."""
    from repro_torch.models import ParallelCtx, spec
    from repro_torch.train import step as tstep

    def loss(p, b):
        p = spec.tree_map(lambda a: a.to(model.cfg.dtype), p)
        if nudge:
            p = dict(p, embed=p["embed"] * (1 + nudge))
        return model.loss(p, b, pctx or ParallelCtx())

    with SWide():
        val, g = tstep.value_and_grad(loss, params, batch)
    if pctx is not None:
        g = model.layout(pctx).reduce_grads(g)
    return val, g


def t1_scale(b) -> float:
    """``b``'s largest finite magnitude (0 if none)."""
    import torch
    fin = b[torch.isfinite(b)]
    return float(fin.abs().max()) if fin.numel() else 0.0


def t1_rel(a, b, scale=None):
    """The largest difference of ``a`` from ``b`` where both are finite,
    over ``scale`` (default: ``b``'s largest finite magnitude); inf when
    their non-finite entries lie apart."""
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return float("inf")
    if scale is None:
        scale = t1_scale(b)
    err = float((a[fb] - b[fb]).abs().max()) if fb.any() else 0.0
    return err / max(scale, 1e-30)


def t2_run(model, params, dev, pctx=None):
    """T.2 on one card or a mesh: the prompt's prefill in one decode
    step, then greedy steps: -> tokens, each step's logits (on the CPU),
    ms a step, the prefill's seconds, the caches' bytes, collectives."""
    import torch
    from repro_torch.models import ParallelCtx
    from repro_torch.parallel import collectives as coll
    from repro_torch.serve.decode import sample_token
    pctx = pctx or ParallelCtx()
    prompt = p_tokens(7, (1, T2_PROMPT), model.cfg.vocab_size, dev)
    out = {"tokens": [], "logits": [], "ms": []}
    with torch.no_grad(), SWide():
        caches = model.init_cache(1, T2_PROMPT + T2_STEPS, device=dev,
                                  pctx=pctx)
        coll.reset_counts()
        p_sync()
        t0 = time.perf_counter()
        y, _ = model.decode_step(params, {"tokens": prompt, "pos": 0},
                                 caches, pctx)
        tok = sample_token(y)
        p_sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_collectives"] = coll.counts()
        del y
        for i in range(T2_STEPS):
            coll.reset_counts()
            p_sync()
            t0 = time.perf_counter()
            y, _ = model.decode_step(params, {"tokens": tok,
                                              "pos": T2_PROMPT + i},
                                     caches, pctx)
            p_sync()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["tokens"].append(int(tok))
            out["logits"].append(y.cpu())
            tok = sample_token(y)
        out["step_collectives"] = coll.counts()
    out["cache_bytes"] = p_bytes(caches)
    out["kv_bytes"] = p_bytes({k: caches[k] for k in ("k", "v")})
    out["kv_shape"] = tuple(caches["k"].shape)
    return out


def t_single(dev, tmp):
    """One card's T.1 gradients (saved for the ranks) and T.2 run."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import spec
    kernels.reset_counts()
    out = {}
    for arch, layers, seq in T1_CUTS:
        model = t_model(arch, layers, torch.float64)
        params = spec.tree_map(lambda a: a.to(dev), t_weights(arch, layers))
        batch = t1_batch(model.cfg, seq, dev)
        p_peak_reset()
        t0 = time.perf_counter()
        loss, g = t1_grads(model, params, batch)
        p_sync()
        out[arch] = {"loss": float(loss),
                     "ms": 1e3 * (time.perf_counter() - t0),
                     "peak_gib": p_peak_gib(),
                     "state_bytes": p_bytes(params)}
        # the model's own sensitivity: the same step, the embedding nudged
        out[arch]["nudged"] = []
        for nudge in T1_NUDGES:
            loss_n, g_n = t1_grads(model, params, batch, nudge=nudge)
            out[arch]["nudged"].append((
                abs(float(loss_n - loss)) / abs(float(loss)),
                max(t1_rel(a, b) for a, b in zip(spec.tree_leaves(g_n),
                                                 spec.tree_leaves(g)))))
            del g_n
        out[arch]["nonfinite"] = sum(int((~torch.isfinite(x)).sum())
                                     for x in spec.tree_leaves(g))
        torch.save({"loss": float(loss),
                    "grads": [x.cpu() for x in spec.tree_leaves(g)]},
                   tmp / f"t1_{arch}.pt")
        print(f"T.1 one card {arch}: loss {float(loss):.12g}, "
              f"{out[arch]['ms']:.1f} ms (the first step), peak "
              f"{out[arch]['peak_gib']:.2f} GiB; {out[arch]['nonfinite']} "
              f"non-finite gradient entries; nudges "
              f"{t1_fmt_nudged(out[arch])}", flush=True)
        del params, g, batch
        torch.cuda.empty_cache()
    model = t_model(T2_ARCH, T2_LAYERS, torch.float64)
    params = spec.tree_map(lambda a: a.to(dev, torch.float64),
                           t_weights(T2_ARCH, T2_LAYERS))
    out["T.2"] = t2_run(model, params, dev)
    torch.save(out["T.2"], tmp / "t2.pt")
    del params
    torch.cuda.empty_cache()
    counts = kernels.counts()
    check(all(v == (0, 0) for v in counts.values()),
          f"T one card launched a kernel or a plain version: {counts}")
    return out


def t1_fmt_nudged(one) -> str:
    """One card's nudged readings: "n: loss rel, gradients rel; ..."."""
    return "; ".join(f"{n:g}: loss {lr:.3g}, gradients {gr:.3g}"
                     for n, (lr, gr) in zip(T1_NUDGES, one["nudged"]))


def t1_planted(grads, shardings, ref, rank):
    """A planted fault: the first gradient leaf from ``rank`` on (modulo
    their number) with a finite non-zero entry on this rank, halved,
    measured as T.1 measures each leaf: -> (leaf index, relative
    difference)."""
    import torch
    n = len(grads)
    for j in range(n):
        i = (rank + j) % n
        x = grads[i].cpu()
        fin = x[torch.isfinite(x)]
        if fin.numel() and bool((fin != 0).any()):
            return i, t1_rel(0.5 * x, shardings[i].shard(ref[i]),
                             t1_scale(ref[i]))
    raise AssertionError(f"T.1 rank {rank}: no leaf to plant a fault in")


def t1_rank(mesh, dev, tmp, rank):
    """T.1 on this rank: each family's fsdp loss and gradients on its
    shards (one step, this process's first of the family), against one
    card's, and a planted fault measured alike."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import spec
    from repro_torch.parallel import collectives as coll
    out = {}
    for arch, layers, seq in T1_CUTS:
        model = t_model(arch, layers, torch.float64)
        pctx = dryrun.make_pctx(model.cfg, mesh, "train", "fsdp")
        sh = model.param_shardings(pctx)
        local = spec.tree_map(lambda t, s: s.shard(t).to(dev),
                              t_weights(arch, layers), sh)
        batch = t1_batch(model.cfg, seq, dev)
        rec = {"state_bytes": p_bytes(local)}
        coll.reset_counts()
        p_peak_reset()
        t0 = time.perf_counter()
        loss, g = t1_grads(model, local, batch, pctx)
        p_sync()
        rec["ms"] = 1e3 * (time.perf_counter() - t0)
        rec["peak_gib"] = p_peak_gib()
        rec["collectives"] = coll.counts()
        ref = torch.load(tmp / f"t1_{arch}.pt", mmap=True)
        rec["loss"] = float(loss)
        rec["loss_rel"] = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
        errs = [t1_rel(x.cpu(), s.shard(w), t1_scale(w))
                for x, s, w in zip(spec.tree_leaves(g), spec.tree_leaves(sh),
                                   ref["grads"])]
        rec["grad_rel"], rec["leaves"] = max(errs), len(errs)
        rec["planted"] = t1_planted(spec.tree_leaves(g), spec.tree_leaves(sh),
                                    ref["grads"], rank)
        out[arch] = rec
        print(f"T.1 rank {rank} {arch}: loss rel {rec['loss_rel']:.3g}, "
              f"gradients rel {rec['grad_rel']:.3g} over {len(errs)} "
              f"leaves; planted fault (leaf {rec['planted'][0]} halved) "
              f"{rec['planted'][1]:.3g}; {rec['ms']:.0f} ms", flush=True)
        del local, g, ref, batch
        torch.cuda.empty_cache()
    return out


def t2_rank(mesh, dev, tmp, rank):
    """T.2 on this rank: the prefill and greedy steps over caches whose
    head_dim is split over `model`, against one card's."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import spec
    model = t_model(T2_ARCH, T2_LAYERS, torch.float64)
    pctx = dryrun.make_pctx(model.cfg, mesh, "decode", "tp_fsdp")
    local = spec.tree_map(lambda t, s: s.shard(t).to(dev, torch.float64),
                          t_weights(T2_ARCH, T2_LAYERS),
                          model.param_shardings(pctx))
    out = t2_run(model, local, dev, pctx)
    ref = torch.load(tmp / "t2.pt")
    out["logit_rel"] = [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(out.pop("logits"), ref["logits"])]
    out["tokens_equal"] = out["tokens"] == ref["tokens"]
    print(f"T.2 rank {rank}: prefill {out['prefill_s']:.2f} s, steps "
          + ", ".join(f"{m:.1f}" for m in out["ms"]) + " ms; logits rel "
          f"{max(out['logit_rel']):.3g}; tokens equal {out['tokens_equal']}",
          flush=True)
    return out


def path_t_rank(argv) -> int:
    """One rank of T.1 and T.2 (``--path-t-rank RANK WORLD DIR``): joins
    the gloo group through ``DIR/store`` and saves its record to
    ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.parallel import collectives as coll
    rank, world, tmp = int(argv[0]), int(argv[1]), Path(argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh, mesh_device
        mesh = make_debug_mesh(T_DATA, T_MODEL)
        dev = mesh_device(mesh)
        check(dev.type == "cuda", f"T rank {rank}: device {dev}")
        kernels.reset_counts()
        t0 = time.perf_counter()
        rec = {"T.1": t1_rank(mesh, dev, tmp, rank)}
        sec = {"T.1": time.perf_counter() - t0}
        t0 = time.perf_counter()
        rec["T.2"] = t2_rank(make_debug_mesh(T2_DATA, T2_MODEL), dev, tmp,
                             rank)
        sec["T.2"] = time.perf_counter() - t0
        rec["seconds"] = sec
        rec["kernels"] = kernels.counts()
        torch.save(rec, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        coll.close()
    return 0


def t3_dryrun():
    """T.3: the dry run's cells in this process, on a fake group of 256
    (meta tensors: no device work)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    rows = {}
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        for arch, shape, profile in T3_CELLS:
            s_cell(f"{arch} {shape} single {profile}",
                   lambda: dryrun.lower_cell(arch, shape, mesh, "single",
                                             profile=profile), rows, "T.3")
    dec = rows["qwen2-72b decode_32k single tp_fsdp"]["memory"]
    check(dec["fits"] and dec["argument_bytes"] < T3_ARG_GIB * 2**30,
          f"T.3 qwen2-72b decode_32k: arguments "
          f"{dec['argument_bytes'] / 2**30:.3f} GiB a rank, fits "
          f"{dec['fits']} (gate < {T3_ARG_GIB} GiB and fits)")
    return rows


def t_check_ranks(ranks, single):
    """T.1 and T.2's records printed, then their gates."""
    gl, gg = T1_LOSS_RTOL, T1_GRAD_RTOL
    for arch, _, seq in T1_CUTS:
        one = single[arch]
        print(f"T.1 {arch} (fsdp, data {T_DATA} x model {T_MODEL}, batch "
              f"{T_BATCH} x {seq}, float64): one card {one['ms']:.1f} ms "
              f"(cold), peak {one['peak_gib']:.2f} GiB, state "
              f"{one['state_bytes'] / 2**30:.3f} GiB; a rank's step "
              + ", ".join(f"{rk['T.1'][arch]['ms']:.0f}" for rk in ranks)
              + " ms; state " + ", ".join(
                  f"{rk['T.1'][arch]['state_bytes'] / 2**30:.3f}"
                  for rk in ranks) + " GiB, peak " + ", ".join(
                  f"{rk['T.1'][arch]['peak_gib']:.2f}" for rk in ranks)
              + f" GiB a rank; collectives a step (rank 0, calls, bytes) "
              f"{ranks[0]['T.1'][arch]['collectives']}; loss rel "
              + ", ".join(f"{rk['T.1'][arch]['loss_rel']:.3g}" for rk in ranks)
              + f" (gate {gl:g}), gradients rel "
              + ", ".join(f"{rk['T.1'][arch]['grad_rel']:.3g}" for rk in ranks)
              + f" (gate {gg:g}); planted faults " + ", ".join(
                  f"{rk['T.1'][arch]['planted'][1]:.3g}" for rk in ranks)
              + f"; one card nudged {t1_fmt_nudged(one)}; one card's "
              f"gradients hold {one['nonfinite']} non-finite entries",
              flush=True)
    one = single["T.2"]
    print(f"T.2 {T2_ARCH} x {T2_LAYERS} layers (tp_fsdp, data {T2_DATA} x "
          f"model {T2_MODEL}, float64): one card prefill "
          f"{one['prefill_s']:.2f} s, steps " + ", ".join(
              f"{m:.1f}" for m in one["ms"]) + f" ms, caches "
          f"{one['cache_bytes']} B (K/V {one['kv_bytes']} B, k "
          f"{one['kv_shape']}); a rank: prefill " + ", ".join(
              f"{rk['T.2']['prefill_s']:.2f}" for rk in ranks) + " s, steps "
          + "; ".join(", ".join(f"{m:.1f}" for m in rk["T.2"]["ms"])
                      for rk in ranks) + " ms, caches " + ", ".join(
              f"{rk['T.2']['cache_bytes']}" for rk in ranks) + " B (K/V "
          + ", ".join(f"{rk['T.2']['kv_bytes']}" for rk in ranks)
          + f" B, k {ranks[0]['T.2']['kv_shape']}); prefill collectives "
          f"{ranks[0]['T.2']['prefill_collectives']}, a step's "
          f"{ranks[0]['T.2']['step_collectives']}; tokens {one['tokens']}; "
          f"logits rel " + ", ".join(
              f"{max(rk['T.2']['logit_rel']):.3g}" for rk in ranks)
          + f" (gate {T2_LOGIT_RTOL})", flush=True)
    for arch, _, _ in T1_CUTS:
        for n, (lr, gr) in zip(T1_NUDGES, single[arch]["nudged"]):
            check(lr <= gl and gr <= gg, f"T.1 one card {arch}: a nudge of "
                  f"{n:g} moves the loss {lr:.3g} and the gradients "
                  f"{gr:.3g}, past the gates {gl:g}, {gg:g} (or not finite)")
    for r, rk in enumerate(ranks):
        check(all(v == (0, 0) for v in rk["kernels"].values()),
              f"T rank {r} launched a kernel or a plain version: "
              f"{rk['kernels']}")
        for arch, _, _ in T1_CUTS:
            x = rk["T.1"][arch]
            check(x["loss_rel"] <= gl and x["grad_rel"] <= gg,
                  f"T.1 rank {r} {arch}: loss rel {x['loss_rel']:.3g}, "
                  f"gradients rel {x['grad_rel']:.3g} (gates {gl:g}, "
                  f"{gg:g})")
            check(x["planted"][1] > gg, f"T.1 rank {r} {arch}: leaf "
                  f"{x['planted'][0]} halved lies {x['planted'][1]:.3g} "
                  f"from one card's, inside the gate {gg:g}")
        x = rk["T.2"]
        check(x["tokens_equal"] and max(x["logit_rel"]) <= T2_LOGIT_RTOL,
              f"T.2 rank {r}: tokens {x['tokens']} against one card's "
              f"{one['tokens']}, logits rel {max(x['logit_rel']):.3g} "
              f"(gate {T2_LOGIT_RTOL})")
        check(4 * x["kv_bytes"] == one["kv_bytes"] and x["kv_shape"][:4] ==
              one["kv_shape"][:4] and 4 * x["kv_shape"][4] ==
              one["kv_shape"][4], f"T.2 rank {r}: K/V {x['kv_bytes']} B, k "
              f"{x['kv_shape']}, one card's {one['kv_bytes']} B, "
              f"{one['kv_shape']}: not a quarter (head_dim over model)")
    return {"T.1": {arch: {"single": single[arch],
                           "ranks": [rk["T.1"][arch] for rk in ranks]}
                    for arch, _, _ in T1_CUTS},
            "T.2": {"single": {k: v for k, v in one.items()
                               if k != "logits"},
                    "ranks": [rk["T.2"] for rk in ranks]},
            "rank_seconds": [rk["seconds"] for rk in ranks]}


def phase_path_t(card, dev=None):
    """Path T: T.1 every family's fsdp gradients and T.2 a decode over
    head_dim-split caches in four gloo ranks on this card, against one
    card; T.3 the dry run's fsdp and decode cells in this process while
    the ranks run."""
    import shutil
    import tempfile
    import torch
    from repro_torch import kernels
    dev = dev or torch.device("cuda")
    print(card, flush=True)
    torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    rec = {"seconds": {}}
    tmp = Path(tempfile.mkdtemp(prefix="path_t_", dir=OUT))
    try:
        t = time.perf_counter()
        single = t_single(dev, tmp)
        rec["seconds"]["T one card"] = time.perf_counter() - t
        t = time.perf_counter()
        started = start_ranks(T_WORLD, False, "--path-t-rank", tmp)
        try:
            rec["T.3"] = t3_dryrun()
            rec["seconds"]["T.3 (beside the ranks)"] = \
                time.perf_counter() - t
        finally:
            ranks = wait_ranks(started, tmp, T_RANK_TIMEOUT, "T")
        rec["seconds"]["T.1-T.2 ranks"] = time.perf_counter() - t
        rec.update(t_check_ranks(ranks, single))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("path T seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rec["seconds"].items()), flush=True)
    kernels.reset_counts()
    rec["kernels_run"] = {"counts": kernels.counts()}
    return rec


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
    if argv[:1] == ["--path-n-rank"]:
        return path_n_rank(argv[1:])
    if argv[:1] == ["--path-r-rank"]:
        return path_r_rank(argv[1:])
    if argv[:1] == ["--path-s-rank"]:
        return path_s_rank(argv[1:])
    if argv[:1] == ["--path-t-rank"]:
        return path_t_rank(argv[1:])
    # an empty autotune directory: no cache in the checkout changes the
    # decisions the paths report (path O tunes into a directory of its
    # own); the ranks of path N inherit it
    import atexit
    import os
    import shutil
    import tempfile
    OUT.mkdir(exist_ok=True)
    tune_dir = tempfile.mkdtemp(prefix="autotune_", dir=OUT)
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = tune_dir
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

    if "--only=R" in argv:
        # path R alone, with Q.3 (its float32 cut's single-card gradients)
        cut, params = q_cut_model(dev)
        q3 = q_card_vs_cpu(cut, params, dev, {})
        del params
        phase("path R (model parallel)", phase_path_r, card, q3)
        return 0
    if "--only=S" in argv:
        # path S alone: R.3's cell held to PR 26's figures
        phase("path S (gradflow and fsdp over a mesh, dry run)",
              phase_path_s, card)
        return 0
    if "--only=T" in argv:
        phase("path T (every family under fsdp, reference-layout caches)",
              phase_path_t, card)
        return 0
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
    y_main = paths["ensemble_bdf"].pop("y")
    st_main = paths["ensemble_bdf"].pop("stats")
    syncs_main = paths["ensemble_bdf"]["kernels_run"]["loop"]["host_syncs"]
    paths["L: coupled legs"] = phase(
        "path L (coupled legs)", phase_path_l, y_main, syncs_main,
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
                            profiled(path[0]), True, C,
                            keep_y=path[0] == "D")
    # the multi-device layer and the op registry: the main path sharded
    # (a world of one, two ranks on this card), D's solver sharded,
    # MeshVector, a per-op pin
    paths["N: multi-device"] = phase(
        "path N (multi-device, op registry)", phase_path_n, y_main, st_main,
        syncs_main, paths["D: ensemble_bdf SPGMR"].pop("y"), profiled("N"))
    # the analysis layer: the row's constants, the autotuner, the main
    # path under the tuned "auto", kernel-contract on the card
    paths["O: analysis"] = phase(
        "path O (analysis layer)", phase_path_o, card, y_main, st_main,
        syncs_main, paths["ensemble_bdf"]["kernels_run"]["wall_s"])
    del y_main, st_main
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
    # the model stack's serving half: no kernel of the port on its path
    paths["P: model serving"] = phase("path P (model serving)",
                                      phase_path_p, card, profiled("P"))
    # the model stack's training half: rows 16 (AdamW's norm), 12 and 14
    # (gradient flow's ERK)
    paths["Q: model training"] = phase("path Q (model training)",
                                       phase_path_q, card)
    # the model-parallel layer: EP at dbrx-132b's width, the sharded
    # train step and checkpoint in four gloo ranks on this card; row 16
    # (the sharded AdamW norm)
    paths["R: model parallel"] = phase(
        "path R (model parallel)", phase_path_r, card,
        paths["Q: model training"]["Q.3"])
    # gradient flow and the fsdp profile over a mesh (rows 12, 14 on
    # every rank), and the dry run (row 16 on abstract tensors)
    paths["S: mesh gradflow, dry run"] = phase(
        "path S (gradflow and fsdp over a mesh, dry run)", phase_path_s,
        card, paths["R: model parallel"]["R.3"])
    # every family under the fsdp profile and the decode caches in the
    # reference's layout (no kernel of the port on its path)
    paths["T: fsdp families, reference caches"] = phase(
        "path T (every family under fsdp, reference-layout caches)",
        phase_path_t, card)
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
