#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--ptxas]

Run from the repository root.  It imports nothing of JAX or of the JAX
package.  Phases, each of which fails the run (non-zero exit):

1. device: prints the card's name and power limit (``nvidia-smi``);
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
   (one process per source, all at once) unless already built;
3. kernels: each of the six CUDA kernels of the ensemble-BDF path
   against its plain PyTorch version on the card, at the main-path shape
   (2**20 systems, n = b = 3) and at ragged batches, in float64 and
   float32; the block inverse also at b = 8, 16 and on stiff Robertson
   Newton blocks.  Then each kernel, its plain version and, where one
   exists, a single PyTorch library call computing the same function are
   timed with CUDA events (median of 25, L2 flushed before each run);
4. reference: 256 lanes of the classic Robertson problem through
   ``integrate`` must match scipy's Radau IIA (rtol 1e-12) at t = 10
   within 10*(rtol*|y|+atol);
   main path: ``integrate(IVP(...), 0, 10, "ensemble_bdf")`` over 2**20
   batched Robertson systems (rates from numpy seed 0), float64, default
   policy and ``BlockDiagGJ()``: every lane must succeed and every kernel
   must have launched with no plain version running; then the same run
   with ``ExecPolicy(backend="torch")`` must agree (retcodes equal, y
   within 10*(rtol*|y|+atol)), and both conserve y1+y2+y3 = 1;
5. prints the ``{"kernels": [...]}`` line; 6. prints the ``ok`` line.

``--profile`` adds a third, profiled main-path run and writes the
busiest device kernels to ``chip_smoke_out/chip_smoke_profile.txt``;
``--ptxas`` prints what ``nvcc -Xptxas -v`` reports for each kernel
(registers, spills) when it builds.  The full record goes to
``chip_smoke_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"
NSYS = 1 << 20
RTOL, ATOL = 1e-5, 1e-10
# H100 SXM, NVIDIA data sheet: HBM3 bandwidth; float64 and float32
# non-tensor-core peaks (the kernels use no tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float64": 34e12, "torch.float32": 67e12}
TOL = {"torch.float64": 1e-10, "torch.float32": 1e-4}
#: the __global__ functions of kernels/csrc, as the profiler names them
KERNEL_SYMBOLS = ("newton_residual_kernel", "masked_update_wrms_kernel",
                  "history_rescale_kernel", "wrms_soa_kernel",
                  "spmv_fixed_kernel", "spmv_any_kernel",
                  "gj_inverse_unrolled_kernel", "gj_inverse_inplace_kernel")


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Kernel:
    """One kernel of the path: how to call it, its plain version, an
    optional library yardstick, and its least time on the card."""

    def __init__(self, name, wrapper, plain, replaces, source, args, kw,
                 flops, library=None, skipped_bytes=lambda d: 0):
        self.name, self.wrapper, self.plain = name, wrapper, plain
        self.replaces, self.source = replaces, source
        self.args, self.kw, self.flops, self.library = args, kw, flops, library
        # input bytes that this data does not need read (the bound counts
        # what the run's data needs)
        self.skipped_bytes = skipped_bytes
        self.max_err = 0.0

    def compare(self, d, what):
        import torch
        args = self.args(d)
        got = self.wrapper(*args, **self.kw)
        want = self.plain(*args, **self.kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
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


def make_inputs(nb, dtype, gen, dev, b=3):
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    return {"z": r(3, nb), "f": r(3, nb), "psi": r(3, nb),
            "gam": r(nb).abs(), "w": r(3, nb).abs() + 0.1,
            "mask": torch.rand(nb, generator=gen, device=dev) > 0.4,
            "W": r(6, 6, nb), "Z": r(6, 3, nb),
            "A": r(b, b, nb) + b * torch.eye(b, device=dev,
                                              dtype=dtype)[:, :, None]}


def kernel_table():
    import torch
    from repro_torch.kernels import block_solve, blockdiag_spmv, newton

    def b_of(d):
        return d["A"].shape[0]

    def inv_flops(d):
        b, nb = b_of(d), d["A"].shape[2]
        return nb * (b + 2 * b * b + b * (1 + 2 * b + 4 * b * (b - 1)))

    csrc = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    return [
        Kernel("newton_residual", newton.newton_residual,
               newton.newton_residual_plain, ref + "newton.py:40",
               csrc + "newton.cu",
               lambda d: (d["z"], d["f"], d["psi"], d["gam"]),
               {"negate": True}, lambda d: 3 * d["z"].numel()),
        Kernel("blockdiag_spmv", blockdiag_spmv.blockdiag_spmv_soa,
               blockdiag_spmv.blockdiag_spmv_soa_plain,
               ref + "blockdiag_spmv.py:20", csrc + "blockdiag_spmv.cu",
               lambda d: (d["A"], d["z"]), {},
               lambda d: (2 * b_of(d) - 1) * b_of(d) * d["A"].shape[2],
               library=lambda d: torch.einsum("ijs,js->is", d["A"], d["z"])),
        Kernel("masked_update_wrms", newton.masked_update_wrms,
               newton.masked_update_wrms_plain, ref + "newton.py:73",
               csrc + "newton.cu",
               lambda d: (d["z"], d["f"], d["w"], d["mask"]), {},
               lambda d: 3 * d["z"].numel() + 3 * int(d["mask"].sum())
               + 2 * d["mask"].numel()),
        Kernel("history_rescale", newton.history_rescale,
               newton.history_rescale_plain, ref + "newton.py:119",
               csrc + "newton.cu", lambda d: (d["W"], d["Z"], d["mask"]), {},
               lambda d: 11 * 6 * 3 * int(d["mask"].sum()),
               library=lambda d: torch.where(d["mask"], torch.einsum(
                   "jis,iks->jks", d["W"], d["Z"]), d["Z"]),
               # an inactive system copies Z and needs none of its W
               skipped_bytes=lambda d: 36 * d["W"].element_size()
               * int((~d["mask"]).sum())),
        Kernel("wrms_soa", newton.wrms_soa, newton.wrms_soa_plain,
               ref + "newton.py:167", csrc + "newton.cu",
               lambda d: (d["z"], d["w"]), {},
               lambda d: 3 * d["z"].numel() + 2 * d["z"].shape[1],
               library=lambda d: torch.linalg.vector_norm(d["z"] * d["w"],
                                                          dim=0)),
        Kernel("block_inverse", block_solve.block_inverse_soa,
               block_solve.block_inverse_soa_plain, ref + "block_solve.py:92",
               csrc + "block_solve.cu", lambda d: (d["A"],), {}, inv_flops,
               library=lambda d: torch.linalg.inv(d["A"].permute(2, 0, 1))),
    ]


def time_ms(fn, flush, reps=25):
    """Median device time of one call, CUDA events, L2 flushed before
    each run (the main path streams far more than the 50 MB L2)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_kernels(table, dev):
    import torch
    from repro_torch.kernels import block_solve, newton
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        for nb in (NSYS, 7, 130, 516):
            d = make_inputs(nb, dtype, gen, dev)
            for k in table:
                k.compare(d, f"nb={nb} {dtype}")
            out = newton.history_rescale(d["W"], d["Z"], d["mask"])
            off = ~d["mask"]
            check(torch.equal(out[:, :, off], d["Z"][:, :, off]),
                  f"history_rescale nb={nb}: inactive lanes not bit-exact")
            none = torch.zeros_like(d["mask"])
            check(torch.equal(newton.history_rescale(d["W"], d["Z"], none),
                              d["Z"]), "history_rescale: all-inactive copy")
    inverse = table[-1]
    for b in (8, 16):
        for nb in (516, 1 << 16):
            inverse.compare(make_inputs(nb, torch.float64, gen, dev, b=b),
                            f"b={b} nb={nb}")
    stiff = {"A": robertson_newton_blocks(NSYS, gen, dev, torch.float64)}
    inverse.compare(stiff, "Robertson Newton blocks")
    Minv = block_solve.block_inverse_soa(stiff["A"])
    eye = torch.einsum("ijs,jks->iks", stiff["A"], Minv)
    resid = (eye - torch.eye(3, device=dev, dtype=eye.dtype)[:, :, None])
    check(resid.abs().max().item() < 1e-8,
          f"M @ inv(M) - I reaches {resid.abs().max().item()}")
    print(f"kernels: all six agree with their plain versions "
          f"(float64 tol 1e-10, float32 1e-4, relative to max(1,|plain|))",
          flush=True)

    # timings at the main-path shape, float64
    d = make_inputs(NSYS, torch.float64, gen, dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows = []
    for k in table:
        args = k.args(d)
        out = k.wrapper(*args, **k.kw)
        out = out if isinstance(out, tuple) else (out,)
        moved = nbytes(*args, *out) - k.skipped_bytes(d)
        flops = k.flops(d)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(torch.float64)] * 1e3
        row = {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "ms": time_ms(lambda: k.wrapper(*args, **k.kw), flush),
            "plain_ms": time_ms(lambda: k.plain(*args, **k.kw), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (time_ms(lambda: k.library(d), flush)
                           if k.library is not None else None),
            "bytes": moved, "flops": flops,
        }
        rows.append(row)
        print(f"  {k.name:20s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  library {row['library_ms']}",
              flush=True)
    # the step's second rescale finds (nearly) every system active: no
    # divergent warps, and every W is read
    every = torch.ones_like(d["mask"])
    rescale = rows[[k.name for k in table].index("history_rescale")]
    rescale["ms_all_active"] = time_ms(
        lambda: newton.history_rescale(d["W"], d["Z"], every), flush)
    rescale["library_ms_all_active"] = time_ms(
        lambda: torch.einsum("jis,iks->jks", d["W"], d["Z"]), flush)
    rescale["bound_ms_all_active"] = nbytes(d["W"], d["Z"], every, d["Z"]) \
        / HBM_BYTES_PER_S * 1e3
    print(f"  history_rescale, all systems active: kernel "
          f"{rescale['ms_all_active']:.4f} ms  bound "
          f"{rescale['bound_ms_all_active']:.4f} ms  library (einsum) "
          f"{rescale['library_ms_all_active']:.4f} ms", flush=True)
    del d, flush
    return rows


def phase_reference():
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
    sol = ivp.integrate(ivp.IVP(f=fr, jac=jr, y0=y0), 0.0, 10.0,
                        "ensemble_bdf", opts=ODEOptions(rtol=RTOL, atol=ATOL))
    check(bool(sol.ok.all()), "reference problem: a lane failed")
    y = sol.y.cpu().numpy()
    ratio = float((np.abs(y - ref) / (10 * (RTOL * np.abs(ref) + ATOL))).max())
    check(ratio <= 1.0, f"reference problem: y(10) differs from Radau by "
          f"{ratio} of 10*(rtol*|y|+atol)")
    print(f"reference problem: y(10) = {y[0].tolist()}, Radau "
          f"{ref.tolist()}, max |dy|/(10*(rtol*|y|+atol)) {ratio:.3g}",
          flush=True)
    return {"radau_y10": ref.tolist(), "port_y10": y[0].tolist(),
            "max_diff_over_bound": ratio}


def phase_main_path(dev, profile):
    import torch
    from repro_torch import kernels
    from repro_torch.core import batched, ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.context import Context
    from repro_torch.core.policies import ExecPolicy

    rates = problems.robertson_rates(NSYS, seed=0)
    f, jac, y0 = problems.batched_robertson(NSYS, rates=rates)
    f_soa, jac_soa = problems.batched_robertson_soa(NSYS, rates=rates)
    prob = ivp.IVP(f=f, jac=jac, y0=y0, f_soa=f_soa, jac_soa=jac_soa)
    opts = ODEOptions(rtol=RTOL, atol=ATOL, max_steps=100_000)

    def run(o, label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        batched.reset_loop_counts()
        t0 = time.perf_counter()
        sol = ivp.integrate(prob, 0.0, 10.0, "ensemble_bdf", ctx=Context(),
                            opts=o)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sol.stats
        rec = {"wall_s": wall, "counts": kernels.counts(),
               "loop": dict(batched.loop_counts),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "lanes_ok": int(sol.ok.sum())}
        for k in ("steps", "nni", "nsetups", "netf"):
            v = getattr(st, k)
            rec[k] = {"sum": int(v.sum()), "max": int(v.max())}
        print(f"main path [{label}]: wall {wall:.3f} s, host syncs "
              f"{rec['loop']['host_syncs']}, step trips "
              f"{rec['loop']['step_trips']}, Newton trips "
              f"{rec['loop']['newton_trips']}, lanes ok {rec['lanes_ok']}/"
              f"{NSYS}, peak {rec['peak_bytes'] / 2**20:.1f} MiB, "
              + ", ".join(f"{k} sum {rec[k]['sum']} max {rec[k]['max']}"
                          for k in ("steps", "nni", "nsetups", "netf")),
              flush=True)
        return sol, rec

    sol, rec = run(opts, "kernels")
    check(bool(sol.ok.all()), f"{NSYS - rec['lanes_ok']} lanes failed")
    for name, (launches, plain_calls) in rec["counts"].items():
        check(launches > 0, f"kernel {name} was never launched")
        check(plain_calls == 0, f"plain {name} ran {plain_calls} times")
    y = sol.y
    check(y.shape == (NSYS, 3) and bool(torch.isfinite(y).all()),
          "non-finite or misshapen y")
    ref, ref_rec = run(opts._replace(policy=ExecPolicy(backend="torch")),
                       "plain versions")
    check(all(v[0] == 0 for v in ref_rec["counts"].values()),
          "the torch-backend run launched a kernel")
    check(torch.equal(sol.retcodes, ref.retcodes), "retcodes differ")
    bound = 10 * (RTOL * ref.y.abs() + ATOL)
    diff = (y - ref.y).abs()
    check(bool((diff <= bound).all()),
          f"y differs from the plain run by {(diff / bound).max().item()} "
          "of 10*(rtol*|y|+atol)")
    mass = (y.sum(dim=1) - 1.0).abs().max().item()
    check(mass <= 10 * RTOL, f"y1+y2+y3 drifts from 1 by {mass}")
    agree = {"max_diff_over_bound": (diff / bound).max().item(),
             "mass_drift": mass}
    print(f"main path agrees with the plain run: max |dy|/bound "
          f"{agree['max_diff_over_bound']:.3g}, mass drift {mass:.3g}",
          flush=True)
    prof = None
    if profile:
        prof = profile_run(prob, opts, rec["wall_s"])
    return {"kernels_run": rec, "plain_run": ref_rec, "agreement": agree,
            "profile": prof}


def profile_run(prob, opts, plain_wall):
    """A third main-path run under torch.profiler: device time by kernel
    name, the device time under the ``lagrange_matrix_soa`` range, and the
    device's busy share both of the profiled wall time and of
    ``plain_wall``, the same solve's wall time without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cvode, ivp
    from repro_torch.core.context import Context
    lagrange = "lagrange_matrix_soa"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        ivp.integrate(prob, 0.0, 10.0, "ensemble_bdf", ctx=Context(),
                      opts=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, lagrange_us, lagrange_calls = {}, 0.0, 0
    for e in p.events():
        if e.device_type == DeviceType.CUDA and e.name != lagrange:
            # (the range's own device-side span is not a kernel)
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CPU and e.name == lagrange:
            # kernels launched inside the range, children included
            lagrange_us += getattr(e, "device_time_total", None) \
                or e.cuda_time_total
            lagrange_calls += 1
    check(lagrange_calls > 0 and lagrange_us > 0,
          f"the trace holds no device time under {lagrange}")
    dev_us = sum(by_name.values())
    ours_us = sum(v for name, v in by_name.items()
                  if any(sym in name for sym in KERNEL_SYMBOLS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_profile.txt").write_text(
        "\n".join(f"{us / 1e3:12.3f} ms  {name}" for name, us in top) + "\n")
    # the plain tensor code that builds history_rescale's W, twice a step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    eta = 0.1 + 9.9 * torch.rand(NSYS, generator=gen, device="cuda",
                                 dtype=torch.float64)
    q = torch.full((NSYS,), cvode.QMAX, dtype=torch.int32, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    lagrange_ms = time_ms(lambda: cvode.lagrange_matrix_soa(eta, q), flush)
    print(f"profiled run: wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} "
          f"s ({100 * dev_us / 1e6 / wall:.1f} % of the profiled wall, "
          f"{100 * dev_us / 1e6 / plain_wall:.1f} % of the unprofiled "
          f"{plain_wall:.3f} s), of which the port's kernels "
          f"{ours_us / 1e6:.3f} s and {lagrange} {lagrange_us / 1e6:.3f} s "
          f"in {lagrange_calls} calls (trace); {len(by_name)} kernel names; "
          f"{lagrange} alone {lagrange_ms:.4f} ms a call", flush=True)
    return {"wall_s": wall, "unprofiled_wall_s": plain_wall,
            "device_busy_s": dev_us / 1e6, "port_kernels_s": ours_us / 1e6,
            "lagrange_trace_s": lagrange_us / 1e6,
            "lagrange_calls": lagrange_calls, "lagrange_ms": lagrange_ms,
            "top_ms": {name: us / 1e3 for name, us in top}}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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
    # 3. kernels against their plain versions, then timings
    table = kernel_table()
    rows = phase_kernels(table, dev)
    # 4. a small input against an independent reference, then the main path
    ref_rec = phase_reference()
    main_rec = phase_main_path(dev, "--profile" in argv)
    launches = main_rec["kernels_run"]["counts"]
    # 5. kernels line
    line = []
    for k, row in zip(table, rows):
        line.append({"name": k.name, "route": row["route"],
                     "source": row["source"], "replaces": row["replaces"],
                     "launches": launches[k.name][0],
                     "max_abs_err": k.max_err, "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "timings": rows, "reference": ref_rec, "main_path": main_rec},
        indent=1))
    print(json.dumps({"kernels": line}), flush=True)
    # 6. ok line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
