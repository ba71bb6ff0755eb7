"""One run of one cell: set-up, the measured window, the trace.

Set-up imports the port, builds its kernels (``nvcc``, once a
checkout), makes every input on the device from the seed, builds the
program's problem and runs the first two calls of a solve (the cold
start and a resumed call) at the cell's shapes.  The window then runs
whole solves back to back through ``repro_torch.core.ivp.integrate``
(``traffic.py``) until ``seconds`` have passed; the solve that crosses
that time is finished and counted.  With ``trace``, whole solves from
the window's first on are profiled with the device's activity alone
until ``TRACE_SECONDS`` of them have run, then the next solve's first
call with the host's operations too, to label the device's idle gaps;
the window runs on until both are done.  After each call the answers of
the checked lanes are kept for the comparison with the reference, which
runs after the window (``check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import zlib
from collections import Counter
from typing import Optional

import numpy as np

from . import traffic
from .trace import CALL_SPAN
from .manifest import Manifest

#: a traced run profiles whole solves from the window's first
#: until they have taken this many host seconds
TRACE_SECONDS = 1.0


def _profilers(dev) -> dict:
    """The traced run's two profiles: "device" records the card's
    activity alone (kernels, copies, the runtime's calls), which costs
    the host little, for the device time, the idle share and the
    roofline; "host" records the host's operations too, which stretches
    the host's time several-fold, only to label the idle gaps."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    device = ProfilerActivity.CUDA if dev.type == "cuda" \
        else ProfilerActivity.CPU
    return {"device": profile(activities=[device]),
            "host": profile(activities=sorted(
                {ProfilerActivity.CPU, device}, key=str))}


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for one purpose, from the run's seed and ``keys``."""
    words = [seed % 2 ** 64 >> 32, seed % 2 ** 32]
    words += [zlib.crc32(str(k).encode()) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class Run:
    """What the metric readers and the check read."""

    cell: dict
    cfg: dict
    mix: dict
    limits: dict
    device: object
    dtype: object
    setup_s: float = 0.0
    #: set-up's seconds by part, in order
    setup_parts: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    calls: int = 0
    #: whole solves in the window (every call of each)
    solves: int = 0
    nsys: int = 0
    peak_bytes: int = 0
    counters: Counter = dataclasses.field(default_factory=Counter)
    call_s: list = dataclasses.field(default_factory=list)
    #: with ``--trace 1``: ``{"device": profile, "host": profile}``,
    #: then what ``trace.py`` reduced them to
    trace: Optional[object] = None
    #: the device stage's calls (whole solves): their count, their
    #: loop counts, their (start, end) in us on the host's clock
    traced_calls: int = 0
    traced_counters: Counter = dataclasses.field(default_factory=Counter)
    traced_spans: list = dataclasses.field(default_factory=list)
    #: the host stage's call, (start, end) in us on the host's clock
    host_span: Optional[tuple] = None
    #: per call: (Call, checked lanes' y (rows), success tensor)
    answers: list = dataclasses.field(default_factory=list)
    #: the checked lanes and their float64 inputs
    checked: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.checked["y0"].shape[1]


def _checked_lanes(nsys, count, gen_seed, device):
    """``count`` lanes of ``nsys``, drawn from the seed."""
    import torch
    rng = np.random.default_rng(gen_seed)
    lanes = rng.choice(nsys, size=min(count, nsys), replace=False)
    return torch.tensor(sorted(lanes.tolist()), dtype=torch.long,
                        device=device)


def run(manifest: Manifest, cell_name: str, seed: int, seconds: float,
        trace: bool, t_proc: float, device: str = "cuda", dtype=None,
        nsys: Optional[int] = None, fault=None) -> Run:
    """Set up and run one cell's window.

    t_proc : ``time.perf_counter()``'s reading at process start.
    dtype, nsys : the control's precision and a test's size (None: the
        configuration's and the mix's).
    fault : a function ``(call, y_in, y) -> y`` applied to each call's
        answer ``y`` from its start ``y_in`` (the harness's own tests
        plant faults with it).
    """
    import torch
    # one process, one host thread of PyTorch's own: the port's host loop
    # is the only CPU work, and idle pool threads only add noise
    torch.set_num_threads(1)
    cell = manifest.cell(cell_name)
    cfg = manifest.config(cell["config"])
    limits = manifest.limits(cell_name)
    mix = manifest.traffic(cell["traffic"])
    family = manifest.family(cfg["family"])
    dev = torch.device(device)
    dtype = dtype or getattr(torch, cfg["dtype"])
    r = Run(cell=cell, cfg=cfg, mix=mix, limits=limits, device=dev,
            dtype=dtype, nsys=nsys or mix["nsys"])

    marks = [("interpreter and torch", time.perf_counter())]
    from repro_torch.core import context, ivp, linsol, loops
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    marks.append(("port import", time.perf_counter()))
    if dev.type == "cuda":
        torch.empty(0, device=dev)
        marks.append(("CUDA context", time.perf_counter()))
        from repro_torch.kernels import _build
        _build.build_all()
        for lib in _build.SOURCES:
            _build.load(lib)
        marks.append(("kernels built and loaded", time.perf_counter()))
    # one set of inputs, made from the seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(derive(seed, "inputs"))
    inputs = family.draw(cfg, r.nsys, gen, dev)
    lanes = _checked_lanes(r.nsys, mix["checked_lanes"],
                           derive(seed, "lanes"), dev)
    r.checked = {"lanes": lanes, "y0": inputs["y0"][lanes].cpu(),
                 "params": {k: v[lanes].cpu() for k, v in
                            inputs["params"].items()}}
    prob = family.program_ivp(cfg, {
        "params": {k: v.to(dtype) for k, v in inputs["params"].items()},
        "y0": inputs["y0"].to(dtype)})
    del inputs
    marks.append(("inputs and problem", time.perf_counter()))
    solver_kw = dict(cfg["linear_solver"])
    solver = getattr(linsol, solver_kw.pop("name"))(**solver_kw)
    # the port's default policy on the card; its plain versions on the CPU
    policy = ExecPolicy() if dev.type == "cuda" else ExecPolicy(device=dev)
    atol = cfg["atol"]
    if isinstance(atol, list):
        # one absolute tolerance a component: (n, 1) against the loop's
        # (n, nsys) states
        atol = torch.tensor(atol, dtype=dtype, device=dev)[:, None]
    opts = ODEOptions(rtol=cfg["rtol"], atol=atol,
                      max_steps=cfg["max_steps"], policy=policy)
    ctx = context.Context(policy=opts.policy)

    def call_once(call, sess):
        """``(y, success, session)`` of one call: a solve's first call
        from ``y0``, a later one from the session ``sess``."""
        sol = ivp.integrate(prob, call.t0, call.t1, cfg["method"], ctx=ctx,
                            opts=opts, lin_solver=solver,
                            order=cfg["order"], device=dev,
                            session=None if call.cold else sess,
                            return_session=True)
        return sol.y, sol.success, sol.session

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the cell's shapes: a solve's cold first call and a resumed one
    sess = None
    for call, _ in zip(traffic.calls(cfg), range(2)):
        y, _, sess = call_once(call, sess)
    del y, sess
    sync()
    # what set-up made lives to the end: keep the collector off it
    gc.collect()
    gc.freeze()
    r.setup_s = time.perf_counter() - t_proc
    marks.append(("two calls at the cell's shapes", t_proc + r.setup_s))
    last = t_proc
    for name, t in marks:
        r.setup_parts[name] = t - last
        last = t

    profs = _profilers(dev) if trace else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # a traced run goes through stages: "device" (whole solves, device
    # activity only), "wait" (for the next solve's first call), "host"
    # (that call, host ops too), "done"; an untraced run is done at once
    stage = "done"
    if trace:
        # the profiler's own start-up is set-up's, not a call's
        profs["device"].start()
        stage = "device"
    profiled_s = 0.0
    sess = y = None
    t_start = time.perf_counter()
    for call in traffic.calls(cfg):
        if stage == "wait" and call.cold:
            profs["host"].start()
            stage = "host"
        y_in = prob.y0 if call.cold else y
        t_call = time.perf_counter()
        ns_call = time.time_ns()
        loops.reset_loop_counts()
        if stage == "host":
            with torch.profiler.record_function(CALL_SPAN):
                y, ok, sess = call_once(call, sess)
                sync()
        else:
            y, ok, sess = call_once(call, sess)
            sync()
        ns_end = time.time_ns()
        now = time.perf_counter()
        if fault is not None:
            y = fault(call, y_in, y)
        del y_in
        r.call_s.append(now - t_call)
        r.counters.update(loops.loop_counts)
        r.calls += 1
        r.solves += call.last
        r.answers.append((call, y.index_select(0, lanes), ok))
        if stage == "device":
            r.traced_calls += 1
            r.traced_counters.update(loops.loop_counts)
            r.traced_spans.append((ns_call / 1e3, ns_end / 1e3))
            profiled_s += now - t_call
            if call.last and profiled_s >= TRACE_SECONDS:
                profs["device"].stop()
                stage = "wait"
        elif stage == "host":
            r.host_span = (ns_call / 1e3, ns_end / 1e3)
            profs["host"].stop()
            stage = "done"
        if call.last and now - t_start >= seconds and stage == "done":
            break
    r.window_s = now - t_start
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)
    del prob, y, sess, ctx
    if profs is not None:
        r.trace = profs
    return r
