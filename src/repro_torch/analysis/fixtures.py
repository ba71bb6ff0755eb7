"""Deliberately bad inputs for sunlint's rules (negative controls).

``FIXTURES`` maps a fixture's name to ``(expected_rule, setup)``, where
``setup(ctx)`` changes one field of a
:class:`~repro_torch.analysis.lint.LintContext` so that the rule's
invariant breaks.  ``python -m repro_torch.analysis.lint --fixture
<name>`` seeds one (expected exit status 1), and the port's tests assert
that each rule fires on its own.  A rule that stops flagging its
fixture has gone blind.
"""
import dataclasses

from .hotloop import HotLoopTarget
from .lint import LoopSource
from .opcost import OpSig


# --- table-coherence -------------------------------------------------------
# An op in the table with no signature extractor, no cost model and no
# note: the half-wired op the rule exists to catch.

def _setup_orphan_op(ctx):
    def frob(x):
        return x

    table = dict(ctx.op_table)
    table["frobnicate_soa"] = {"torch": frob, "cuda": frob}
    ctx.op_table = table


# --- kernel-contract -------------------------------------------------------
# (a) a signature whose inputs cannot give it back: a block op whose
# state length differs from its block size.

def _setup_mis_keyed_sig(ctx):
    sigs = dict(ctx.contract_sigs)
    sigs["block_solve_soa"] = sigs["block_solve_soa"] + [
        OpSig("block_solve_soa", "float64", n=4, nsys=8, b=3)]
    ctx.contract_sigs = sigs


# (c) a card whose blocks may hold 16 KiB of shared memory: the warp
# Gauss-Jordan tile of b = 32 float64 systems takes 35008 B.

def _setup_oversize_smem(ctx):
    ctx.device = dataclasses.replace(ctx.device, name="small_smem",
                                     smem_optin_bytes=16 * 1024)


# --- bounded-loops ---------------------------------------------------------
# Step loops held only by floats or by an equality: "iterate until the
# residual is small" never ends once it is NaN, and a counter tested
# for equality can step over its mark.

UNBOUNDED_LOOPS = '''\
def newton(z, tol, opts):
    while abs(z - 2.0) > tol:
        z = z * 0.5 + 1.0
    it = 0
    while it != opts.max_iters:
        it += 2
    t = 0.0
    while True:
        if not t < opts.tf:
            break
        t = t + opts.h
    return z
'''


def _setup_unbounded_loops(ctx):
    ctx.loop_sources = [LoopSource("fixture:unbounded_loops",
                                   ctx.repo_root / "unbounded_loops.py",
                                   UNBOUNDED_LOOPS)]


# --- hot-loop-layout / dtype-drift ------------------------------------------
# The main path's problem with a right-hand side the Newton trips must
# convert: given only in the AoS layout (the integrator's boundary
# transposes then run at every evaluation), or computed in float32 on
# the float64 state.

def _robertson(kind: str, nsys: int = 8):
    import torch

    from ..core import ivp, problems
    from ..core.arkode import ODEOptions
    from ..core.policies import ExecPolicy

    rates = problems.robertson_rates(nsys, seed=0)
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates, device="cpu")
    fs, js = problems.batched_robertson_soa(nsys, rates=rates, device="cpu")
    if kind == "aos":
        prob = ivp.IVP(f=f, jac=jac, y0=y0)
    else:
        prob = ivp.IVP(f=f, jac=jac, y0=y0, jac_soa=js,
                       f_soa=lambda t, y: fs(t, y.to(torch.float32)).to(
                           y.dtype))
    opts = ODEOptions(rtol=1e-5, atol=1e-10, max_steps=3,
                      policy=ExecPolicy(device="cpu"))
    return prob, opts


def _rhs_targets(kind):
    def run(method):
        prob, opts = _robertson(kind)
        from ..core import ivp
        return ivp.integrate(prob, 0.0, 10.0, method, opts=opts)

    return [HotLoopTarget(f"fixture:{kind}_rhs:{m}",
                          lambda m=m: run(m))
            for m in ("ensemble_bdf", "ensemble_dirk")]


def _setup_aos_rhs(ctx):
    ctx.hot_loop_targets = _rhs_targets("aos")


def _setup_f32_rhs(ctx):
    ctx.hot_loop_targets = _rhs_targets("f32")


FIXTURES = {
    "orphan_op": ("table-coherence", _setup_orphan_op),
    "mis_keyed_sig": ("kernel-contract", _setup_mis_keyed_sig),
    "oversize_smem": ("kernel-contract", _setup_oversize_smem),
    "unbounded_loops": ("bounded-loops", _setup_unbounded_loops),
    "aos_rhs": ("hot-loop-layout", _setup_aos_rhs),
    "f32_rhs": ("dtype-drift", _setup_f32_rhs),
}
