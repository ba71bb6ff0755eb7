"""Whether the window's answers are right: the comparison with the
plain reference.

After the window the plain reference (``reference/seulex.py``, with the
family's plain right-hand side and Jacobian) integrates the checked
lanes from their float64 inputs, at the configuration's ``reference``
tolerances, through a solve's output times (lanes with the same inputs
are integrated once).  Each answer a call of the window produced at
those lanes is held to it.

The numbers (each compared with its limit in the cell's ``limits``;
``calls_failed`` always, with the limit 0):

* ``calls_failed``: calls that report a lane that did not succeed;
* ``err_max``: the largest ``|y - y_ref| / (rtol |y_ref| + atol)`` over
  every checked lane, component and call: the global error in units of
  the tolerance the configuration asks for (``atol`` one a component
  or one for all; a NaN counts as infinite);
* ``err_gmean``: the geometric mean, over checked lanes and calls, of a
  lane's root mean square of that ratio over its components;
* for each quantity the family's exact solution conserves
  (``conserved``), such as a mass: ``<name>_drift``, its largest change
  from the start over lanes and calls, and ``<name>_change_late``, its
  largest change over one call among the later half of a solve's calls,
  where the solution has relaxed and the integrator's own error no
  longer moves it, so what is left is the rounding of the state.
"""
from __future__ import annotations

import math
import time

from ..reference import seulex
from . import traffic


def numbers(run, family) -> dict:
    """Run the reference and compare; ``{name: value}``."""
    import torch
    cfg, dev = run.cfg, run.device
    t_outs = traffic.outputs(cfg)
    y0 = run.checked["y0"]
    names = sorted(run.checked["params"])
    # lanes with the same inputs have the same reference answer
    rows = torch.cat([y0] + [run.checked["params"][k][:, None]
                             for k in names], dim=1)
    uniq, inverse = torch.unique(rows, dim=0, return_inverse=True)
    n = y0.shape[1]
    params = {k: uniq[:, n + i].to(dev) for i, k in enumerate(names)}
    ref_cfg = cfg["reference"]
    t0 = time.perf_counter()
    ref = seulex.integrate(
        lambda t, y, p: family.rhs(t, y, p, cfg),
        lambda t, y, p: family.jac(t, y, p, cfg), uniq[:, :n].to(dev),
        params, t_outs, rtol=ref_cfg["rtol"],
        atol=torch.as_tensor(ref_cfg["atol"], dtype=torch.float64,
                             device=dev))
    ref = ref[:, inverse.to(dev)]
    took = time.perf_counter() - t0
    atol = torch.as_tensor(cfg["atol"], dtype=torch.float64, device=dev)
    err_max, log_sum, count, failed = 0.0, 0.0, 0, 0
    inv = {}
    late = len(t_outs) // 2
    start = {k: v.to(dev) for k, v in family.conserved(y0).items()}
    prev = None
    for call, y, ok in run.answers:
        k = t_outs.index(call.t1)
        yr = ref[k]
        y = y.to(torch.float64)
        ratio = (y - yr).abs() / (cfg["rtol"] * yr.abs() + atol)
        ratio = torch.nan_to_num(ratio, nan=math.inf)
        err_max = max(err_max, float(ratio.max()))
        lane = ratio.square().mean(dim=1).sqrt()
        log_sum += float(lane.clamp(min=1e-300).log().sum())
        count += lane.numel()
        failed += 0 if bool(ok) else 1
        now = family.conserved(y)
        for name, c in now.items():
            _worst(inv, f"{name}_drift", (c - start[name]).abs())
            if k >= late and not call.cold:
                _worst(inv, f"{name}_change_late", (c - prev[name]).abs())
        prev = now
    out = {"calls_failed": failed, "err_max": err_max,
           "err_gmean": math.exp(log_sum / count)}
    out.update(inv)
    out["reference_s"] = took
    return out


def _worst(out: dict, key: str, values) -> None:
    """``out[key]``: the largest of ``values`` seen so far (NaN counts as
    infinite)."""
    import torch
    v = float(torch.nan_to_num(values, nan=math.inf).max())
    out[key] = max(out.get(key, v), v)


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limited number at or under its limit;
    ``checks`` maps each to ``{"value", "limit"}``."""
    limits = {"calls_failed": 0, **limits}
    checks = {k: {"value": values[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
