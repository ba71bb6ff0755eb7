"""Integrator options (counterpart of ``repro.core.arkode.ODEOptions``).

Only the options record is ported so far; the ARKODE integrators wait
for ROADMAP queue A item 7.
"""
from __future__ import annotations

import math
from typing import NamedTuple

from .controller import ControllerConfig
from .policies import DEFAULT, ExecPolicy


class ODEOptions(NamedTuple):
    rtol: float = 1e-6
    atol: float = 1e-9
    h0: float = 0.0             # 0 -> auto
    hmin: float = 0.0
    hmax: float = math.inf
    max_steps: int = 100_000
    newton_max: int = 4
    newton_tol_fac: float = 0.1   # Newton tol = fac * (error-test tol 1.0)
    controller: ControllerConfig = ControllerConfig()
    eta_cf: float = 0.25          # h reduction after a Newton failure
    policy: ExecPolicy = DEFAULT  # kernel or plain version per op
