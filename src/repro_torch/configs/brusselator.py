"""The paper's demonstration problem config (§7): the 1D
advection-reaction Brusselator.  The port's own copy of
``repro.configs.brusselator.BrusselatorConfig``, field for field."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BrusselatorConfig:
    name: str = "brusselator1d"
    nx: int = 512            # mesh points (paper: up to 1.536e8)
    c: float = 0.01          # advection speed
    A: float = 1.0
    B: float = 3.5
    eps: float = 5e-6        # stiffness parameter
    b_domain: float = 10.0   # domain size (paper b in {10..2560})
    t_final: float = 10.0
    alpha: float = 0.1       # initial-bump amplitude
    rtol: float = 1e-6
    atol: float = 1e-9
    solver: str = "task-local"   # 'task-local' | 'global'


DEFAULT = BrusselatorConfig()
