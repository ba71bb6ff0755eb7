"""Step-size controllers (SUNAdaptController analogs).

Counterpart of ``repro.core.controller``: the I, PI and PID controllers
with ARKODE's default constants, on tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ControllerState(NamedTuple):
    err_prev: torch.Tensor      # eps_{n-1}
    err_prev2: torch.Tensor     # eps_{n-2}


class ControllerConfig(NamedTuple):
    kind: str = "pi"           # 'i' | 'pi' | 'pid'
    safety: float = 0.96       # ARKODE default
    eta_max_first: float = 10000.0
    eta_max: float = 20.0      # ARKODE growth clamp
    eta_min: float = 0.1
    eta_max_fail: float = 0.3  # shrink cap after an error-test failure
    small_nef: int = 2
    # PI gains (ARKODE defaults k1=0.8, k2=0.31 applied with 1/(p+1))
    k1: float = 0.8
    k2: float = 0.31
    k3: float = 0.1


def eta_from_error(cfg: ControllerConfig, state: ControllerState,
                   err: torch.Tensor, order: torch.Tensor,
                   after_failure: torch.Tensor) -> tuple:
    """``(eta, new_state)``: eta = h_new/h from the WRMS error ``err``
    (<= 1 accepts); ``order`` is the method order used in the exponent."""
    e = torch.clamp(err, min=1e-10)
    p = order.to(e.dtype)
    e1 = torch.clamp(state.err_prev, min=1e-10)
    e2 = torch.clamp(state.err_prev2, min=1e-10)

    def over_p(k):
        # k / p rounded once: PyTorch's ``number / tensor`` multiplies by
        # the reciprocal and rounds twice (-0.8 / 5 loses an ulp)
        return torch.full_like(p, k) / p

    if cfg.kind == "i":
        eta = e ** over_p(-1.0)
    elif cfg.kind == "pi":
        eta = e ** over_p(-cfg.k1) * e1 ** over_p(cfg.k2)
    else:  # pid
        eta = e ** over_p(-cfg.k1) * e1 ** over_p(cfg.k2) * \
            e2 ** over_p(-cfg.k3)

    eta = cfg.safety * eta
    eta = torch.clamp(eta, cfg.eta_min, cfg.eta_max)
    # after an error-test failure only allow shrinking (ARKODE etamxf)
    eta = torch.where(after_failure, torch.clamp(eta, max=cfg.eta_max_fail),
                      eta)
    return eta, ControllerState(err_prev=e, err_prev2=e1)
