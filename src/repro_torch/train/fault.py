"""Fault tolerance & elasticity bookkeeping (pure logic; host-side).

The port's copy of ``repro.train.fault``.

At 1000+ nodes the runtime must (a) notice dead/slow workers, (b) decide
a recovery plan, (c) rebuild the mesh and resume from the newest
committed checkpoint.  An SPMD runtime makes (c) a
restart-with-new-mesh (processes re-join the process group with the
survivor set); this module supplies the decision logic, which is what we
can implement and test without hardware:

* :class:`HeartbeatMonitor` — per-worker heartbeats with timeout -> dead
  set, plus step-time statistics -> straggler set (z-score rule, the
  standard mitigation trigger for backup-task scheduling);
* :func:`plan_elastic_mesh` — given the survivor count and the
  parallelism constraints (model axis must stay intact for TP; data axis
  shrinks in whole multiples), returns the largest legal mesh and the
  batch resharding plan;
* :func:`should_checkpoint` — risk-based checkpoint cadence (expected
  lost work vs write cost; Young/Daly interval).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class WorkerStats:
    last_heartbeat: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)

    def record_step(self, t: float, window: int = 50):
        self.step_times.append(t)
        if len(self.step_times) > window:
            self.step_times.pop(0)

    @property
    def mean(self) -> float:
        return sum(self.step_times) / max(len(self.step_times), 1)


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 straggler_zscore: float = 3.0):
        self.timeout = timeout_s
        self.z = straggler_zscore
        self.workers: Dict[int, WorkerStats] = {
            i: WorkerStats() for i in range(n_workers)}

    def heartbeat(self, worker: int, now: Optional[float] = None):
        self.workers[worker].last_heartbeat = now or time.time()

    def record_step(self, worker: int, step_time: float):
        self.workers[worker].record_step(step_time)

    def dead(self, now: Optional[float] = None) -> Set[int]:
        now = now or time.time()
        return {w for w, s in self.workers.items()
                if s.last_heartbeat and now - s.last_heartbeat > self.timeout}

    def stragglers(self, ratio: float = 1.5) -> Set[int]:
        """Workers whose mean step time exceeds ratio x the fleet median —
        the standard backup-task trigger (robust to the straggler itself
        polluting the statistics, unlike a z-score over the mean)."""
        means = sorted(s.mean for s in self.workers.values()
                       if s.step_times)
        if len(means) < 4:
            return set()
        med = means[len(means) // 2]
        return {w for w, s in self.workers.items()
                if s.step_times and s.mean > ratio * med}


def plan_elastic_mesh(n_alive_hosts: int, chips_per_host: int,
                      model_parallel: int,
                      prefer_pods: int = 1) -> Optional[Tuple[int, ...]]:
    """Largest legal (pod, data, model) mesh on the survivors.

    TP ('model') cannot shrink without resharding weights, so it is held
    fixed; data parallelism absorbs the loss.  Returns None if fewer than
    one model group survives.
    """
    chips = n_alive_hosts * chips_per_host
    groups = chips // model_parallel
    if groups < 1:
        return None
    pods = math.gcd(prefer_pods, groups) or 1
    data = groups // pods
    return (pods, data, model_parallel)


def reshard_batch_plan(global_batch: int, old_data: int, new_data: int):
    """Keep global batch: per-replica batch grows by old/new (must stay
    integral; otherwise shrink global batch to the nearest multiple)."""
    if global_batch % new_data == 0:
        return {"global_batch": global_batch,
                "per_replica": global_batch // new_data}
    gb = (global_batch // new_data) * new_data
    return {"global_batch": gb, "per_replica": gb // new_data}


def should_checkpoint(step: int, steps_since_ckpt: int, mean_step_s: float,
                      ckpt_write_s: float, mtbf_s: float = 24 * 3600.0):
    """Young/Daly-style optimal interval: sqrt(2 * write_cost * MTBF)."""
    interval_s = math.sqrt(2.0 * ckpt_write_s * mtbf_s)
    return steps_since_ckpt * mean_step_s >= interval_s
