"""Fault tolerance at fleet scale (port of ``repro.distributed.fault``):
elastic re-planning, the per-host batch deal, the straggler policy and
launcher-side liveness.

An SPMD program cannot lose a participant mid-step, so recovery is
restart-based: the launcher sees a missing pod (``Heartbeat``),
``replan`` computes a new mesh and per-pod batch from the survivors (the
global batch kept by gradient accumulation), and training restarts from
the newest checkpoint with the new plan; the data pipeline is stateless
in (step, host), so the replay is exact.  ``host_batch_slices`` deals a
global batch's rows to the data ranks (the training mesh's batch split).
``StragglerMonitor`` is the detection side: an EWMA of per-step wall time
with a k-sigma flag, recommending a collective-timeout bump (transient) or
a replan without the host (persistent).  Plain Python.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Plan:
    """A runnable assignment for the surviving fleet."""
    n_pods: int
    mesh_shape: tuple            # e.g. (2, 16, 16) or (16, 16)
    mesh_axes: tuple
    global_batch: int
    per_pod_batch: int
    grad_accum: int              # microbatch multiplier that keeps the batch


def replan(total_pods: int, failed_pods: Sequence[int], chips_per_pod: int,
           global_batch: int, model_parallel: int = 16) -> Plan:
    """Elastic data parallelism: drop the failed pods, keep tensor
    parallelism whole inside each pod, and keep the global batch by
    gradient accumulation when the data-parallel degree shrinks.  Raises
    if no pod survives."""
    alive = total_pods - len(set(failed_pods))
    if alive < 1:
        raise RuntimeError("no surviving pods")
    data_par = chips_per_pod // model_parallel
    if alive == 1:
        shape = (data_par, model_parallel)
        axes = ("data", "model")
    else:
        shape = (alive, data_par, model_parallel)
        axes = ("pod", "data", "model")
    # the microbatch of each (pod, data) slice stays; accumulate the rest
    dp_degree = alive * data_par
    base = global_batch // (total_pods * data_par)
    accum = math.ceil(global_batch / (dp_degree * base))
    per_pod = global_batch // alive
    return Plan(n_pods=alive, mesh_shape=shape, mesh_axes=axes,
                global_batch=global_batch, per_pod_batch=per_pod,
                grad_accum=accum)


def host_batch_slices(global_batch: int, n_hosts: int) -> list[tuple[int, int]]:
    """Deal [start, end) batch rows to hosts as evenly as possible (the
    first ``global_batch % n_hosts`` hosts take one row more)."""
    base, rem = divmod(global_batch, n_hosts)
    out, start = [], 0
    for h in range(n_hosts):
        n = base + (1 if h < rem else 0)
        out.append((start, start + n))
        start += n
    assert start == global_batch
    return out


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor.  ``feed()`` returns an action or None."""
    alpha: float = 0.05          # EWMA smoothing
    k_sigma: float = 4.0         # flag threshold
    patience: int = 3            # consecutive flags before escalation
    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _flags: int = 0

    def feed(self, step_time_s: float) -> str | None:
        self._n += 1
        if self._n == 1:
            self._mean = step_time_s
            return None
        sigma = math.sqrt(max(self._var, 1e-12))
        flagged = (self._n >= 10
                   and step_time_s > self._mean + self.k_sigma * sigma)
        if not flagged:
            # flagged samples stay out of the baseline, or a persistent
            # straggler would inflate sigma and hide itself
            delta = step_time_s - self._mean
            self._mean += self.alpha * delta
            self._var = (1 - self.alpha) * (self._var
                                            + self.alpha * delta * delta)
            self._flags = 0
            return None
        self._flags += 1
        if self._flags >= self.patience:
            self._flags = 0
            return "replan"                   # persistent straggler
        return "timeout_bump"                 # transient hiccup


@dataclasses.dataclass
class Heartbeat:
    """Launcher-side liveness bookkeeping (the transport is the
    deployment's): ``mark(pod, t)``; ``dead(now)`` lists the pods whose
    last mark is older than ``timeout_s``."""
    timeout_s: float = 60.0
    _last: dict = dataclasses.field(default_factory=dict)

    def mark(self, pod: int, t: float) -> None:
        self._last[pod] = t

    def dead(self, now: float) -> list[int]:
        return sorted(p for p, t in self._last.items()
                      if now - t > self.timeout_s)
