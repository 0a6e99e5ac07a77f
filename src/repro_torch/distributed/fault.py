"""Straggler detection (port of ``repro.distributed.fault.StragglerMonitor``,
the part of that module the training loop uses).

An EWMA of per-step wall time with a k-sigma flag: a transient outlier
recommends a collective-timeout bump, ``patience`` outliers in a row a
replan without the slow host.  Plain Python.
"""
from __future__ import annotations

import dataclasses
import math


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
