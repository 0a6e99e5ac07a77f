"""Observability of training (port of ``repro.obs``, its training half).

  * ``metrics``  - counter / gauge / bounded-reservoir-histogram registry;
  * ``numerics`` - the numerics plane: per-layer quantization error of
    every quantized site, teacher-student hidden divergence, per-layer
    gradient norms, and the ``NumericsRecorder`` that turns them into
    labeled instruments;
  * ``export``   - the ``repro.obs.metrics/v1`` training snapshot and its
    Prometheus text;
  * ``validate`` - the schema and grammar gate of a snapshot;
  * ``compare``  - the per-layer drift gate between two snapshots.

The request tracer, the dispatch recorder and the engine's snapshot come
with the serving-telemetry slice of the port.
"""
from __future__ import annotations

from .metrics import NOOP_REGISTRY, MetricsRegistry

__all__ = ["MetricsRegistry", "NOOP_REGISTRY"]
