"""Observability of training and serving (port of ``repro.obs``).

  * ``metrics``  - counter / gauge / bounded-reservoir-histogram registry
    (``MetricsRegistry``); a disabled registry is a true no-op;
  * ``trace``    - request-lifecycle tracer with Chrome-trace/Perfetto
    export; ``annotate`` spans also open a
    ``torch.profiler.record_function`` of the same name;
  * ``dispatch`` - qeinsum / kernel-op dispatch recording (one count per
    call: the port is eager);
  * ``numerics`` - the numerics plane: per-layer quantization error of
    every quantized site, teacher-student hidden divergence, per-layer
    gradient norms, and the ``NumericsRecorder`` that turns them into
    labeled instruments (the engine's shadow teacher and training);
  * ``export``   - the ``repro.obs.metrics/v1`` snapshot of an engine or a
    training run, its Prometheus text, and the trace file;
  * ``validate`` - the schema, span and grammar gate of the artifacts;
  * ``compare``  - the per-layer drift gate between two snapshots.

``Observability(metrics=..., trace=...)`` bundles a registry, a tracer
and a dispatch recorder for the engine; the module-level ``NOOP``
singleton is what an engine built without telemetry holds: every
instrument handle it hands out is the shared do-nothing object, so the
decode hot path pays only no-op method calls.
"""
from __future__ import annotations

from .dispatch import DispatchRecorder
from .metrics import NOOP_REGISTRY, MetricsRegistry
from .trace import NOOP_TRACER, Tracer


class Observability:
    """Bundle of (metrics registry, tracer, dispatch recorder).

    ``metrics=False, trace=False`` yields a fully disabled bundle:
    prefer the shared ``NOOP`` singleton for that.  The registry and the
    tracer toggle independently.
    """

    def __init__(self, metrics: bool = True, trace: bool = False):
        self.metrics = MetricsRegistry() if metrics else NOOP_REGISTRY
        self.trace = Tracer() if trace else NOOP_TRACER
        self.dispatch = DispatchRecorder(self.metrics) if metrics else None
        self.enabled = bool(metrics or trace)


NOOP = Observability(metrics=False, trace=False)

__all__ = ["Observability", "NOOP", "MetricsRegistry", "Tracer",
           "DispatchRecorder", "NOOP_REGISTRY", "NOOP_TRACER"]
