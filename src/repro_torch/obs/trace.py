"""Request-lifecycle tracer with Chrome-trace/Perfetto JSON export (port of
``repro.obs.trace``).

Spans are recorded against ``time.monotonic()`` (so durations survive
wall-clock adjustments) and anchored to ONE wall-clock timestamp taken
when the tracer is created, so exported traces still carry absolute
time.  Event layout follows the Chrome trace event format:

  * pid 1 - the engine process.
  * tid 0 - the engine lane (step-level spans: prefill batches, decode
    steps, spec draft/verify/rollback).
  * tid rid+1 - one lane per request (submit -> queue -> prefill ->
    first_token -> ... -> finish), so Perfetto shows each request's
    lifecycle as its own track.

``annotate(name)`` wraps a span AND a ``torch.profiler.record_function``
of the same name, so a ``torch.profiler`` trace captured around the run
lines up with the engine's spans by name.  The tracer reads only the host
clock: no span waits for the card.

``NOOP_TRACER`` is a true no-op: every method returns immediately and
the span context managers are a single shared null object.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

SCHEMA = "repro.obs.trace/v1"

ENGINE_TID = 0


def request_tid(rid: int) -> int:
    """Trace lane for request ``rid`` (tid 0 is the engine lane)."""
    return rid + 1


class Tracer:
    def __init__(self):
        # one wall-clock anchor; everything else is monotonic
        self.wall_t0 = time.time()
        self.t0 = time.monotonic()
        self.events: list[dict] = []
        self._tid_names: dict[int, str] = {}
        self.thread_name(ENGINE_TID, "engine")

    enabled = True

    # -- low-level emitters ------------------------------------------------
    def _ts_us(self) -> float:
        return (time.monotonic() - self.t0) * 1e6

    def thread_name(self, tid: int, name: str) -> None:
        self._tid_names[tid] = name

    def begin(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        ev = {"ph": "B", "name": name, "pid": 1, "tid": tid,
              "ts": self._ts_us()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        ev = {"ph": "E", "name": name, "pid": 1, "tid": tid,
              "ts": self._ts_us()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        ev = {"ph": "i", "name": name, "pid": 1, "tid": tid,
              "ts": self._ts_us(), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- span context managers ---------------------------------------------
    @contextmanager
    def span(self, name: str, tid: int = ENGINE_TID, **args):
        self.begin(name, tid, **args)
        try:
            yield
        finally:
            self.end(name, tid)

    @contextmanager
    def annotate(self, name: str, tid: int = ENGINE_TID, **args):
        """Span + ``torch.profiler.record_function`` with the same name, so
        a device profile captured around the run aligns with engine
        spans."""
        from torch.profiler import record_function
        self.begin(name, tid, **args)
        try:
            with record_function(name):
                yield
        finally:
            self.end(name, tid)

    # -- export -------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace event format; open in Perfetto (ui.perfetto.dev)."""
        meta = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                 "ts": 0, "args": {"name": "repro.serve"}}]
        for tid, name in sorted(self._tid_names.items()):
            meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                         "tid": tid, "ts": 0, "args": {"name": name}})
        return {
            "traceEvents": meta + self.events,
            "displayTimeUnit": "ms",
            "metadata": {"schema": SCHEMA,
                         "wall_time_anchor_s": self.wall_t0},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NoopTracer:
    """Disabled tracer: records nothing, allocates nothing per call."""

    enabled = False
    events = ()

    def thread_name(self, tid: int, name: str) -> None:
        pass

    def begin(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        pass

    def end(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        pass

    def instant(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        pass

    def span(self, name: str, tid: int = ENGINE_TID, **args):
        return _NULL_CTX

    def annotate(self, name: str, tid: int = ENGINE_TID, **args):
        return _NULL_CTX

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "metadata": {"schema": SCHEMA, "wall_time_anchor_s": 0.0}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


NOOP_TRACER = NoopTracer()
