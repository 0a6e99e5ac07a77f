"""Dispatch recording for ``layers.qeinsum`` and the kernel ops (port of
``repro.obs.dispatch``).

The port is eager: ``qeinsum`` and the ``kernels.ops`` wrappers run
Python on every call, so a recorder installed here counts **every
dispatch** (one event per call, on the card or the CPU), where the
reference, whose wrappers run only while jax traces, counts one event per
compiled specialization.  The instrument names, label keys and label
values are the reference's, so snapshots of both packages share one
vocabulary; only the values follow the per-call rule.  Over an engine's
steps, ``kernel_dispatch_total{kernel}`` is the number of calls of that
op, which on the card is ``ops.launches[kernel]``.

The recorder is a module global rather than a field threaded through
model code because ``qeinsum`` is called deep inside model forwards that
know nothing about engines.  ``recording(rec)`` installs it for the
dynamic extent of a block (the engine wraps ``step()``), and ``active()``
is the single cheap check instrumented call sites make: with no recorder
installed a call pays one ``None`` check.

Nothing here reads a device value or synchronizes: byte counts come from
shapes (``numel() * element_size()``).  The reference's
``jit_compiles_total`` and its recompile tripwire have no meaning without
jit and are not ported.

This module imports nothing from the rest of ``repro_torch`` (call sites
pass plain ints), so instrumenting ``models``/``kernels`` introduces no
import cycles.
"""
from __future__ import annotations

from contextlib import contextmanager

_active = None


def active():
    """The installed DispatchRecorder, or None (the common fast path)."""
    return _active


@contextmanager
def recording(recorder):
    """Install ``recorder`` as the active dispatch recorder for the block.
    Pass None to keep recording disabled (still a valid context)."""
    global _active
    prev = _active
    _active = recorder
    try:
        yield recorder
    finally:
        _active = prev


class DispatchRecorder:
    """Counts qeinsum/kernel dispatches into a MetricsRegistry.

    Bytes are analytic: for a packed-NVFP4 GEMM the weight-side traffic
    is ``codes + scales + tensor_scale`` (the packed representation that
    crosses device memory), for dense it is the weight tensor's bytes.
    Each label's child is bound on its first call and kept, so a later
    call is a dict hit and an ``inc()``.
    """

    def __init__(self, registry):
        self._gemm = registry.counter(
            "qeinsum_dispatch_total",
            "qeinsum GEMM dispatches per backend "
            "(counted on every call: the port is eager)",
            labels=("backend",))
        self._gemm_bytes = registry.counter(
            "qeinsum_weight_bytes_total",
            "analytic weight bytes moved per qeinsum dispatch, by backend "
            "(every call)",
            labels=("backend",))
        self._kernel = registry.counter(
            "kernel_dispatch_total",
            "kernel op dispatches (counted on every call: on the card "
            "one kernel launch each)",
            labels=("kernel",))
        self._gemm_cells: dict = {}
        self._kernel_cells: dict = {}

    def gemm(self, backend: str, weight_bytes: int = 0) -> None:
        cells = self._gemm_cells.get(backend)
        if cells is None:
            cells = self._gemm_cells[backend] = (
                self._gemm.labels(backend=backend),
                self._gemm_bytes.labels(backend=backend))
        cells[0].inc()
        if weight_bytes:
            cells[1].inc(float(weight_bytes))

    def kernel(self, name: str) -> None:
        cell = self._kernel_cells.get(name)
        if cell is None:
            cell = self._kernel_cells[name] = self._kernel.labels(kernel=name)
        cell.inc()
