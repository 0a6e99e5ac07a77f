"""The tensor-parallel context (port of ``repro.distributed.ctx``).

The reference activates a ``(mesh, rules)`` pair while it traces a step,
and GSPMD partitions the program.  PyTorch has no GSPMD, so the port is
explicit SPMD: one process per rank, each holding its own tile of every
sharded weight and of the KV pool, all running the same code on the same
inputs and meeting at the collectives.  Its counterpart of the pair is a
``TP`` object: the process group, this rank, the group's size and the
device; the rules table stays with the engine.  The engine enters it
around its forwards (``maybe_use``); ``layers.qeinsum`` and the decoder
read it (``current``, ``tp_size``) to pick the K4 GEMM and to place the
collectives.

``cst`` has no counterpart: no activation is resharded implicitly.  Every
change of layout is a collective the model code names (the row-parallel
GEMM's all-reduce, the vocab-parallel embedding's all-reduce, the logits'
all-gather).

The collectives run through ``torch.distributed``.  With the gloo
backend (this slice's, also on the card) a tensor on the card goes
through a host copy in every call: gloo moves host memory.  That follows
from the rank's device, never from a failure.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TP:
    """One rank's view of a tensor-parallel group."""

    group: Any                  # a torch.distributed process group
    rank: int
    size: int
    device: torch.device
    # collectives since the last ``reset_counts`` and their host seconds
    # (host copies included; on the card from the moment the card's queued
    # work is done, so time the card spends computing is not counted)
    counts: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "seconds": 0.0}, compare=False)

    @property
    def stage(self) -> bool:
        """gloo moves host memory: a tensor on the card goes through a
        host copy in every collective."""
        return self.device.type == "cuda"

    def reset_counts(self) -> None:
        self.counts.update(calls=0, seconds=0.0)

    def _count(self, t0: float) -> None:
        self.counts["calls"] += 1
        self.counts["seconds"] += time.perf_counter() - t0

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.stage else x

    def _start(self) -> float:
        if self.stage:      # the host copy waits for the card anyway
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or max) of ``x`` over the group, in f32, then cast back
        to ``x``'s dtype; every rank gets the same bits."""
        t0 = self._start()
        buf = self._host(x.to(torch.float32)).contiguous()
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        out = buf.to(device=x.device, dtype=x.dtype)
        self._count(t0)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order.
        The bytes move as they are (any dtype: gloo takes no float8, so
        every tensor travels as its bytes)."""
        t0 = self._start()
        src = self._host(x).contiguous()
        raw = src if src.dtype == torch.uint8 else src.view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(parts, raw, group=self.group)
        parts = [p.view(x.dtype) for p in parts]
        out = torch.cat(parts, dim).to(x.device)
        self._count(t0)
        return out


_CTX: list = []


@contextlib.contextmanager
def use(tp: TP):
    _CTX.append(tp)
    try:
        yield
    finally:
        _CTX.pop()


def maybe_use(tp: TP | None):
    """``use(tp)``, or a no-op context when ``tp`` is None: the one way
    the engine enters the tensor-parallel context."""
    return use(tp) if tp is not None else contextlib.nullcontext()


def active() -> bool:
    return bool(_CTX)


def current() -> TP | None:
    """The innermost active context, or None."""
    return _CTX[-1] if _CTX else None


def tp_size() -> int:
    """The active group's size (1 without a context)."""
    return _CTX[-1].size if _CTX else 1
