"""Gradient compression for the data-parallel all-reduce: int8 with a
per-tensor scale and error feedback (port of ``repro.optim.compression``).

Int8 with one scale a tensor halves the all-reduce's payload against bf16
(a quarter of f32); with error feedback the quantization residual is
added back into the next step's gradient, so the bias telescopes: the sum
of what was sent over n steps is the sum of the gradients less the last
residual.

    comp = Int8Compressor()
    cstate = comp.init(params)
    grads, cstate = comp.roundtrip(grads, cstate)   # the payload's numerics

``roundtrip`` is quantize, then (where the collective would run)
dequantize, in f32: the residual added, the amax over the tensor, a scale
of amax / 127, round half to even, clip to +-127.  The trainer does not
call it, as the reference's does not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models.common import tree_map

_F32 = torch.float32


class CompressionState(NamedTuple):
    residual: Any


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    error_feedback: bool = True

    def init(self, params) -> CompressionState:
        """Zero f32 residuals shaped like ``params``."""
        return CompressionState(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device),
            params))

    def roundtrip(self, grads, state: CompressionState):
        """(the dequantized gradients in their own dtypes, the new state)."""
        def one(g, r):
            g32 = g.to(_F32) + (r if self.error_feedback else 0.0)
            amax = torch.amax(torch.abs(g32))
            scale = torch.clamp_min(amax, 1e-30) / 127.0
            q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
            dq = q.to(_F32) * scale
            return dq.to(g.dtype), g32 - dq

        out = tree_map(one, grads, state.residual)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), CompressionState(residual=pick(1))
