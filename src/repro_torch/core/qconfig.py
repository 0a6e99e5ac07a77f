"""Quantization policy (port of ``repro.core.qconfig``): which tensors get
NVFP4, which stay BF16.

``QuantConfig`` is the reference's frozen dataclass with the same fields.
``q_act`` fake-quantizes a GEMM input through ``kernels.ops.nvfp4_qdq``:
the CUDA kernel for a tensor on the card, the plain version on the CPU,
with a straight-through gradient.  The op takes the ``act_scope``'s amax
itself (on the card: in the same launch); only under tensor parallelism
or on a training mesh is the amax a torch reduction, max-reduced over the
groups that split the tensor before the op.  On a training mesh
(``distributed.ctx.use_mesh``) a tensor-scope amax is the whole global
activation's, as GSPMD computes it in the reference: an activation's is
max-reduced over the data group (the batch is split) and, at a
row-parallel site, over the model group (the features are split); a
dense weight's over the model group where it is a model tile (under FSDP
the tile is gathered over the data group before the step; the step takes
every tile's amax in one collective, ``ctx.tile_amax``).
Both compute the reference's jitted
form of the QDQ (divisions by constants as reciprocal multiplications),
for weights as for activations: the reference's training step quantizes
both inside ``jax.jit``.

With ``numerics`` on and a probe tape installed (``obs.numerics``),
``q_act`` and ``q_weight`` also put the site's quantization-error stats
on the tape, computed from the same input with the same scope and amax
as the QDQ the forward applies; the forward's values do not change.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F

from ..distributed import ctx
from ..kernels import nvfp4_qdq as _qdq
from ..kernels import ops
from ..obs import numerics as obs_numerics
from . import nvfp4

Kind = Literal["mlp", "attn", "recurrent", "router", "embed", "lm_head"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization policy for a model (fields as in the reference)."""

    enabled: bool = True
    quantize_weights: bool = True
    quantize_activations: bool = True

    # --- selective quantization (paper §3.4) ---
    skip_attention: bool = False
    skip_recurrent: bool = False
    skip_first_layers: int = 0
    skip_last_layers: int = 0
    quantize_lm_head: bool = False

    # --- KV cache ---
    kv_cache_dtype: Literal["bf16", "fp8"] = "bf16"

    # --- serving weight representation: "qdq" (BF16 storage of quantized
    #     values) or "packed" (true 4-bit storage) ---
    weight_format: Literal["qdq", "packed"] = "qdq"

    # --- packed-GEMM backend: "auto" runs the nvfp4_matmul kernel on 2-D
    #     packed weights and dequantizes MoE expert stacks; "grouped" (the
    #     engine's fused tier) also runs the stacks through the
    #     nvfp4_matmul_grouped kernel; "dequant" dequantizes everything ---
    packed_backend: Literal["auto", "grouped", "dequant"] = "auto"

    act_scale_mode: Literal["dynamic", "calibrated"] = "dynamic"

    # --- activation tensor-scale scope: "tensor" (one amax), "row" (one per
    #     leading-axis element), "token" (one per last-dim vector) ---
    act_scope: Literal["tensor", "row", "token"] = "tensor"

    # --- numerics observability (obs.numerics): with a probe tape
    #     installed, q_act / q_weight record per-site quantization-error
    #     stats; off (the default) adds no operation ---
    numerics: bool = False

    def quantizes(self, kind: Kind) -> bool:
        """Does this policy quantize GEMMs of the given kind?"""
        if not self.enabled or not kind:
            return False
        if kind in ("router", "embed"):
            return False
        if kind == "lm_head":
            return self.quantize_lm_head
        if kind == "attn" and self.skip_attention:
            return False
        if kind == "recurrent" and self.skip_recurrent:
            return False
        return True

    def q_act(self, x: torch.Tensor, kind: Kind, tp=None) -> torch.Tensor:
        """Fake-quantize an activation (blocked along its last dim).

        ``tp`` (a ``distributed.ctx.TP``): ``x`` holds this rank's slice
        of a tensor split over the group (its features, or an MoE slab's
        experts), so the scope's amax is the maximum over the group, what
        the reference computes on the whole activation, and a probe's
        sums are the group's.  On a training mesh a tensor-scope amax is
        also max-reduced over the data group."""
        if not (self.quantizes(kind) and self.quantize_activations):
            return x
        amax = None
        dp = ctx.data() if self.act_scope == "tensor" else None
        if tp is not None or dp is not None:
            amax = _qdq.scope_amax(x.detach(), self.act_scope)
            if dp is not None:
                amax = ctx.data_max(amax)
            if tp is not None:
                amax = tp.all_reduce(amax, "max")
        tape = obs_numerics.active() if self.numerics else None
        if tape is not None:
            probe_amax = amax
            if probe_amax is None and self.act_scope != "tensor":
                probe_amax = _qdq.scope_amax(x, self.act_scope)
            tape.put(f"{kind}.act",
                     obs_numerics.quant_error_stats(x, probe_amax, tp))
        if amax is None:
            return _fq_lastdim(x, scope=self.act_scope)
        return _fq_lastdim(x, amax)

    def q_weight(self, w: torch.Tensor, kind: Kind,
                 contract_axis: int = 0) -> torch.Tensor:
        """Fake-quantize a DENSE weight, blocked along the contraction
        axis.  On a training mesh a weight's model tile takes the tensor
        amax of the whole weight, the model group's maximum
        (``ctx.tile_amax``); elsewhere its own."""
        if isinstance(w, nvfp4.PackedNVFP4):
            raise TypeError("q_weight expects a dense tensor; packed weights "
                            "go through resolve_weight / layers.qeinsum")
        if not (self.quantizes(kind) and self.quantize_weights):
            return w
        amax = ctx.tile_amax(w)
        tape = obs_numerics.active() if self.numerics else None
        if tape is not None:
            wm = torch.movedim(w, contract_axis % w.ndim, -1)
            tape.put(f"{kind}.w", obs_numerics.quant_error_stats(
                wm, amax, over=obs_numerics.MODEL if amax is not None else 0))
        return _fq_axis(w, contract_axis, amax)

    def resolve_weight(self, w, kind: Kind, contract_axis: int = 0):
        """GEMM-ready weight: packed leaves pass through, dense leaves get
        the policy's fake-quant."""
        if isinstance(w, nvfp4.PackedNVFP4):
            return w
        return self.q_weight(w, kind, contract_axis)


BF16 = QuantConfig(enabled=False)
NVFP4_ALL = QuantConfig()                       # AceReason / Llama Nemotron
NVFP4_HYBRID = QuantConfig(                     # Nemotron Nano 9B V2
    skip_attention=True, skip_first_layers=2, skip_last_layers=2)
NVFP4_MOE_HYBRID = QuantConfig(                 # Nemotron 3 Nano
    skip_attention=True, kv_cache_dtype="fp8")


def _fq_lastdim(x: torch.Tensor, tensor_amax: torch.Tensor | None = None,
                scope: str = "tensor") -> torch.Tensor:
    """QDQ along the last dim through the ``nvfp4_qdq`` op, padding to the
    block size if needed (zeros, which leave every amax as it is).  The
    amax is the ``scope``'s, taken by the op, or ``tensor_amax``.

    The op's backward is straight through (the reference's ``fake_quant``
    and ``fake_quant_calibrated``); the amax gets no gradient.
    """
    k = x.shape[-1]
    pad = (-k) % nvfp4.BLOCK
    if pad:
        return ops.nvfp4_qdq(F.pad(x, (0, pad)), tensor_amax,
                             scope=scope)[..., :k]
    return ops.nvfp4_qdq(x, tensor_amax, scope=scope)


def _fq_axis(w: torch.Tensor, axis: int,
             tensor_amax: torch.Tensor | None = None) -> torch.Tensor:
    """QDQ blocked along ``axis`` (moved last, QDQ'd, moved back), with
    the tensor's own amax or ``tensor_amax``."""
    axis = axis % w.ndim
    if axis == w.ndim - 1:
        return _fq_lastdim(w, tensor_amax)
    return torch.movedim(_fq_lastdim(torch.movedim(w, axis, -1), tensor_amax),
                         -1, axis)
