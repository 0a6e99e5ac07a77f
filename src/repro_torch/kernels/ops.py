"""Public kernel ops (port of ``repro.kernels.ops``).

Each op takes its plain version for a tensor on the CPU and launches its
CUDA kernel for a tensor on the card; on the card the kernel runs or
raises, nothing falls back.  ``launches`` counts kernel launches only: the
CPU path does not count, so a nonzero count proves that a run on the card
went through the kernel.

Each op also counts one dispatch (``kernel_dispatch_total{kernel}``)
into the dispatch recorder an engine step installs
(``obs.dispatch.recording``), on either device, as the reference's
interpret mode does; with no recorder installed that is one ``None``
check.

``nvfp4_qdq`` and ``kl_loss`` are differentiable.  The QDQ's backward is
the straight-through estimator of the reference's ``nvfp4.fake_quant``
(the identity; no kernel, and no gradient for the amax); ``kl_loss``'s
backward is the K6 kernel.
"""
from __future__ import annotations

import collections
from collections.abc import Mapping

import torch

from ..core.nvfp4 import PackedNVFP4, pack, unpack_layout
from ..obs import dispatch as obs_dispatch
from . import kl_loss as _kl
from . import nvfp4_matmul as _matmul
from . import nvfp4_qdq as _qdq
from . import paged_attention as _paged
from . import ref

class _Counts(collections.Counter):
    """Launch counts.  Compared with any mapping, as counts compare: a
    name one side lacks counts 0."""

    def __eq__(self, other):
        if isinstance(other, Mapping):
            return collections.Counter.__eq__(self, collections.Counter(other))
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


# kernel launches per op since the caller last reset them
launches = _Counts({"nvfp4_qdq": 0, "nvfp4_matmul": 0,
                    "nvfp4_matmul_grouped": 0, "nvfp4_matmul_tp": 0,
                    "kl_loss": 0, "kl_loss_bwd": 0, "paged_attention": 0})


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _note(name: str) -> None:
    """Count one dispatch of op ``name`` if an engine step is recording
    (every call: see ``obs.dispatch``)."""
    rec = obs_dispatch.active()
    if rec is not None:
        rec.kernel(name)


class _QDQ(torch.autograd.Function):
    """QDQ forward (kernel or plain); straight-through backward."""

    @staticmethod
    def forward(ctx, x, tensor_amax, scope):
        if x.device.type == "cpu":
            return ref.nvfp4_qdq_ref(x, tensor_amax, scope)
        out = _qdq.launch(x, tensor_amax, scope)
        launches["nvfp4_qdq"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def nvfp4_qdq(x: torch.Tensor, tensor_amax: torch.Tensor | None = None, *,
              scope: str = "tensor") -> torch.Tensor:
    """Fused NVFP4 fake-quant, blocked along the last dim, with the amax of
    ``scope`` ("tensor", "row": per leading-axis element, "token": per
    last-dim vector) or the caller's ``tensor_amax``; one kernel launch on
    the card.  Differentiable in ``x`` (straight through); the amax gets no
    gradient."""
    _note("nvfp4_qdq")
    if tensor_amax is not None:
        tensor_amax = tensor_amax.detach()
    return _QDQ.apply(x, tensor_amax, scope)


class _KLLoss(torch.autograd.Function):
    """Masked-mean KL(p_t || p_s): K5 forward, K6 backward; the gradient
    reaches the student logits only."""

    @staticmethod
    def forward(ctx, t, s, mask, denom):
        if s.device.type == "cpu":
            kl, z_t, z_s = _kl.plain_fwd(t, s)
        else:
            kl, z_t, z_s = _kl.launch_fwd(t, s)
            launches["kl_loss"] += 1
        maskf = mask.to(torch.float32)
        if denom is None:
            denom = torch.clamp_min(torch.sum(maskf), 1.0)
        ctx.save_for_backward(t, s, maskf, z_t, z_s, denom)
        return torch.sum(kl * maskf) / denom

    @staticmethod
    def backward(ctx, g):
        t, s, maskf, z_t, z_s, denom = ctx.saved_tensors
        g_tok = (g * maskf / denom).to(torch.float32)
        if s.device.type == "cpu":
            ds = _kl.plain_bwd(t, s, z_t, z_s, g_tok)
        else:
            ds = _kl.launch_bwd(t, s, z_t, z_s, g_tok)
            launches["kl_loss_bwd"] += 1
        return None, ds, None, None


def kl_loss(t_logits: torch.Tensor, s_logits: torch.Tensor,
            mask: torch.Tensor,
            denom: torch.Tensor | None = None) -> torch.Tensor:
    """Masked-mean token KL(p_t || p_s) for [T, V] logits and a [T] mask
    (flatten the batch first); differentiable in ``s_logits`` only.
    ``denom``: the mean's denominator (a training mesh's count over every
    data rank: ``losses.global_denominator``), by default the mask's."""
    _note("kl_loss")
    return _KLLoss.apply(t_logits.detach(), s_logits, mask.detach(),
                         None if denom is None else denom.detach())


def nvfp4_matmul(x: torch.Tensor, packed: PackedNVFP4,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W from packed NVFP4 weights, dequantized on the fly."""
    _note("nvfp4_matmul")
    if x.device.type == "cpu":
        return ref.nvfp4_matmul_ref(x, packed, out_dtype)
    out = _matmul.launch(x, packed, out_dtype)
    launches["nvfp4_matmul"] += 1
    return out


def nvfp4_matmul_grouped(x: torch.Tensor, packed: PackedNVFP4,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """y[g] = x[g] @ W_g for a packed stack [G, N, K/2] in one grouped
    launch (the MoE expert GEMM); x [G, M, K]."""
    _note("nvfp4_matmul_grouped")
    if x.device.type == "cpu":
        return ref.nvfp4_matmul_grouped_ref(x, packed, out_dtype)
    out = _matmul.launch_grouped(x, packed, out_dtype)
    launches["nvfp4_matmul_grouped"] += 1
    return out


def nvfp4_matmul_tp(x_local: torch.Tensor, packed_tile: PackedNVFP4, tp,
                    parallelism: str, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``y = x @ W`` with W split over the tensor-parallel group ``tp``
    (``distributed.ctx.TP``); ``packed_tile`` is this rank's tile.
    ``"column"``: x whole, y this rank's N/n columns, no collective.
    ``"row"``: x this rank's K/n features, y whole: the f32 partials are
    summed over the group, then cast.  One launch per call and rank."""
    _note("nvfp4_matmul_tp")
    if x_local.device.type == "cpu":
        return ref.nvfp4_matmul_tp_ref(x_local, packed_tile, tp, parallelism,
                                       out_dtype)
    out = _matmul.launch_tp(x_local, packed_tile, tp, parallelism, out_dtype)
    launches["nvfp4_matmul_tp"] += 1
    return out


def paged_attention(q: torch.Tensor, pool_sl: dict, block_tables: torch.Tensor,
                    pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Page-table gather + FP8-KV dequant + attend over one pool layer:
    q [B, S, H, hd] against ``pool_sl`` {"k", "v", optional "k_scale",
    "v_scale"} through block_tables [B, MB], pos [B] or [B, S] valid-key
    counts.  The ``models.attention.paged_attend`` two-step is its oracle."""
    _note("paged_attention")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool_sl, block_tables, pos,
                                       window=window)
    out = _paged.launch(q, pool_sl["k"], pool_sl["v"], block_tables, pos,
                        pool_sl.get("k_scale"), pool_sl.get("v_scale"),
                        window=window)
    launches["paged_attention"] += 1
    return out


def pack_weight(w: torch.Tensor) -> PackedNVFP4:
    """Pack a [K, N] weight into the kernel's W^T [N, K] NVFP4 layout."""
    return pack(w.T)


def dequant_weight(packed: PackedNVFP4, contract_axis: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize a packed weight back to its original dense layout."""
    return unpack_layout(packed, contract_axis, dtype)


__all__ = ["nvfp4_qdq", "nvfp4_matmul", "nvfp4_matmul_grouped",
           "nvfp4_matmul_tp", "kl_loss",
           "paged_attention",
           "pack_weight",
           "dequant_weight", "launches", "reset_launches", "ref"]
