"""Public kernel ops (port of ``repro.kernels.ops``).

Each op takes its plain version for a tensor on the CPU and launches its
CUDA kernel for a tensor on the card; on the card the kernel runs or
raises, nothing falls back.  ``launches`` counts kernel launches only: the
CPU path does not count, so a nonzero count proves that a run on the card
went through the kernel.
"""
from __future__ import annotations

import torch

from ..core.nvfp4 import PackedNVFP4, pack, unpack_layout
from . import nvfp4_matmul as _matmul
from . import nvfp4_qdq as _qdq
from . import ref

# kernel launches per op since the caller last reset them
launches = {"nvfp4_qdq": 0, "nvfp4_matmul": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvfp4_qdq(x: torch.Tensor, tensor_amax: torch.Tensor | None = None) -> torch.Tensor:
    """Fused NVFP4 fake-quant, blocked along the last dim."""
    if x.device.type == "cpu":
        return ref.nvfp4_qdq_ref(x, tensor_amax)
    out = _qdq.launch(x, tensor_amax)
    launches["nvfp4_qdq"] += 1
    return out


def nvfp4_matmul(x: torch.Tensor, packed: PackedNVFP4,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W from packed NVFP4 weights, dequantized on the fly."""
    if x.device.type == "cpu":
        return ref.nvfp4_matmul_ref(x, packed, out_dtype)
    out = _matmul.launch(x, packed, out_dtype)
    launches["nvfp4_matmul"] += 1
    return out


def pack_weight(w: torch.Tensor) -> PackedNVFP4:
    """Pack a [K, N] weight into the kernel's W^T [N, K] NVFP4 layout."""
    return pack(w.T)


def dequant_weight(packed: PackedNVFP4, contract_axis: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize a packed weight back to its original dense layout."""
    return unpack_layout(packed, contract_axis, dtype)


__all__ = ["nvfp4_qdq", "nvfp4_matmul", "pack_weight", "dequant_weight",
           "launches", "reset_launches", "ref"]
