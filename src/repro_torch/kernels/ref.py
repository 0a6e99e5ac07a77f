"""Plain PyTorch versions of the kernels, under the reference's names
(``repro.kernels.ref``).  Each lives beside its kernel; the tests and
``chip_smoke.py`` hold the kernels against them."""
from __future__ import annotations

import torch

from ..core.losses import kl_from_logits as kl_loss_ref
from .nvfp4_matmul import plain as nvfp4_matmul_ref
from .nvfp4_matmul import plain_grouped as nvfp4_matmul_grouped_ref
from .nvfp4_matmul import plain_tp as nvfp4_matmul_tp_ref
from .nvfp4_qdq import plain as nvfp4_qdq_ref
from .paged_attention import plain as paged_attention_ref


def kl_grad_ref(t_logits: torch.Tensor, s_logits: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Analytic d(mean KL)/d(student logits), f32."""
    f32 = torch.float32
    p_t = torch.softmax(t_logits.to(f32), -1)
    p_s = torch.softmax(s_logits.to(f32), -1)
    maskf = mask.to(f32)
    return (p_s - p_t) * (maskf / torch.clamp_min(torch.sum(maskf), 1.0))[..., None]


__all__ = ["nvfp4_qdq_ref", "nvfp4_matmul_ref", "nvfp4_matmul_grouped_ref",
           "nvfp4_matmul_tp_ref",
           "kl_loss_ref", "kl_grad_ref", "paged_attention_ref"]
