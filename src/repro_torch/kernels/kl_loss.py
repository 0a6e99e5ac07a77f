"""Streaming token-level KL: CUDA kernels for Hopper and their plain versions.

Replaces the Pallas TPU kernels of ``repro/kernels/kl_loss.py``: the
forward (K5, ``_kl_fwd`` / ``_kl_fwd_kernel``) gives per-token
``KL(p_t || p_s)`` and both logsumexps in one pass over the vocabulary;
the backward (K6, ``_kl_vjp_bwd`` / ``_kl_bwd_kernel``) gives
``ds = (p_s - p_t) * g_tok``.  The masked mean over tokens, and ``g_tok``
from it, are taken in torch around the launches, as the reference takes
them outside its ``pallas_call``.

The kernels (``csrc/kl_loss.cu``) give one thread block to each token row;
its threads stream the row with 16-byte loads and keep online
(max, sum-exp) statistics for both distributions, merged across the block
at the end.  Both are bound by bytes: the forward reads the two [T, V]
logit tensors once, the backward reads them once and writes ``ds`` once.

The plain versions are the port of ``losses.kl_from_logits`` per token
(forward) and of ``ref.kl_grad_ref`` given the logsumexps (backward).
"""
from __future__ import annotations

import torch

from ..core import losses
from . import _build

_DTYPES = (torch.bfloat16, torch.float32)


def plain_fwd(t: torch.Tensor, s: torch.Tensor):
    """(kl, z_t, z_s), each [T] f32: ``kl_from_logits`` before its mean."""
    return (losses.kl_per_token(t, s), torch.logsumexp(t.to(torch.float32), -1),
            torch.logsumexp(s.to(torch.float32), -1))


def plain_bwd(t: torch.Tensor, s: torch.Tensor, z_t: torch.Tensor,
              z_s: torch.Tensor, g_tok: torch.Tensor) -> torch.Tensor:
    """``(exp(s - z_s) - exp(t - z_t)) * g_tok[:, None]`` in s's dtype."""
    p_s = torch.exp(s.to(torch.float32) - z_s[:, None])
    p_t = torch.exp(t.to(torch.float32) - z_t[:, None])
    return ((p_s - p_t) * g_tok[:, None]).to(s.dtype)


def _check(t: torch.Tensor, s: torch.Tensor):
    if not (t.is_cuda and s.is_cuda):
        raise ValueError(f"kl_loss kernels need CUDA tensors, got {t.device} "
                         f"and {s.device}")
    if t.dtype != s.dtype or t.dtype not in _DTYPES:
        raise TypeError(f"kl_loss kernels take two bf16 or two f32 tensors, "
                        f"got {t.dtype} and {s.dtype}")
    if t.ndim != 2 or t.shape != s.shape:
        raise ValueError(f"kl_loss kernels take [T, V] and [T, V], got "
                         f"{tuple(t.shape)} and {tuple(s.shape)}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, so that rows of t, s and ds share
    their offset from a 16-byte boundary (the kernels load 16-byte
    vectors)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def launch_fwd(t: torch.Tensor, s: torch.Tensor):
    """K5 on the card: (kl, z_t, z_s), each [T] f32."""
    _check(t, s)
    t, s = _aligned(t), _aligned(s)
    rows, v = t.shape
    kl, z_t, z_s = (torch.empty(rows, dtype=torch.float32, device=t.device)
                    for _ in range(3))
    with torch.cuda.device(t.device):
        err = _build.library().kl_fwd(
            t.data_ptr(), s.data_ptr(), int(t.dtype == torch.float32),
            kl.data_ptr(), z_t.data_ptr(), z_s.data_ptr(), rows, v,
            torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(err, "kl_fwd")
    return kl, z_t, z_s


def launch_bwd(t: torch.Tensor, s: torch.Tensor, z_t: torch.Tensor,
               z_s: torch.Tensor, g_tok: torch.Tensor) -> torch.Tensor:
    """K6 on the card: ds [T, V] in s's dtype."""
    _check(t, s)
    t, s = _aligned(t), _aligned(s)
    rows, v = t.shape
    z_t, z_s, g_tok = (a.to(torch.float32).contiguous() for a in (z_t, z_s, g_tok))
    if not (z_t.shape == z_s.shape == g_tok.shape == (rows,)):
        raise ValueError(f"z_t, z_s and g_tok must be [{rows}]")
    ds = torch.empty_like(s)
    with torch.cuda.device(t.device):
        err = _build.library().kl_bwd(
            t.data_ptr(), s.data_ptr(), int(t.dtype == torch.float32),
            z_t.data_ptr(), z_s.data_ptr(), g_tok.data_ptr(), ds.data_ptr(),
            rows, v, torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(err, "kl_bwd")
    return ds


def bytes_fwd(t: torch.Tensor) -> int:
    """Bytes K5 must move: t and s read once, three f32 per row written."""
    return 2 * t.numel() * t.element_size() + 3 * 4 * t.shape[0]


def bytes_bwd(t: torch.Tensor) -> int:
    """Bytes K6 must move: t and s read once, ds written once, plus the
    three f32 per row it reads."""
    return 3 * t.numel() * t.element_size() + 3 * 4 * t.shape[0]


# f32 operations per element pair: forward two exps (about 10 each as
# libdevice's expf computes them), max, subtract, multiply-add, adds;
# backward two exps, two subtracts, a subtract and a multiply
OPS_FWD = 26
OPS_BWD = 24
