"""Packed-NVFP4 matmul: CUDA kernel for Hopper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/nvfp4_matmul.py::nvfp4_matmul``
(bodies ``_matmul_kernel`` and ``_dequant_tile``).  ``y = x @ W`` where W is
stored transposed and packed along K: codes uint8 [N, Kp/2], E4M3 scales
[N, Kp/16] (compact; the TPU's ``lane128`` swizzle does not change the
output and is not ported), an f32 tensor scale, and ``orig_k`` <= Kp.

The kernel (``csrc/nvfp4_matmul.cu``) decodes each weight tile on chip,
rounds it to bf16 as the plain version does, and accumulates
bf16 x bf16 products (exact in f32) in f32: it differs from the plain
version only in the order of the f32 sum.

Bound on the H100: at decode (M = 1..8) the weight bytes, 0.5625 B/param;
at prefill (M = batch x prompt) the operations.  Decode runs a GEMV (a warp
per two output columns, the lanes along K, x staged in shared memory) so
that every weight shape spreads over the 132 SMs with many loads in
flight; prefill runs a tiled f32-FMA GEMM.  Tensor cores and pipelined
loads are later work.
"""
from __future__ import annotations

import torch

from ..core import nvfp4
from ..core.nvfp4 import PackedNVFP4
from . import _build


def _check_packed(packed: PackedNVFP4, k: int) -> None:
    if packed.codes.ndim != 2:
        raise ValueError(f"nvfp4_matmul takes a 2-D packed weight, got "
                         f"codes {tuple(packed.codes.shape)}")
    if packed.k != k:
        raise ValueError(f"weight K {packed.k} != activation K {k}")


def plain(x: torch.Tensor, packed: PackedNVFP4,
          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: dequantize to bf16, f32 matmul, round."""
    *lead, k = x.shape
    _check_packed(packed, k)
    w = nvfp4.unpack(packed, dtype=torch.bfloat16).to(torch.float32)  # [N, Kp]
    if packed.orig_k and packed.orig_k != w.shape[-1]:
        w = w[:, : packed.orig_k]
    y = x.reshape(-1, k).to(torch.float32) @ w.T
    return y.to(out_dtype).reshape(*lead, w.shape[0])


def launch(x: torch.Tensor, packed: PackedNVFP4,
           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Run the CUDA kernel; x [..., K] bf16 or f32, out bf16 or f32."""
    if not x.is_cuda:
        raise ValueError(f"nvfp4_matmul kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nvfp4_matmul takes bf16 or f32 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nvfp4_matmul writes bf16 or f32, got {out_dtype}")
    *lead, k = x.shape
    _check_packed(packed, k)
    codes, scales = packed.codes, packed.scales
    n, kh = codes.shape
    kp = kh * 2
    if (codes.dtype != torch.uint8 or scales.dtype != nvfp4.FP8_E4M3
            or scales.shape != (n, kp // nvfp4.BLOCK) or kp % nvfp4.BLOCK):
        raise ValueError("packed weight is not in the [N, K/2] uint8 + "
                         "[N, K/16] e4m3 layout")
    if not (codes.is_cuda and scales.is_cuda and packed.tensor_scale.is_cuda):
        raise ValueError("packed weight must lie on the card")
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed codes and scales must be contiguous")
    if codes.data_ptr() % 8:             # read as 8-byte words
        raise ValueError("packed codes must be 8-byte aligned")
    ts = packed.tensor_scale.to(torch.float32).reshape(1)
    xm = x.reshape(-1, k).contiguous()
    m = xm.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().nvfp4_matmul(
            xm.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
            scales.data_ptr(), ts.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), m, n, k, kp,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nvfp4_matmul")
    return out.reshape(*lead, n)


def bytes_moved(x: torch.Tensor, packed: PackedNVFP4, out_dtype) -> int:
    """x read once, codes + scales + tensor scale read once, y written once."""
    m = x.numel() // x.shape[-1]
    n = packed.codes.shape[0]
    return (x.numel() * x.element_size() + packed.nbytes
            + m * n * torch.empty((), dtype=out_dtype).element_size())


def flops(x: torch.Tensor, packed: PackedNVFP4) -> int:
    m = x.numel() // x.shape[-1]
    return 2 * m * packed.codes.shape[0] * x.shape[-1]
