"""Packed-NVFP4 matmul, single (K2), grouped (K3) and tensor-parallel
(K4): CUDA kernels for Hopper and their plain versions.

K2 replaces the Pallas TPU kernel ``repro/kernels/nvfp4_matmul.py::
nvfp4_matmul`` (bodies ``_matmul_kernel`` and ``_dequant_tile``), K3 its
``nvfp4_matmul_grouped`` (``_grouped_kernel``).  ``y = x @ W`` where W is
stored transposed and packed along K: codes uint8 [N, Kp/2], E4M3 scales
[N, Kp/16] (compact; the TPU's ``lane128`` swizzle does not change the
output and is not ported), an f32 tensor scale, and ``orig_k`` <= Kp.

K3 computes ``y[g] = x[g] @ W_g`` over a stack: x [G, M, K], codes
[G, N, Kp/2], scales [G, N, Kp/16] and a tensor scale per group
([G, 1, 1], ``pack(..., n_lead=1)``) or shared by the stack (one value,
what PTQ gives a layer's expert stack).  It is the MoE expert GEMM.

One device code serves both (``csrc/nvfp4_matmul.cuh``): a tensor-core
GEMM for every M that computes ``Y^T = W^T X^T`` (weight rows on the
MMA's rows, tokens on its columns).  Codes, scales and x stream through a
ring of shared memory filled by ``cp.async``; each thread decodes its A
fragments from the ring straight into registers, every weight element
``round_bf16(e2m1 * (e4m3 * tensor_scale))`` bitwise as ``nvfp4.unpack``
gives it (two byte-table lookups per element).  bf16 x bf16 products are
exact in f32, each 64-k chunk's MMAs run into a zeroed fragment that an
f32 add promotes into the sum, and the output is rounded once: the
kernels differ from the plain versions only in the order of the f32 sum.
f32 x is split exactly into three bf16 parts, each multiplied on the
tensor cores.

Bound on the H100: at decode (M = 1..8) the weight bytes, 0.5625 B/param.
Up to ``TILE_M`` rows per group the kernel runs ``mma.sync`` with the
warps of a block on separate, fixed K ranges of the same rows, so even a
short N keeps thousands of warps' loads in flight.  Past it (prefill) the
operations: ``wgmma`` over 128- or 192-row x 64-token tiles, x brought
by TMA and read from shared memory in the permuted K order the decode
uses, which ``_kernel_x`` lays out (``_tile_order``, one copy of x).

Row invariance: every output element sums K in one order that depends on
Kp alone, at every M and in both forms (fixed K ranges, each summed from
zero, then added in order), so a token's output row does not depend on M
or on the other tokens; K3 runs K2's code with the group in the grid's z
dimension, so group g of K3 equals K2 on group g's slices bitwise.

K4 replaces ``nvfp4_matmul_tp``, which runs K2's Pallas body on each
shard's tile inside a ``shard_map`` and ``psum``s the row-parallel
partials outside any kernel.  So K4 is K2's CUDA kernel launched on this
rank's tile (``core.nvfp4.tp_tile``: N/n rows with the full K in column
mode, K/n whole blocks in row mode, contiguous) and, in row mode,
``torch.distributed``'s all-reduce of the f32 partials.  No device code of
its own: the tiles need none.
"""
from __future__ import annotations

import torch

from ..core import nvfp4
from ..core.nvfp4 import PackedNVFP4
from . import _build

# the reference kernel's default K tile (``tile_k``)
REF_TILE_K = 512


# the kernel's tile form (tensor-core wgmma) takes bf16 x at more than this
# many rows per group, in the chunk order of ``_tile_order``; the same
# threshold picks the form in ``csrc/nvfp4_matmul.cuh::dispatch``
TILE_M = 32


def _tile_order(x: torch.Tensor) -> torch.Tensor:
    """x [..., K], K a multiple of 64, with each 64-value chunk's 4-byte
    words reordered as the tile form's shared-memory layout wants them:
    word 8a + 2j + b (values 16a + 4j + 2b + {0, 1}) moves to 4 (2j + b) + a.
    A copy of x; the weights keep their layout."""
    *lead, k = x.shape
    v = x.reshape(*lead, k // 64, 4, 4, 2, 2)             # chunk, a, j, b, pair
    return v.movedim(-4, -2).reshape(*lead, k).contiguous()


def _kernel_x(x: torch.Tensor, kp: int) -> torch.Tensor:
    """x as the kernel reads it: contiguous and 16-byte aligned, its K a
    multiple of 8 with zero columns appended (the weight's columns there
    meet zeros; the stored K ``kp`` is a multiple of 16, so they exist).
    For the tile form (bf16, more than TILE_M rows per group) K is padded
    to whole 64-value chunks and put in ``_tile_order``."""
    rows = x.shape[-2]
    tile = x.dtype == torch.bfloat16 and rows > TILE_M
    to = -(-kp // 64) * 64 if tile else -(-x.shape[-1] // 8) * 8
    if x.shape[-1] != to:
        x = torch.nn.functional.pad(x, (0, to - x.shape[-1]))
    x = _tile_order(x) if tile else x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _check_packed(packed: PackedNVFP4, k: int) -> None:
    if packed.codes.ndim != 2:
        raise ValueError(f"nvfp4_matmul takes a 2-D packed weight, got "
                         f"codes {tuple(packed.codes.shape)}")
    if packed.k != k:
        raise ValueError(f"weight K {packed.k} != activation K {k}")


def plain(x: torch.Tensor, packed: PackedNVFP4,
          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: dequantize to bf16, f32 matmul (on the
    CPU, for a K of one reference tile, summing K in order,
    ``sum_k_f32``), round."""
    *lead, k = x.shape
    _check_packed(packed, k)
    w = nvfp4.unpack(packed, dtype=torch.bfloat16).to(torch.float32)  # [N, Kp]
    if packed.orig_k and packed.orig_k != w.shape[-1]:
        w = w[:, : packed.orig_k]
    xm = x.reshape(-1, k).to(torch.float32)
    if xm.device.type == "cpu" and packed.codes.shape[-1] * 2 <= REF_TILE_K:
        # within one K tile the reference kernel in interpret mode sums K
        # in order, as XLA's CPU dot does; a BLAS product's order changes
        # with the shape (a one- or two-row product runs another kernel).
        # Past one tile neither is the reference's order, and the K passes
        # of the in-order sum would only cost time
        y = sum_k_f32(xm[None], w[None])[0]
    else:
        y = xm @ w.T
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
    if codes.data_ptr() % 8:             # copied in 8-byte pieces
        raise ValueError("packed codes must be 8-byte aligned")
    ts = packed.tensor_scale.to(torch.float32).reshape(1)
    xm = _kernel_x(x.reshape(-1, k), kp)
    m = xm.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().nvfp4_matmul(
            xm.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
            scales.data_ptr(), ts.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), m, n, xm.shape[1], kp,
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


# ---------------------------------------------------------------------------
# grouped (K3)
# ---------------------------------------------------------------------------


def _check_grouped(x: torch.Tensor, packed: PackedNVFP4) -> None:
    if x.ndim != 3 or packed.codes.ndim != 3:
        raise ValueError(f"nvfp4_matmul_grouped takes x [G, M, K] and codes "
                         f"[G, N, K/2], got {tuple(x.shape)} and "
                         f"{tuple(packed.codes.shape)}")
    if packed.codes.shape[0] != x.shape[0]:
        raise ValueError(f"{x.shape[0]} groups of x, {packed.codes.shape[0]} "
                         "of the weight")
    if packed.k != x.shape[-1]:
        raise ValueError(f"weight K {packed.k} != activation K {x.shape[-1]}")
    if packed.tensor_scale.numel() not in (1, x.shape[0]):
        raise ValueError(f"tensor scale of {packed.tensor_scale.numel()} "
                         f"values for {x.shape[0]} groups")


def sum_k_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [G, M, K] times w [G, N, K] transposed, in f32, summed over K in
    ascending order from 0 (each product, then each sum, rounded to f32).

    The order in which XLA's CPU dot, and so the reference's Pallas kernel
    in interpret mode, sums within one K tile; a BLAS product sums in an
    order that changes with the shape.  K launches of a few ops each."""
    x, w = x.to(torch.float32), w.to(torch.float32)
    acc = torch.zeros((x.shape[0], x.shape[1], w.shape[1]),
                      dtype=torch.float32, device=x.device)
    for kk in range(x.shape[-1]):
        acc = acc + x[:, :, kk, None] * w[:, None, :, kk]
    return acc


def plain_grouped(x: torch.Tensor, packed: PackedNVFP4,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of K3: per group, dequantize to bf16, multiply in
    f32 summing K in order (``sum_k_f32``), round.  x [G, M, K] ->
    [G, M, N]."""
    _check_grouped(x, packed)
    w = nvfp4.unpack(packed, dtype=torch.bfloat16)             # [G, N, Kp]
    if packed.orig_k and packed.orig_k != w.shape[-1]:
        w = w[..., : packed.orig_k]
    return sum_k_f32(x, w).to(out_dtype)


def launch_grouped(x: torch.Tensor, packed: PackedNVFP4,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Run K3; x [G, M, K] bf16 or f32 -> [G, M, N] bf16 or f32."""
    if not x.is_cuda:
        raise ValueError(f"nvfp4_matmul_grouped kernel needs a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nvfp4_matmul_grouped takes bf16 or f32 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nvfp4_matmul_grouped writes bf16 or f32, got {out_dtype}")
    _check_grouped(x, packed)
    codes, scales = packed.codes, packed.scales
    g, n, kh = codes.shape
    kp = kh * 2
    if (codes.dtype != torch.uint8 or scales.dtype != nvfp4.FP8_E4M3
            or scales.shape != (g, n, kp // nvfp4.BLOCK) or kp % nvfp4.BLOCK):
        raise ValueError("packed stack is not in the [G, N, K/2] uint8 + "
                         "[G, N, K/16] e4m3 layout")
    if not (codes.is_cuda and scales.is_cuda and packed.tensor_scale.is_cuda):
        raise ValueError("packed weight must lie on the card")
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed codes and scales must be contiguous")
    if codes.data_ptr() % 8:             # copied in 8-byte pieces
        raise ValueError("packed codes must be 8-byte aligned")
    ts = packed.tensor_scale.to(torch.float32).reshape(-1).contiguous()
    xg = _kernel_x(x, kp)
    m, k = xg.shape[1], xg.shape[2]
    out = torch.empty((g, m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().nvfp4_matmul_grouped(
            xg.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
            scales.data_ptr(), ts.data_ptr(), int(ts.numel() > 1),
            out.data_ptr(), int(out_dtype == torch.float32), g, m, n, k, kp,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nvfp4_matmul_grouped")
    return out


def bytes_moved_grouped(x: torch.Tensor, packed: PackedNVFP4, out_dtype) -> int:
    """x read once, the whole packed stack read once, y written once."""
    g, m, _ = x.shape
    n = packed.codes.shape[1]
    return (x.numel() * x.element_size() + packed.nbytes
            + g * m * n * torch.empty((), dtype=out_dtype).element_size())


def flops_grouped(x: torch.Tensor, packed: PackedNVFP4) -> int:
    g, m, k = x.shape
    return 2 * g * m * packed.codes.shape[1] * k


# ---------------------------------------------------------------------------
# tensor parallel (K4)
# ---------------------------------------------------------------------------


def _tp(gemm, x: torch.Tensor, tile: PackedNVFP4, tp, parallelism: str,
        out_dtype) -> torch.Tensor:
    """K4 around a K2 ``gemm`` (the kernel's launch or its plain version):
    column, ``y_local = gemm(x, tile)``; row, the f32 partial over this
    rank's whole-block K slice, summed over the group, then cast."""
    if parallelism == "column":
        return gemm(x, tile, out_dtype)
    if parallelism == "row":
        return tp.all_reduce(gemm(x, tile, torch.float32)).to(out_dtype)
    raise ValueError(f"unknown parallelism {parallelism!r}")


def plain_tp(x: torch.Tensor, tile: PackedNVFP4, tp, parallelism: str,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of K4: K2's plain version on the rank's tile."""
    return _tp(plain, x, tile, tp, parallelism, out_dtype)


def launch_tp(x: torch.Tensor, tile: PackedNVFP4, tp, parallelism: str,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """K4 on the card: K2's CUDA kernel on the rank's tile, then (row
    mode) the group's all-reduce of the f32 partials."""
    return _tp(launch, x, tile, tp, parallelism, out_dtype)
