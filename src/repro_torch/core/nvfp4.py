"""NVFP4 quantization algebra (port of ``repro.core.nvfp4``).

NVFP4 is a 4-bit floating-point format: E2M1 values in blocks of 16 along
the contraction (last) dim, with a two-level scale, an E4M3 scale per block
times an f32 scale per tensor:

  s_tensor = amax(|x|) / (448 * 6)
  s_block  = cast_e4m3( amax_block(|x|) / 6 / s_tensor )
  q        = cast_e2m1( x / (s_block * s_tensor) )
  dq       = q * s_block * s_tensor

These are the plain PyTorch versions.  They repeat the reference's order of
operations exactly (``torch.round`` is round-half-to-even like
``jnp.round``; ``torch.float8_e4m3fn`` rounds to nearest even), so every
function here is bitwise equal to its JAX counterpart.  The CUDA kernel
``kernels/csrc/nvfp4_qdq.cu`` computes ``qdq`` on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 16                      # NVFP4 block size
E2M1_MAX = 6.0                  # max magnitude representable in E2M1
E4M3_MAX = 448.0                # max magnitude representable in E4M3 (fn)
FP8_E4M3 = torch.float8_e4m3fn

# f32-rounded reciprocals of the two scale divisors (see compute_scales)
INV_E2M1_MAX = float(np.float32(1.0) / np.float32(E2M1_MAX))
INV_TENSOR_RANGE = float(np.float32(1.0) / np.float32(E4M3_MAX * E2M1_MAX))

# bytes per NVFP4 element: 4-bit code + one E4M3 scale per 16 elements
BYTES_PER_ELEM = 0.5 + 1.0 / BLOCK


def _sign(y: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, 1, or the (signed) zero itself."""
    return torch.where(y == 0, y, torch.sign(y))


def e2m1_round(a: torch.Tensor) -> torch.Tensor:
    """Round magnitudes in [0, 6] to the E2M1 grid {0,.5,1,1.5,2,3,4,6}, RNE."""
    return torch.where(
        a <= 2.0,
        torch.round(a * 2.0) * 0.5,
        torch.where(a <= 4.0, torch.round(a), torch.round(a * 0.5) * 2.0),
    )


def e2m1_quantize(y: torch.Tensor) -> torch.Tensor:
    """Quantize scaled values to the E2M1 grid (magnitudes clipped at 6)."""
    a = torch.clamp(torch.abs(y), 0.0, E2M1_MAX)
    return _sign(y) * e2m1_round(a)


def e4m3_quantize(s: torch.Tensor) -> torch.Tensor:
    """Round positive scales to E4M3, clamped to [2^-6, 448]; returns f32."""
    s = torch.clamp(s, 2.0 ** -6, E4M3_MAX)
    return s.to(FP8_E4M3).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class NVFP4Scales:
    """The two-level scale pair for a blocked tensor."""
    block: torch.Tensor    # f32, exactly-E4M3 values, [..., K // 16]
    tensor: torch.Tensor   # f32, scalar or broadcastable to ``block``


def compute_scales(x: torch.Tensor, tensor_amax: torch.Tensor | None = None,
                   *, reciprocal: bool = False) -> NVFP4Scales:
    """Two-level scales for ``x`` blocked along its last axis.

    ``tensor_amax`` (broadcastable to the block amaxes) overrides the
    whole-tensor amax, as calibration or per-row scopes do.

    ``reciprocal=True`` computes the two divisions by constants (by 6 and by
    448 * 6) as multiplications by their f32-rounded reciprocals.  That is
    what the reference computes inside ``jax.jit``: XLA rewrites a division
    by a constant so in every jitted forward, i.e. for every activation the
    reference's serving path quantizes.  Called eagerly (its PTQ), the
    reference divides.
    """
    xf = x.to(torch.float32)
    *lead, k = xf.shape
    xb = torch.abs(xf).reshape(*lead, k // BLOCK, BLOCK)
    block_amax = torch.amax(xb, dim=-1)
    if tensor_amax is None:
        tensor_amax = torch.amax(block_amax)
    amax = torch.clamp_min(tensor_amax.to(torch.float32), 1e-30)
    if reciprocal:
        s_tensor = amax * INV_TENSOR_RANGE
        s_block = e4m3_quantize(block_amax * INV_E2M1_MAX / s_tensor)
    else:
        s_tensor = amax / (E4M3_MAX * E2M1_MAX)
        s_block = e4m3_quantize(block_amax / E2M1_MAX / s_tensor)
    return NVFP4Scales(block=s_block, tensor=s_tensor)


def quantize_blocked(x: torch.Tensor, scales: NVFP4Scales) -> torch.Tensor:
    """E2M1-quantize ``x`` given scales; f32 grid values [..., K//16, 16]."""
    xf = x.to(torch.float32)
    *lead, k = xf.shape
    xb = xf.reshape(*lead, k // BLOCK, BLOCK)
    s = (scales.block * scales.tensor)[..., None]
    y = xb / torch.clamp_min(s, 1e-30)
    return e2m1_quantize(y)


def qdq(x: torch.Tensor, tensor_amax: torch.Tensor | None = None,
        *, reciprocal: bool = False) -> torch.Tensor:
    """Fake-quantize: quantize to NVFP4 and dequantize back to ``x.dtype``.
    ``reciprocal``: see ``compute_scales``."""
    scales = compute_scales(x, tensor_amax, reciprocal=reciprocal)
    q = quantize_blocked(x, scales)
    s = (scales.block * scales.tensor)[..., None]
    return (q * s).reshape(x.shape).to(x.dtype)


class _FakeQuant(torch.autograd.Function):
    """``qdq`` forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x):
        return qdq(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _FakeQuantCalibrated(torch.autograd.Function):
    """``qdq`` with a given tensor amax; straight-through for ``x``, zero
    gradient for the amax."""

    @staticmethod
    def forward(ctx, x, tensor_amax):
        ctx.amax_shape = tensor_amax.shape
        return qdq(x, tensor_amax)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.amax_shape, dtype=g.dtype, device=g.device)


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """QDQ with a straight-through estimator (gradients pass through)."""
    return _FakeQuant.apply(x)


def fake_quant_calibrated(x: torch.Tensor,
                          tensor_amax: torch.Tensor) -> torch.Tensor:
    """STE QDQ with a calibration-provided tensor amax."""
    return _FakeQuantCalibrated.apply(x, tensor_amax)


# ---------------------------------------------------------------------------
# Packed representation: the deployment format, 0.5625 B/param.
# ---------------------------------------------------------------------------


def _nibble_to_f32(n: torch.Tensor) -> torch.Tensor:
    """E2M1 nibble -> f32: sign = n>>3, exp = (n>>1)&3, man = n&1."""
    sign = 1.0 - 2.0 * (n >> 3).to(torch.float32)
    exp = ((n >> 1) & 3).to(torch.float32)
    man = (n & 1).to(torch.float32)
    mag = torch.where(exp == 0, man * 0.5,
                      (1.0 + 0.5 * man) * torch.exp2(exp - 1.0))
    return sign * mag


def _f32_to_nibble(q: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_nibble_to_f32`` for values already on the E2M1 grid."""
    sign = (q < 0).to(torch.uint8) << 3
    a = torch.abs(q)
    code = torch.where(a <= 2.0, torch.round(a * 2.0),
                       torch.where(a <= 4.0, torch.round(a) + 2.0,
                                   torch.full_like(a, 7.0))).to(torch.uint8)
    return sign | code


@dataclasses.dataclass(frozen=True)
class PackedNVFP4:
    """A tensor in true NVFP4 memory layout, packed along its LAST axis.

    ``codes``  uint8 [..., K//2]: two E2M1 nibbles per byte (even index low)
    ``scales`` float8_e4m3fn [..., K//16]: one scale per block
    ``tensor_scale`` f32: scalar, or [*lead, 1, ..., 1] when leading
        (layer-stack) axes carry a scale per slice
    ``orig_k`` the un-padded logical K (0: the stored K)
    """
    codes: torch.Tensor
    scales: torch.Tensor
    tensor_scale: torch.Tensor
    orig_k: int = 0

    @property
    def k(self) -> int:
        return self.orig_k or self.codes.shape[-1] * 2

    @property
    def shape(self) -> tuple:
        return (*self.codes.shape[:-1], self.k)

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size()
                + self.tensor_scale.numel() * 4)

    def __getitem__(self, i: int) -> "PackedNVFP4":
        """Slice along the leading (layer-stack) axis, keeping ``orig_k``."""
        return PackedNVFP4(self.codes[i], self.scales[i],
                           self.tensor_scale[i], self.orig_k)


def pack(x: torch.Tensor, n_lead: int = 0) -> PackedNVFP4:
    """Quantize ``x`` to the packed NVFP4 layout.

    ``n_lead`` leading (layer-stack) axes each get their own tensor scale.
    """
    tensor_amax = None
    if n_lead:
        tensor_amax = torch.amax(torch.abs(x.to(torch.float32)),
                                 dim=tuple(range(n_lead, x.ndim)), keepdim=True)
    scales = compute_scales(x, tensor_amax)
    q = quantize_blocked(x, scales)
    *lead, k = x.shape
    nib = _f32_to_nibble(q).reshape(*lead, k)
    lo, hi = nib[..., 0::2], nib[..., 1::2]
    # contiguous: ``x`` may be a transposed view, and the kernel reads
    # codes and scales row by row
    return PackedNVFP4(
        codes=(lo | (hi << 4)).to(torch.uint8).contiguous(),
        scales=scales.block.to(FP8_E4M3).contiguous(),
        tensor_scale=scales.tensor,
        orig_k=k,
    )


def unpack(p: PackedNVFP4, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize a packed tensor to ``dtype``, full (padded) K."""
    codes = p.codes
    lo = _nibble_to_f32(codes & 0xF)
    hi = _nibble_to_f32(codes >> 4)
    *lead, kh = codes.shape
    vals = torch.stack([lo, hi], dim=-1).reshape(*lead, kh * 2)
    vb = vals.reshape(*lead, kh * 2 // BLOCK, BLOCK)
    s = (p.scales.to(torch.float32) * p.tensor_scale)[..., None]
    return (vb * s).reshape(*lead, kh * 2).to(dtype)


def unpack_layout(p: PackedNVFP4, contract_axis: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize to the ORIGINAL weight layout: strip the K padding and
    move the packed axis back to ``contract_axis``."""
    w = unpack(p, dtype)
    if p.orig_k and p.orig_k != w.shape[-1]:
        w = w[..., : p.orig_k]
    return torch.movedim(w, -1, contract_axis % w.ndim)


# ---------------------------------------------------------------------------
# tensor parallelism: which tiles a packed weight admits, and rank r's tile
# ---------------------------------------------------------------------------


def tp_shard_mode(p: PackedNVFP4, n_shards: int,
                  parallelism: str | None) -> str | None:
    """Which tensor-parallel layout a 2-D packed weight admits at
    ``n_shards`` (the reference's rule, ``repro.core.nvfp4.tp_shard_mode``).

    ``"column"``: the codes' and scales' rows (the output dim N) split
    ``n_shards`` ways; every shard contracts the full K, so each output
    element is what the unsharded GEMM gives.  ``"row"``: the packed K dim
    splits in whole 16-element blocks with no K padding; the shards' f32
    partial products are summed across the group.  ``None``: not
    shardable this way; the weight stays replicated.
    """
    if n_shards <= 1 or p.ndim != 2 or parallelism not in ("column", "row"):
        return None
    n, kh = p.codes.shape
    if parallelism == "column":
        return "column" if n % n_shards == 0 else None
    return "row" if row_splits(p.k, kh * 2, n_shards) else None


def row_splits(k: int, kp: int, n_shards: int) -> bool:
    """Does a packed K (logical ``k``, stored ``kp``) split ``n_shards``
    ways in whole 16-element blocks: no K padding, and the code bytes
    (K/2) and the block scales (K/16) both divide."""
    return k == kp and (kp // 2) % n_shards == 0 and (kp // BLOCK) % n_shards == 0


def tp_tile(p: PackedNVFP4, mode: str, rank: int, n_shards: int,
            rows: torch.Tensor | None = None) -> PackedNVFP4:
    """Rank ``rank``'s tile of a packed weight (leading layer-stack axes
    kept), as contiguous copies: the kernel reads codes row by row in
    8-byte words.

    ``"column"`` takes rows [r N/n, (r+1) N/n) of codes and scales (after
    reordering them by ``rows``, if given); ``"row"`` takes K's whole
    blocks [r K/n, (r+1) K/n), so a tile row holds K/(2n) code bytes (a
    multiple of 8) and K/(16n) scales, and ``orig_k`` becomes K/n.  The
    tensor scale is the global one, unchanged.
    """
    codes, scales = p.codes, p.scales
    if mode == "column":
        if rows is not None:
            codes, scales = codes[..., rows, :], scales[..., rows, :]
        n = codes.shape[-2] // n_shards
        sl = slice(rank * n, (rank + 1) * n)
        return PackedNVFP4(codes[..., sl, :].contiguous(),
                           scales[..., sl, :].contiguous(),
                           p.tensor_scale.clone(), p.orig_k)
    if mode == "row":
        kh, kb = codes.shape[-1] // n_shards, scales.shape[-1] // n_shards
        return PackedNVFP4(codes[..., rank * kh:(rank + 1) * kh].contiguous(),
                           scales[..., rank * kb:(rank + 1) * kb].contiguous(),
                           p.tensor_scale.clone(), p.k // n_shards)
    raise ValueError(f"unknown tensor-parallel mode {mode!r}")


# ---------------------------------------------------------------------------
# FP8 KV-cache quantization (reference lines 323-341; paper §3.4: Nemotron 3
# Nano quantizes its KV to FP8).
# ---------------------------------------------------------------------------

# f32-rounded 1/448: the jitted reference multiplies the amax by it (XLA
# turns ``amax / 448`` into that product, as it does ``/ 6`` above); the
# values' division by the scale stays a true division
INV_E4M3_MAX = float(np.float32(1.0) / np.float32(E4M3_MAX))


@dataclasses.dataclass
class FP8Tensor:
    values: torch.Tensor     # float8_e4m3fn
    scale: torch.Tensor      # f32, broadcastable to values


def fp8_quantize(x: torch.Tensor, dim: int = -1) -> FP8Tensor:
    """Symmetric FP8 quantization with one f32 scale per slice along
    ``dim``: scale = max(amax, 1e-30) * f32(1/448), values = E4M3(x /
    scale), rounded to nearest even.  |x / scale| is at most the slice's
    amax over its scale, within an ulp of 448 and far below the cast's
    overflow at 464, so no value saturates; bitwise the jitted reference."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) * INV_E4M3_MAX
    return FP8Tensor(values=(xf / scale).to(FP8_E4M3), scale=scale)


def fp8_dequantize(t: FP8Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.values.to(torch.float32) * t.scale).to(dtype)
