"""Shared building blocks (port of ``repro.models.layers``).

Every GEMM routes through ``qeinsum`` / ``qdense``, the single NVFP4
injection point: the activation is fake-quantized along its last dim by
``QuantConfig.q_act`` (the ``nvfp4_qdq`` kernel on the card), and the
weight is a dense tensor or a ``PackedNVFP4``.  A 2-D packed weight goes
to the ``nvfp4_matmul`` kernel; other packed weights are dequantized and
multiplied; dense weights are multiplied as they are.

Tensor parallelism (the reference's ``cst`` constraints and the mesh
dispatch) and MoE are later slices of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.nvfp4 import PackedNVFP4
from ..core.qconfig import QuantConfig
from ..kernels import ops

_DENSE_EQ = "...k,ko->...o"


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype (what ``jnp.einsum`` returns)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def qeinsum(qcfg: QuantConfig, kind: str, eq: str, x: torch.Tensor, w,
            contract_axis: int = 0, quantize_act: bool = True,
            parallelism: str | None = None) -> torch.Tensor:
    """``einsum(eq, q_act(x), resolve(w))`` for the dense equation."""
    if eq != _DENSE_EQ:
        raise NotImplementedError(f"einsum {eq!r}: MoE expert GEMMs are part "
                                  "of the MoE slice of the port")
    xq = qcfg.q_act(x, kind) if quantize_act else x
    wr = qcfg.resolve_weight(w, kind, contract_axis)
    if isinstance(wr, PackedNVFP4):
        if (wr.ndim == 2 and contract_axis == 0
                and qcfg.packed_backend in ("auto", "grouped")):
            return ops.nvfp4_matmul(xq, wr, out_dtype=xq.dtype)
        return _matmul(xq, ops.dequant_weight(wr, contract_axis, xq.dtype))
    return _matmul(xq, wr)


def qdense(qcfg: QuantConfig, kind: str, x: torch.Tensor, w,
           b: torch.Tensor | None = None, contract_axis: int = 0,
           quantize_act: bool = True,
           parallelism: str | None = None) -> torch.Tensor:
    """y = x @ w (+ b) with NVFP4 fake-quant per the policy; ``w`` [in, out]
    dense or packed."""
    if w.ndim != 2 or contract_axis != 0:
        raise NotImplementedError(f"weight rank/contract_axis {w.ndim}/"
                                  f"{contract_axis}: MoE expert weights are "
                                  "part of the MoE slice of the port")
    y = qeinsum(qcfg, kind, _DENSE_EQ, x, w, 0, quantize_act, parallelism)
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# norms (computed in fp32)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor | None, b: torch.Tensor | None,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(cfg, x, w=None, b=None):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, w)
    if cfg.norm == "layernorm":
        return layernorm(x, w, b)
    if cfg.norm == "layernorm_np":          # OLMo: non-parametric LN
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; pos: broadcastable to [..., S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = pos[..., None].to(torch.float32) * freqs          # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1 = x[..., : hd // 2].to(torch.float32)
    xf2 = x[..., hd // 2:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x * 1 / (exp(-x) + 1), each step
    rounded to x's dtype (for bf16, four roundings where ``F.silu`` has
    one)."""
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def swiglu_mlp(qcfg, x, wg, wu, wd, kind: str = "mlp"):
    g = qdense(qcfg, kind, x, wg, parallelism="column")
    u = qdense(qcfg, kind, x, wu, parallelism="column")
    return qdense(qcfg, kind, silu(g) * u, wd, parallelism="row")


def gelu_mlp(qcfg, x, wi, wd, bi=None, bd=None, kind: str = "mlp"):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(qdense(qcfg, kind, x, wi, bi, parallelism="column"),
               approximate="tanh")
    return qdense(qcfg, kind, h, wd, bd, parallelism="row")
