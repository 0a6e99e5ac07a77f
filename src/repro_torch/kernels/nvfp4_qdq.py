"""NVFP4 fake quantization: CUDA kernel for Hopper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/nvfp4_qdq.py::nvfp4_qdq``
(body ``_qdq_kernel``).  The kernel (``csrc/nvfp4_qdq.cu``) computes the
activation QDQ of the reference's serving forward bitwise: the order of
operations of ``core/nvfp4.py::qdq`` (the amax is clamped before the tensor
scale is formed), with the two divisions by constants taken as
multiplications by their f32 reciprocals, as XLA compiles them inside the
reference's jitted forward (``nvfp4.qdq(..., reciprocal=True)``), IEEE
division elsewhere and round-half-to-even.

The amax has a scope (``QuantConfig.act_scope``): one over the whole
tensor (``"tensor"``), one per leading-axis element (``"row"``), one per
last-dim vector (``"token"``), or it is the caller's (``tensor_amax``:
under tensor parallelism, and for calibrated scales).  The kernel takes
its own amax in the same launch, so one QDQ is one device kernel.

Bound on the H100: bytes.  One read of x and one write of the output at a
few flops per byte.  ``plan`` picks how the amax is reduced: inside one
thread block, across a thread-block cluster, or in a cooperative grid that
reads x twice (segments over 32768 values); see the kernel's source.
"""
from __future__ import annotations

import math

import torch

from ..core import nvfp4
from . import _build

SCOPES = ("tensor", "row", "token")
THREADS = 256            # threads per block, one 16-value block each
MAX_CLUSTER = 8          # blocks per cluster (the portable limit)
CHUNK_BLOCKS = 1024      # 16-value blocks per work item of the two-pass mode
MODES = {"external": 0, "local": 1, "cluster": 2, "two_pass": 3}


def scope_amax(x: torch.Tensor, scope: str) -> torch.Tensor:
    """The scope's amax taken with torch ops, keepdim (a 0-d tensor for
    the tensor scope)."""
    if scope not in SCOPES:
        raise ValueError(f"unknown amax scope {scope!r}")
    xa = torch.abs(x.to(torch.float32))
    if scope == "tensor":
        return torch.amax(xa)
    return torch.amax(xa, dim=tuple(range(1, x.ndim)) if scope == "row" else -1,
                      keepdim=True)


def plain(x: torch.Tensor, tensor_amax: torch.Tensor | None = None,
          scope: str = "tensor") -> torch.Tensor:
    """The plain PyTorch version: ``core.nvfp4.qdq`` in its jitted form,
    the amax the caller's or the scope's."""
    if tensor_amax is None:
        tensor_amax = scope_amax(x, scope)
    return nvfp4.qdq(x, tensor_amax, reciprocal=True)


def segment(shape, scope: str) -> int:
    """Values per amax of a tensor of ``shape`` under ``scope``."""
    numel = math.prod(shape)
    if scope == "tensor":
        return numel
    if scope == "row":
        if len(shape) < 2:
            raise ValueError(f"row scope needs a leading axis, got {tuple(shape)}")
        return numel // shape[0]
    if scope == "token":
        return shape[-1]
    raise ValueError(f"unknown amax scope {scope!r}")


def plan(n_blocks: int, seg_blocks: int, external: bool) -> tuple[str, int]:
    """(mode, workspace slots) of one launch over ``n_blocks`` 16-value
    blocks in amax segments of ``seg_blocks``: the caller's amax; a
    segment within one thread block; within one cluster; or the two-pass
    cooperative grid, one 32-bit workspace slot per work item."""
    if external:
        return "external", 0
    if seg_blocks <= THREADS:
        return "local", 0
    if seg_blocks <= THREADS * MAX_CLUSTER:
        return "cluster", 0
    return "two_pass", n_blocks // seg_blocks * -(-seg_blocks // CHUNK_BLOCKS)


def _external(amax: torch.Tensor, shape) -> tuple[torch.Tensor, int]:
    """(one f32 per segment, values per segment) for a caller's amax: one
    value, or one per index of a leading prefix of ``shape`` (as a keepdim
    amax over the trailing axes is); any other broadcastable shape is
    expanded to one value per last-dim vector."""
    a = amax.float()
    if a.numel() == 1:
        return a.reshape(1), math.prod(shape)
    nd = len(shape)
    full = (1,) * (nd - a.ndim) + tuple(a.shape)
    if full[-1] != 1:
        raise ValueError(f"amax shape {tuple(amax.shape)} varies along the "
                         "blocked dim")
    for j in range(1, nd):
        if full == tuple(shape[:j]) + (1,) * (nd - j):
            return a.reshape(-1).contiguous(), math.prod(shape[j:])
    return (torch.broadcast_to(a.reshape(full), (*shape[:-1], 1))
            .reshape(-1).contiguous(), shape[-1])


def launch(x: torch.Tensor, tensor_amax: torch.Tensor | None = None,
           scope: str = "tensor") -> torch.Tensor:
    """Run the CUDA kernel on ``x`` [..., K] (bf16 or f32, K % 16 == 0).

    ``tensor_amax``: None (the kernel takes the ``scope``'s amax), a
    size-1 tensor, or a keepdim amax over trailing axes of x (one value per
    row, per token, ...)."""
    if not x.is_cuda:
        raise ValueError(f"nvfp4_qdq kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nvfp4_qdq takes bf16 or f32, got {x.dtype}")
    k = x.shape[-1]
    if k % nvfp4.BLOCK:
        raise ValueError(f"last dim {k} is not a multiple of {nvfp4.BLOCK}")
    x = x.contiguous()                   # a misaligned view stays as it is
    n_blocks = x.numel() // nvfp4.BLOCK
    if n_blocks == 0:
        return torch.empty_like(x)
    amax = None
    if tensor_amax is not None:
        amax, seg = _external(tensor_amax.to(x.device), x.shape)
    else:
        seg = segment(x.shape, scope)
    seg_blocks = max(seg // nvfp4.BLOCK, 1)
    mode, slots = plan(n_blocks, seg_blocks, amax is not None)
    ws = torch.empty(slots, dtype=torch.int32, device=x.device) if slots else None
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().nvfp4_qdq(
            x.data_ptr(), int(x.dtype == torch.float32),
            None if amax is None else amax.data_ptr(), MODES[mode], n_blocks,
            seg_blocks, CHUNK_BLOCKS, None if ws is None else ws.data_ptr(),
            slots, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nvfp4_qdq")
    return out


def bytes_moved(x: torch.Tensor) -> int:
    """Bytes the function must move: x read once, the output written once."""
    return 2 * x.numel() * x.element_size()


# per element: abs + max (amax), divide, clip, round, sign, two multiplies
OPS_PER_ELEM = 8
