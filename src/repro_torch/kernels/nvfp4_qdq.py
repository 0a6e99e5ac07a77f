"""NVFP4 fake quantization: CUDA kernel for Hopper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/nvfp4_qdq.py::nvfp4_qdq``
(body ``_qdq_kernel``).  The kernel (``csrc/nvfp4_qdq.cu``) computes the
activation QDQ of the reference's serving forward bitwise: the order of
operations of ``core/nvfp4.py::qdq`` (the amax is clamped before the tensor
scale is formed), with the two divisions by constants taken as
multiplications by their f32 reciprocals, as XLA compiles them inside the
reference's jitted forward (``nvfp4.qdq(..., reciprocal=True)``), IEEE
division elsewhere and round-half-to-even.

Bound on the H100: bytes.  One read of x and one write of the output at a
few flops per byte; the design keeps each 16-element block in one thread's
registers so the pass touches memory once.  The tensor amax is a torch
reduction before the launch, as the JAX wrapper takes it with ``jnp.max``.
"""
from __future__ import annotations

import torch

from ..core import nvfp4
from . import _build


def plain(x: torch.Tensor, tensor_amax: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: ``core.nvfp4.qdq`` in its jitted form."""
    return nvfp4.qdq(x, tensor_amax, reciprocal=True)


def launch(x: torch.Tensor, tensor_amax: torch.Tensor | None = None) -> torch.Tensor:
    """Run the CUDA kernel on ``x`` [..., K] (bf16 or f32, K % 16 == 0).

    ``tensor_amax``: None (one amax over x), a size-1 tensor, or one value
    per row of x (shape [..., 1] broadcastable to x's leading dims).
    """
    if not x.is_cuda:
        raise ValueError(f"nvfp4_qdq kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nvfp4_qdq takes bf16 or f32, got {x.dtype}")
    k = x.shape[-1]
    if k % nvfp4.BLOCK:
        raise ValueError(f"last dim {k} is not a multiple of {nvfp4.BLOCK}")
    xm = x.reshape(-1, k).contiguous()
    if xm.data_ptr() % 16:               # the kernel loads 16-byte vectors
        xm = xm.clone()
    rows = xm.shape[0]
    if tensor_amax is None:
        amax = torch.linalg.vector_norm(xm, ord=float("inf")).float().reshape(1)
        stride = 0
    elif tensor_amax.numel() == 1:
        amax = tensor_amax.float().reshape(1)
        stride = 0
    else:
        if tensor_amax.shape[-1] != 1:
            raise ValueError(f"amax shape {tuple(tensor_amax.shape)} varies "
                             "along the blocked dim")
        amax = torch.broadcast_to(tensor_amax.float(), (*x.shape[:-1], 1)
                                  ).reshape(rows).contiguous()
        stride = 1
    out = torch.empty_like(xm)
    with torch.cuda.device(x.device):
        err = _build.library().nvfp4_qdq(
            xm.data_ptr(), int(x.dtype == torch.float32), amax.data_ptr(),
            stride, out.data_ptr(), rows, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nvfp4_qdq")
    return out.reshape(x.shape)


def bytes_moved(x: torch.Tensor) -> int:
    """Bytes the function must move: x read once, the output written once."""
    return 2 * x.numel() * x.element_size()


# per element: abs + max (amax), divide, clip, round, sign, two multiplies
OPS_PER_ELEM = 8
