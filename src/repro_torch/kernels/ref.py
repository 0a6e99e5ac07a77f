"""Plain PyTorch versions of the kernels, under the reference's names
(``repro.kernels.ref``).  Each lives beside its kernel; the tests and
``chip_smoke.py`` hold the kernels against them."""
from __future__ import annotations

from .nvfp4_matmul import plain as nvfp4_matmul_ref
from .nvfp4_qdq import plain as nvfp4_qdq_ref

__all__ = ["nvfp4_qdq_ref", "nvfp4_matmul_ref"]
