"""Parameters from a reference tree given as numpy arrays.

``params_from_numpy`` takes a parameter tree of the JAX package whose
leaves the caller has already turned into numpy: float leaves as f32
(bf16 and e4m3 values convert to f32 exactly), integer leaves as they are,
and each ``PackedNVFP4`` as a dict ``{"codes": uint8, "scales": f32 of
e4m3 values, "tensor_scale": f32, "orig_k": int}``.  It returns the port's
tree: float leaves in ``dtype`` (exact for values that were bf16), packed
weights as ``PackedNVFP4`` with e4m3 scales (exact) and f32 tensor scales.
The package itself never sees ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.nvfp4 import FP8_E4M3, PackedNVFP4

_PACKED_KEYS = {"codes", "scales", "tensor_scale", "orig_k"}


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                        dtype=dtype)


def params_from_numpy(tree, device, dtype=torch.bfloat16):
    """Convert a numpy parameter tree (see the module docstring)."""
    device = torch.device(device)
    if isinstance(tree, dict) and set(tree) == _PACKED_KEYS:
        return PackedNVFP4(
            codes=_tensor(tree["codes"], torch.uint8, device),
            scales=_tensor(tree["scales"], torch.float32, device).to(FP8_E4M3),
            tensor_scale=_tensor(tree["tensor_scale"], torch.float32, device),
            orig_k=int(tree["orig_k"]))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        return _tensor(a.astype(np.float32), dtype, device)
    return torch.from_numpy(np.array(a, order="C")).to(device)
