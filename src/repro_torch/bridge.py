"""Parameters from a reference tree given as numpy arrays.

``params_from_numpy`` takes a parameter tree of the JAX package whose
leaves the caller has already turned into numpy: float leaves as f32
(bf16 and e4m3 values convert to f32 exactly), integer leaves as they are,
and each ``PackedNVFP4`` as a dict ``{"codes": uint8, "scales": f32 of
e4m3 values, "tensor_scale": f32, "orig_k": int}``.  It returns the port's
tree: float leaves in ``dtype`` (exact for values that were bf16), packed
weights as ``PackedNVFP4`` with e4m3 scales (exact) and f32 tensor scales.

``state_from_numpy`` carries a reference ``TrainState`` across the same
way (step, student, teacher, AdamW ``m`` and ``v``), and ``to_numpy`` goes
back: any tree of the port's to numpy, float leaves as f32.  The package
itself never sees ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.nvfp4 import FP8_E4M3, PackedNVFP4
from .core.qad import TrainState
from .optim.adamw import AdamWState

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


def state_from_numpy(state: dict, device, param_dtype=torch.bfloat16,
                     state_dtype=torch.float32) -> TrainState:
    """A reference ``TrainState`` given as numpy, ``{"step", "student",
    "teacher", "opt_state": {"m", "v"}}`` (``teacher`` may be None), as
    the port's ``TrainState``: parameters in ``param_dtype``, moments in
    ``state_dtype``, the step an int32 tensor."""
    device = torch.device(device)
    teacher = state.get("teacher")
    return TrainState(
        step=torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                          device=device),
        student=params_from_numpy(state["student"], device, param_dtype),
        teacher=(None if teacher is None
                 else params_from_numpy(teacher, device, param_dtype)),
        opt_state=AdamWState(
            m=params_from_numpy(state["opt_state"]["m"], device, state_dtype),
            v=params_from_numpy(state["opt_state"]["v"], device, state_dtype)))


def to_numpy(tree):
    """A port tree as numpy: float tensors as f32 (exact for bf16 and
    fp8), other tensors as they are; dicts stay dicts, ``NamedTuple``s
    become dicts of their fields, ``PackedNVFP4`` the dict of
    ``params_from_numpy``."""
    if tree is None:
        return None
    if isinstance(tree, PackedNVFP4):
        return {"codes": to_numpy(tree.codes), "scales": to_numpy(tree.scales),
                "tensor_scale": to_numpy(tree.tensor_scale),
                "orig_k": tree.orig_k}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_numpy(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.to(torch.float32) if t.is_floating_point() else t).numpy()
