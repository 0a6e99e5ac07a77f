"""One-shot weight PTQ (port of ``repro.core.ptq``, lines 77-141).

``quantize_weights`` fake-quantizes (``weight_format="qdq"``) or packs to
true 4-bit NVFP4 (``"packed"``) every GEMM weight the policy quantizes.
Leading layer-stack axes get one tensor scale per slice, as in the
reference, and the port quantizes a stacked weight one slice at a time: a
slice's scale is its own amax either way, so the codes are identical, and
no f32 temporary of the whole stack is made (packing all 28 slices of a
[28, 3584, 18944] weight at once would need several 7.6 GB temporaries).
So the reference's ``_lead_amax`` has no counterpart: each slice's amax
is taken where the slice is quantized.

Activation calibration waits for a later slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import nvfp4
from .qconfig import QuantConfig


def quantize_weights(params, specs, qcfg: QuantConfig):
    """One-shot PTQ of a parameter tree (nested dicts of tensors).

    ``specs`` mirrors ``params`` with ``ParamSpec`` leaves carrying the GEMM
    ``kind`` and ``contract_axis``.  Returns a new tree; unquantized leaves
    are shared with ``params``.
    """
    def one(spec, w):
        if isinstance(spec, dict):
            return {name: one(spec[name], w[name]) for name in spec}
        return quantize_leaf(spec, w, qcfg)

    return one(specs, params)


def quantize_leaf(spec, w: torch.Tensor, qcfg: QuantConfig):
    """PTQ of one leaf: packed or QDQ along its contraction axis if the
    policy quantizes its kind, else ``w`` itself."""
    if not qcfg.quantizes(spec.kind) or not qcfg.quantize_weights:
        return w
    n_lead = _n_stack_axes(spec)
    if qcfg.weight_format == "packed":
        return _pack_along(w, spec.contract_axis, n_lead)
    return _qdq_along(w, spec.contract_axis, n_lead)


def _n_stack_axes(spec) -> int:
    """Leading stacked axes (each slice gets its own tensor scale)."""
    n = 0
    for ax in spec.axes:
        if ax not in ("layers", "inner"):
            break
        n += 1
    return n


def _moved_padded(w: torch.Tensor, axis: int):
    """Move ``axis`` last and zero-pad it to a block multiple; (w', K)."""
    wm = torch.movedim(w, axis % w.ndim, -1)
    k = wm.shape[-1]
    pad = (-k) % nvfp4.BLOCK
    if pad:
        wm = F.pad(wm, (0, pad))
    return wm, k


def _qdq_along(w: torch.Tensor, axis: int, n_lead: int = 0) -> torch.Tensor:
    """QDQ ``w`` blocked along ``axis``; each of the ``n_lead`` leading
    axes' slices is quantized on its own."""
    if n_lead:
        out = torch.empty_like(w)
        for i in range(w.shape[0]):
            out[i] = _qdq_along(w[i], axis - 1, n_lead - 1)
        return out
    wm, k = _moved_padded(w, axis)
    dq = nvfp4.qdq(wm)[..., :k]
    return torch.movedim(dq, -1, axis % w.ndim)


def _pack_along(w: torch.Tensor, axis: int, n_lead: int = 0) -> nvfp4.PackedNVFP4:
    """Pack ``w`` along ``axis`` (moved last); a stacked weight is packed
    slice by slice into preallocated codes / scales / tensor scales shaped
    as the reference's ``pack(..., n_lead)`` leaves them."""
    if n_lead:
        parts = None
        for i in range(w.shape[0]):
            p = _pack_along(w[i], axis - 1, n_lead - 1)
            if parts is None:
                parts = [torch.empty((w.shape[0], *t.shape), dtype=t.dtype,
                                     device=t.device)
                         for t in (p.codes, p.scales, p.tensor_scale)]
                orig_k = p.orig_k
            for dst, src in zip(parts, (p.codes, p.scales, p.tensor_scale)):
                dst[i] = src
        codes, scales, ts = parts
        # the reference's per-slice tensor scale: [*lead, 1, ..., 1]
        ts = ts.reshape(*codes.shape[:n_lead], *[1] * (codes.ndim - n_lead))
        return nvfp4.PackedNVFP4(codes, scales, ts, orig_k)
    wm, k = _moved_padded(w, axis)
    p = nvfp4.pack(wm)
    return dataclasses.replace(p, orig_k=k)
