"""Post-training quantization: activation calibration and one-shot weight
PTQ (port of ``repro.core.ptq``).

PTQ is the paper's baseline (§2.1): calibrate scale factors on a small
set, then quantize without training.  ``calibrate_activations`` estimates
each activation site's tensor amax with an ``AmaxObserver``, by one of
three methods:

  * ``max``        - the running max of |x| (the paper's default);
  * ``percentile`` - a percentile of the observed |x| (clips outliers);
  * ``mse``        - the grid point of 0.5 .. 1 x max whose NVFP4 QDQ has
    the least mean squared error.

The samples of ``percentile`` and ``mse`` go to host numpy, as in the
reference (``torch.quantile`` refuses more than 2^24 values and
interpolates otherwise); ``mse``'s QDQ is ``core.nvfp4.qdq`` in its
division form on the host, the reference's eager ``nvfp4.qdq``.

``quantize_weights`` fake-quantizes (``weight_format="qdq"``) or packs to
true 4-bit NVFP4 (``"packed"``) every GEMM weight the policy quantizes.
Leading layer-stack axes get one tensor scale per slice, as in the
reference, and the port quantizes a stacked weight one slice at a time: a
slice's scale is its own amax either way, so the codes are identical, and
no f32 temporary of the whole stack is made (packing all 28 slices of a
[28, 3584, 18944] weight at once would need several 7.6 GB temporaries).
So the reference's ``_lead_amax`` has no counterpart: each slice's amax
is taken where the slice is quantized.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from . import nvfp4
from .qconfig import QuantConfig


@dataclasses.dataclass
class AmaxObserver:
    """Streaming per-tensor amax estimator for one activation site."""

    method: str = "max"          # max | percentile | mse
    percentile: float = 99.9
    _samples: list = dataclasses.field(default_factory=list)
    _running_max: float = 0.0

    def observe(self, x: torch.Tensor) -> None:
        ax = torch.abs(x)
        self._running_max = max(self._running_max, float(torch.amax(ax)))
        if self.method != "max":
            self._samples.append(ax.to("cpu", torch.float32).numpy().ravel())

    def amax(self) -> float:
        if self.method == "max" or not self._samples:
            return self._running_max
        flat = np.concatenate(self._samples)
        if self.method == "percentile":
            return float(np.percentile(flat, self.percentile))
        if self.method == "mse":
            return _mse_amax(flat, self._running_max)
        raise ValueError(self.method)


def _mse_amax(flat: np.ndarray, running_max: float, n_grid: int = 32) -> float:
    """Grid-search the clipping amax minimizing the NVFP4 QDQ MSE of the
    samples ``flat`` (zero-padded to a block multiple)."""
    pad = (-len(flat)) % nvfp4.BLOCK
    x = torch.from_numpy(np.pad(flat, (0, pad)))
    best, best_err = running_max, np.inf
    for frac in np.linspace(0.5, 1.0, n_grid):
        amax = running_max * float(frac)
        dq = nvfp4.qdq(x, torch.tensor(amax, dtype=torch.float32))
        err = float(torch.mean((dq - x) ** 2))
        if err < best_err:
            best, best_err = amax, err
    return best


def calibrate_activations(fwd: Callable, batches: Iterable,
                          sites: list[str], method: str = "max") -> dict[str, float]:
    """Run ``fwd(batch) -> {site: activation}`` over batches, calibrate
    each site's amax."""
    obs = {s: AmaxObserver(method=method) for s in sites}
    for b in batches:
        acts = fwd(b)
        for s in sites:
            obs[s].observe(acts[s])
    return {s: o.amax() for s, o in obs.items()}


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
