"""Numerics observability: quantization-error and divergence probes
(port of ``repro.obs.numerics``).

Where a profiler observes time, this plane observes *values*: per-layer
NVFP4 quantization error (SQNR, amax, clip fraction, scale utilization)
of every quantized site, per-layer teacher-student hidden-state geometry
(cosine / MSE) and per-layer gradient norms.

Collection: instrumented call sites (``QuantConfig.q_act`` / ``q_weight``,
``layers.qeinsum`` for a packed weight, the decoder's layer body) put 0-d
tensors on the active ``Tape`` when ``QuantConfig.numerics`` is on and a
tape is installed with ``collecting(tape)``.  Every probe is computed
under ``torch.no_grad()`` on the tensor's own device from the values the
forward already has, so it adds nothing to the autograd graph and changes
no value the step computes: probes on or off, the step's state is
bitwise the same.  ``models.common.scan_layers`` pushes a tape scope
around each layer and stacks the per-layer dicts into ``[n_layers]``
series (NaN for layers a site does not occur in: the BF16 segments of a
selective recipe); under rematerialization only the original forward
records, the recompute in the backward does not.

On a training mesh (``distributed.ctx.use_mesh``) a probe puts its
partial sums on the tape instead (``part/...``: the signal, noise, clip
and block-scale sums and their counts, the local amax; the hidden
divergence's masked sums; each tagged ``over/<bits>`` with the groups
that split its tensor: 1 the data group, 2 the model group), and the
step reduces every site of every layer at once (``reduce_on_mesh``): one
all-gather over the model group and one over the data group a step, each
rank adding the gathered values in rank order, so every rank's stats are
the same bits.

Host side, ``NumericsRecorder`` aggregates the drained dicts into a
``MetricsRegistry`` as ``layer=``-labeled gauges and histograms plus
chart-ready ``(step, value)`` series.  ``python -m repro_torch.obs.numerics
A.json B.json`` diffs two exported snapshots (see ``obs.compare``).
"""
from __future__ import annotations

import functools
import operator
from contextlib import contextmanager

import numpy as np
import torch

from ..core import nvfp4
from ..distributed import ctx

_tape = None
# the tags of a partial probe on a training mesh: the groups its tensor
# splits over (bits), and the prefix of its partial sums
OVER = "over/"
PART = "part/"
DATA, MODEL = 1, 2


def active():
    """The installed numerics Tape, or None (the common fast path)."""
    return _tape


@contextmanager
def collecting(tape):
    """Install ``tape`` (or None: no recording) as the active probe tape
    for the block."""
    global _tape
    prev = _tape
    _tape = tape
    try:
        yield tape
    finally:
        _tape = prev


class Tape:
    """Scoped probe store: site name -> {stat: 0-d tensor}.

    Scopes nest (``scan_layers`` pushes one around each layer so the
    per-layer probes stay separable from the surrounding forward).
    Duplicate site names within a scope dedup with ``#2``, ``#3``
    suffixes, in call order.
    """

    def __init__(self):
        self._scopes = [{}]

    def push_scope(self) -> None:
        self._scopes.append({})

    def pop_scope(self) -> dict:
        return self._scopes.pop()

    def put(self, site: str, stats: dict) -> None:
        scope = self._scopes[-1]
        name, i = site, 1
        while name in scope:
            i += 1
            name = f"{site}#{i}"
        scope[name] = stats

    def drain(self) -> dict:
        """Return and clear the current scope's contents."""
        out = self._scopes[-1]
        self._scopes[-1] = {}
        return out


# ---------------------------------------------------------------------------
# Probe math (torch, on the tensor's device, no autograd)
# ---------------------------------------------------------------------------


def _group_stats(tp, sums: list, counts: list, amax: torch.Tensor) -> tuple:
    """The stats' sums (0-d f32), counts (ints) and amax, as they stand on
    one device or, under tensor parallelism (``tp``), over the group: one
    all-gather of this rank's values in f64, added in rank order on every
    rank (so every rank gets the same bits; the counts exactly), the amax
    the group's max."""
    if tp is None:
        return sums, counts, amax
    mine = torch.stack([*(s.to(torch.float64) for s in sums),
                        *(torch.full((), float(c), dtype=torch.float64,
                                     device=amax.device) for c in counts),
                        amax.to(torch.float64)])
    every = tp.all_gather(mine[None], 0)                  # [size, n + 1]
    total = every[0]
    for r in range(1, every.shape[0]):
        total = total + every[r]
    n = len(sums)
    return ([t.to(torch.float32) for t in total[:n]],
            [int(c) for c in total[n:-1].tolist()],
            torch.amax(every[:, -1]).to(torch.float32))


def _mean(total: torch.Tensor, count) -> torch.Tensor:
    """The mean as the jitted reference takes it: the sum times the f32
    reciprocal of the count (an int, or a tensor of counts: a mesh's
    per-layer series)."""
    if isinstance(count, torch.Tensor):
        return total * torch.reciprocal(count.to(torch.float32))
    return total * float(np.float32(1.0) / np.float32(count))


def mesh_over(tp=None) -> int:
    """The groups an activation probe's tensor splits over on a training
    mesh: its rows over the data group (none inside
    ``ctx.data_replicated``), its features over ``tp`` at a row-split
    site.  (A weight's model tile splits over the model group alone: its
    data ranks hold the same tile.)"""
    over = MODEL if tp is not None and tp.size > 1 else 0
    if ctx.data() is not None and ctx.data().size > 1:
        over |= DATA
    return over


def _partial(over: int, sums: dict, amax: torch.Tensor) -> dict:
    """A probe's partial form on a training mesh: its sums (0-d f64), its
    local amax and its ``over`` tag."""
    out = {f"{PART}{k}": torch.as_tensor(v, dtype=torch.float64,
                                          device=amax.device)
           for k, v in sums.items()}
    out[f"{PART}amax"] = amax.to(torch.float32)
    out[f"{OVER}{over}"] = torch.zeros((), device=amax.device)
    return out


def _quant_stats(sig, noise, n_clip, s_sum, n, n_s, amax) -> dict:
    sqnr_db = 10.0 * (torch.log10(torch.clamp_min(sig, 1e-30))
                      - torch.log10(torch.clamp_min(noise, 1e-30)))
    return {
        "sqnr_db": sqnr_db,
        "amax": amax,
        "clip_frac": _mean(n_clip, n),
        "scale_util": _mean(s_sum, n_s) / nvfp4.E4M3_MAX,
    }


@torch.no_grad()
def quant_error_stats(x: torch.Tensor, tensor_amax=None, tp=None,
                      over: int | None = None) -> dict:
    """NVFP4 quantization-error stats for ``x``, blocked along the last dim.

    Returns 0-d f32 tensors:

      * ``sqnr_db``    - 10 log10(sum x^2 / sum (x - qdq(x))^2)
      * ``amax``       - max |x|
      * ``clip_frac``  - fraction of elements whose magnitude exceeds
        what their block's (FP8-rounded) scale can represent
      * ``scale_util`` - mean block scale / E4M3_MAX

    ``tensor_amax`` is the amax of the forward's scope (row or token), so
    the probe measures the quantization the layer applies.  The scales
    take the form the forward's QDQ takes (``reciprocal=True``: the
    divisions by constants as f32 reciprocal multiplications, as the
    ``nvfp4_qdq`` kernel and the reference's jitted step compute them);
    the dequantized values stay in f32, as in the reference.

    ``tp`` (a ``distributed.ctx.TP``): ``x`` is this rank's slice of a
    tensor split over the group; the signal, noise and clip sums, the
    counts and the block scales' sum are the group's, the amax its max,
    so the stats are those of the whole tensor (up to the order of the
    f32 sums).  On a training mesh the partial form instead
    (``reduce_on_mesh``), tagged ``over`` (default: ``mesh_over(tp)``).
    """
    xf = x.detach().to(torch.float32)
    k = xf.shape[-1]
    pad = (-k) % nvfp4.BLOCK
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    scales = nvfp4.compute_scales(xf, tensor_amax, reciprocal=True)
    q = nvfp4.quantize_blocked(xf, scales)
    s = (scales.block * scales.tensor)[..., None]
    y = (q * s).reshape(xf.shape)
    err = xf - y
    sig = torch.sum(xf * xf)
    noise = torch.sum(err * err)
    cap = (scales.block * scales.tensor) * nvfp4.E2M1_MAX
    xb = torch.abs(xf).reshape(*xf.shape[:-1], xf.shape[-1] // nvfp4.BLOCK,
                               nvfp4.BLOCK)
    clipped = (xb > cap[..., None]).to(torch.float32)
    amax = torch.amax(torch.abs(xf))
    if ctx.mesh() is not None:
        return _partial(mesh_over(tp) if over is None else over, {
            "sig": sig, "noise": noise, "clip": torch.sum(clipped),
            "scale": torch.sum(scales.block), "n": clipped.numel(),
            "n_scale": scales.block.numel()}, amax)
    (sig, noise, n_clip, s_sum), (n, n_s), amax = _group_stats(
        tp, [sig, noise, torch.sum(clipped), torch.sum(scales.block)],
        [clipped.numel(), scales.block.numel()], amax)
    return _quant_stats(sig, noise, n_clip, s_sum, n, n_s, amax)


@torch.no_grad()
def packed_weight_stats(p: "nvfp4.PackedNVFP4", tp=None) -> dict:
    """Probe stats for an already-packed weight: the reconstructed amax
    (max block scale x tensor scale x E2M1_MAX) and the FP8 scale-range
    utilization (the original values are gone, so no SQNR).  ``tp``:
    ``p`` is this rank's tile; the amax is the group's max and the scale
    use the mean over every tile."""
    sb = p.scales.to(torch.float32)
    ts = p.tensor_scale.to(torch.float32)
    (s_sum,), (n,), amax = _group_stats(tp, [torch.sum(sb)], [sb.numel()],
                                        torch.amax(sb * ts))
    return {
        "amax": amax * nvfp4.E2M1_MAX,
        "scale_util": _mean(s_sum, n) / nvfp4.E4M3_MAX,
    }


@torch.no_grad()
def hidden_divergence(h_t: torch.Tensor, h_s: torch.Tensor,
                      mask: torch.Tensor) -> dict:
    """Per-layer teacher-student hidden-state geometry.

    ``h_t`` / ``h_s``: stacked per-layer hiddens ``[L, B, S, d]`` (the
    ``layers.hidden`` probe merged by ``scan_layers``); ``mask`` ``[B, S]``
    float, 1 = real token.  Returns ``[L]`` f32 series: the masked mean
    of the per-token cosine similarity and of the per-dim MSE.  On a
    training mesh (a data rank's rows) the masked sums and the count, for
    ``reduce_on_mesh``.
    """
    t = h_t.to(torch.float32)
    s = h_s.to(torch.float32)
    m = mask.to(torch.float32)[None]                          # [1, B, S]
    dot = torch.sum(t * s, -1)
    nt = torch.sqrt(torch.clamp_min(torch.sum(t * t, -1), 1e-12))
    ns = torch.sqrt(torch.clamp_min(torch.sum(s * s, -1), 1e-12))
    cos = torch.sum((dot / (nt * ns)) * m, dim=(1, 2))
    mse = torch.sum(torch.mean((t - s) ** 2, -1) * m, dim=(1, 2))
    count = torch.sum(m, dim=(1, 2)).expand(cos.shape)
    if ctx.mesh() is not None:
        over = mesh_over()
        return {f"{PART}cos": cos.to(torch.float64),
                f"{PART}mse": mse.to(torch.float64),
                f"{PART}count": count.to(torch.float64),
                f"{OVER}{over}": torch.zeros_like(cos)}
    return _divergence(cos, mse, count)


def _divergence(cos, mse, count) -> dict:
    denom = torch.clamp_min(count, 1.0)
    return {"hidden_cos": cos / denom, "hidden_mse": mse / denom}


def grad_partials(sq: torch.Tensor) -> dict:
    """The per-layer gradient norms' partial form on a training mesh:
    this rank's [n_layers] sums of squares of its stored shards, each
    weighted by 1 / its replication, summed over every rank."""
    return {f"{PART}sq": sq.to(torch.float64),
            f"{OVER}{DATA | MODEL}": torch.zeros_like(sq)}


def _over_bits(stats: dict) -> int | None:
    """A partial site's ``over`` bits (None for a final one)."""
    bits = [int(k[len(OVER):]) for k in stats if k.startswith(OVER)]
    return functools.reduce(operator.or_, bits) if bits else None


def reduce_on_mesh(aux: dict, mesh) -> dict:
    """A mesh step's probes (``{site: {stat: tensor}}``, partial sites
    tagged ``over/<bits>``) as their final stats, the same bits on every
    rank: each group's partial sums all-gathered in one call (f64) and
    added in rank order, their amaxes maxed; then each site's stats from
    its sums (the one-device formulas).  Sites with no tag pass."""
    parts = {site: st for site, st in aux.items()
             if _over_bits(st) is not None}
    for tp, bit in ((mesh.model, MODEL), (mesh.data, DATA)):
        if tp.size == 1:
            continue
        sel = [(site, k) for site, st in sorted(parts.items())
               if _over_bits(st) & bit
               for k in sorted(st) if k.startswith(PART)]
        if not sel:
            continue
        vals = [parts[site][k] for site, k in sel]
        flat = torch.cat([v.reshape(-1).to(torch.float64) for v in vals])
        every = tp.all_gather(flat[None], 0)
        total = every[0]
        for r in range(1, every.shape[0]):
            total = total + every[r]
        top = torch.amax(every, 0)
        i = 0
        for (site, k), v in zip(sel, vals):
            n = v.numel()
            got = top if k == f"{PART}amax" else total
            parts[site][k] = got[i:i + n].reshape(v.shape).to(v.dtype)
            i += n
    out = dict(aux)
    for site, st in parts.items():
        p = {k[len(PART):]: v for k, v in st.items() if k.startswith(PART)}
        if "sq" in p:
            out[site] = {"grad_norm": torch.sqrt(p["sq"]).to(torch.float32)}
        elif "cos" in p:
            out[site] = _divergence(*(p[k].to(torch.float32)
                                      for k in ("cos", "mse", "count")))
        else:
            f32 = {k: v.to(torch.float32) for k, v in p.items()}
            out[site] = _quant_stats(f32["sig"], f32["noise"], f32["clip"],
                                     f32["scale"], p["n"], p["n_scale"],
                                     f32["amax"])
    return out


def _host(v) -> np.ndarray:
    """A probe value as a float64 numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


# ---------------------------------------------------------------------------
# Host-side aggregation into the registry
# ---------------------------------------------------------------------------

_STAT_HELP = {
    "sqnr_db": "per-layer signal-to-quantization-noise ratio, dB",
    "amax": "per-layer activation/weight amax",
    "clip_frac": "per-layer fraction of values clipped by the block scale",
    "scale_util": "per-layer mean FP8 block-scale / E4M3_MAX",
    "hidden_cos": "per-layer teacher-student hidden cosine similarity",
    "hidden_mse": "per-layer teacher-student hidden MSE",
    "grad_norm": "per-layer student gradient norm",
    "kl": "teacher-student KL at the probe site",
    "top1_agree": "teacher-student top-1 agreement at the probe site",
}

# stats exported as layer=-labeled reservoir histograms rather than
# last-write gauges: the distribution of the block scales' use over layers
_HIST_STATS = ("scale_util",)


class NumericsRecorder:
    """Aggregates drained probe aux into a MetricsRegistry.

    ``record(aux)`` takes the probe dict a train step returned,
    ``{site: {stat: 0-d | [n_layers] tensor}}`` (on any device; one copy
    to the host per value).
    Per-layer arrays expand into one ``layer="<site>.<ii>"``-labeled
    series per index (zero-padded, so sorted label order == layer
    order); NaN entries (BF16 skip segments) are dropped, not recorded.
    ``series_point`` accumulates the chart-ready ``(step, value)``
    series (``qad_live_kl``, ``spec_accept_rate``) that the snapshot's
    ``numerics`` section exports.
    """

    def __init__(self, registry):
        self._reg = registry
        self._gauges: dict = {}
        self._hists: dict = {}
        self.last: dict = {}          # flattened site -> {stat: float}
        self.series: dict = {}        # name -> [[step, value], ...]
        self.records = 0              # record() calls (sampled steps seen)

    def _instrument(self, stat: str):
        if stat in _HIST_STATS:
            h = self._hists.get(stat)
            if h is None:
                h = self._hists[stat] = self._reg.histogram(
                    f"numerics_{stat}", _STAT_HELP.get(stat, ""),
                    labels=("layer",))
            return h, "observe"
        g = self._gauges.get(stat)
        if g is None:
            g = self._gauges[stat] = self._reg.gauge(
                f"numerics_{stat}", _STAT_HELP.get(stat, ""),
                labels=("layer",))
        return g, "set"

    def _record_one(self, site: str, stat: str, value: float) -> None:
        if value != value:            # NaN: layer not probed (BF16 segment)
            return
        inst, method = self._instrument(stat)
        getattr(inst.labels(layer=site), method)(value)
        self.last.setdefault(site, {})[stat] = value

    def record(self, aux: dict) -> None:
        for site in sorted(aux):
            for stat in sorted(aux[site]):
                arr = _host(aux[site][stat])
                if arr.ndim == 0:
                    self._record_one(site, stat, float(arr))
                else:
                    for i, v in enumerate(arr.reshape(-1).tolist()):
                        self._record_one(f"{site}.{i:03d}", stat, float(v))
        self.records += 1

    def series_point(self, name: str, step: int, value) -> None:
        if value is None or value != value:
            return
        self.series.setdefault(name, []).append([int(step), float(value)])

    def summary(self) -> dict:
        """The snapshot document's ``numerics`` section."""
        sqnr = [s["sqnr_db"] for s in self.last.values() if "sqnr_db" in s]
        return {
            "sampled_records": self.records,
            "per_layer": {site: dict(sorted(stats.items()))
                          for site, stats in sorted(self.last.items())},
            "series": {k: list(v) for k, v in sorted(self.series.items())},
            "sqnr_db_min": min(sqnr) if sqnr else None,
            "sqnr_db_mean": (sum(sqnr) / len(sqnr)) if sqnr else None,
        }


def main(argv=None) -> int:
    from . import compare
    return compare.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
