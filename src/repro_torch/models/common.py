"""Parameter specs, initialisation and the layer loop (port of
``repro.models.common``).

A parameter tree is a nested ``dict`` whose leaves are tensors or
``PackedNVFP4`` weights; a spec tree mirrors it with ``ParamSpec`` leaves.
Initialisation draws from an explicit ``torch.Generator`` (the values
differ from ``jax.random``; parity tests bridge the reference's tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..core.nvfp4 import PackedNVFP4
from ..obs import numerics as obs_numerics


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                 # logical axis names, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | embed | lru_lambda
    scale: float = 1.0          # multiplier on the default init std
    kind: str = ""              # quant kind ("mlp"|"attn"|...) if a GEMM weight
    contract_axis: int = 0      # which axis is the GEMM contraction dim

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a nested-dict tree, and to the
    matching leaves of ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree`` flattens dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _init_one(spec: ParamSpec, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "lru_lambda":
        # RG-LRU: softplus^-1 of -log(u) / 8 for u ~ U(0.9, 0.999), so the
        # decay a = exp(-8 softplus(lam) r) starts at 0.9-0.999
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device) * (0.999 - 0.9) + 0.9
        lam = torch.log(torch.exp(-torch.log(u) / 8.0) - 1.0)
        return lam.to(spec.dtype)
    fan_in = spec.shape[spec.contract_axis] if len(spec.shape) else 1
    std = spec.scale * (0.02 if spec.init == "embed"
                        else 1.0 / np.sqrt(max(fan_in, 1)))
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    # a stacked [L, ...] weight is drawn one slice at a time, so no f32
    # temporary of the whole stack is made
    slices = [out] if len(spec.shape) < 3 else list(out)
    for sl in slices:
        sl.copy_(torch.randn(sl.shape, generator=gen, dtype=torch.float32,
                             device=device) * std)
    return out


def init_params(specs, gen: torch.Generator, device,
                leaf_fn: Callable | None = None) -> Any:
    """Random parameters for a spec tree, leaves drawn in sorted-key order.

    ``leaf_fn(path, spec, tensor)``, if given, replaces each leaf as soon
    as it is drawn (a loader quantizes it and keeps its tile, so no more
    than one full leaf is alive at a time); ``path`` is the dotted key
    path ("layers.wqkv")."""
    device = torch.device(device)

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{path}.{k}" if path else k)
                    for k in sorted(tree)}
        leaf = _init_one(tree, gen, device)
        return leaf if leaf_fn is None else leaf_fn(path, tree, leaf)
    return build(specs, "")


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked [n, ...] dim to every spec (the layer stack)."""
    def one(s: ParamSpec):
        return dataclasses.replace(
            s, shape=(n, *s.shape), axes=(axis_name, *s.axes),
            contract_axis=s.contract_axis + 1 if s.kind else s.contract_axis)
    return tree_map(one, spec_tree)


def zeros_from_specs(specs, device) -> Any:
    """A zero tensor for every spec of a tree, on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)


def spec_bytes(specs) -> int:
    """Bytes of a spec tree, priced without allocating it."""
    return sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
               .element_size() for s in tree_leaves(specs))


def stack_trees(trees: list):
    """Stack a list of same-structured trees leaf by leaf along a new
    leading axis (what a scan's ``ys`` are)."""
    return tree_map(lambda *a: torch.stack(a), trees[0], *trees[1:])


def merge_slot_state(specs, old, new, active: torch.Tensor):
    """Keep inactive slots' state bit for bit across a batched decode step.

    ``specs`` names each leaf's "batch" axis; ``active`` [n_slots] selects
    per slot between the new leaf and the old one.  The select is exact
    (no arithmetic) and makes new tensors: ``old`` is never written, so a
    tree held elsewhere (a snapshot) stays as it was."""
    def one(spec, o, n):
        ax = spec.axes.index("batch")
        act = active.reshape((1,) * ax + (-1,) + (1,) * (n.ndim - ax - 1))
        return torch.where(act, n.to(o.dtype), o)
    return tree_map(one, specs, old, new)


def weight_stats(params) -> dict:
    """Weight-memory accounting over a tree of dense and packed leaves:
    q_params / q_bytes for packed GEMM weights, dense_* for the rest."""
    stats = {"q_params": 0, "q_bytes": 0, "dense_params": 0, "dense_bytes": 0}
    for leaf in tree_leaves(params):
        if isinstance(leaf, PackedNVFP4):
            stats["q_params"] += int(np.prod(leaf.shape))
            stats["q_bytes"] += int(leaf.nbytes)
        else:
            stats["dense_params"] += leaf.numel()
            stats["dense_bytes"] += leaf.numel() * leaf.element_size()
    stats["total_bytes"] = stats["q_bytes"] + stats["dense_bytes"]
    return stats


def layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked tree (packed leaves keep ``orig_k``)."""
    return tree_map(lambda a: a[i], stacked)


def unstack(stacked, n: int) -> list:
    """All ``n`` layer slices of a stacked tree at once.

    Dense leaves go through one ``torch.unbind`` each, whose backward is a
    single ``stack``: under autograd, ``n`` separate ``a[i]`` would each
    scatter a gradient of the whole stack's size.  The slices are views,
    so in-place writes (the KV cache) reach the stack.
    """
    def one(a):
        if isinstance(a, PackedNVFP4):
            return [a[i] for i in range(n)]
        return torch.unbind(a, 0)

    split = tree_map(one, stacked)
    return [layer_slice(split, i) for i in range(n)]


def n_layers(stacked) -> int:
    leaf = tree_leaves(stacked)[0]
    return (leaf.codes if isinstance(leaf, PackedNVFP4) else leaf).shape[0]


# ---------------------------------------------------------------------------
# the layer loop with selective quantization (paper §3.4)
# ---------------------------------------------------------------------------

# the weight GEMMs of ``layers._matmul``: dot products with no batch
# dimension, what ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
# saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _rematerialized(fn, remat: str):
    """``fn(carry, (p, x))`` under ``torch.utils.checkpoint`` (what
    ``jax.checkpoint`` does to the reference's scanned body): the layer's
    activations are dropped after its forward and recomputed in the
    backward.  ``"full"`` keeps only the layer's inputs; ``"dots"`` also
    keeps the outputs of the weight GEMMs (``_DOTS``) and recomputes the
    rest: attention's batched products, the expert GEMMs, every QDQ (the
    ``nvfp4_qdq`` kernel runs again and writes a fresh output).  The
    recompute records no numerics probe: only the original forward does.
    """
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    calls = 0

    def run(carry, p, x):
        nonlocal calls
        calls += 1
        if calls > 1:                 # the recompute in the backward
            with obs_numerics.collecting(None):
                return fn(carry, (p, x))
        return fn(carry, (p, x))

    def wrapped(carry, inp):
        return checkpoint(run, carry, *inp, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=(_dots_contexts if remat == "dots"
                                      else noop_context_fn))
    return wrapped


def scan_layers(body_fn, carry, stacked_params, stacked_xs, qcfg,
                skip_first: int = 0, skip_last: int = 0,
                remat: str = "none"):
    """Run the layer stack in up to three segments, as the reference's
    ``jax.lax.scan`` does: the first ``skip_first`` and last ``skip_last``
    layers under ``BF16``, the middle under ``qcfg``.

    ``body_fn(qcfg)(carry, (layer_params, layer_xs)) -> (carry, y)``;
    returns the final carry and the list of per-layer ``y``.  The layer
    slices come from ``unstack``.

    ``remat`` ("none" | "full" | "dots", the config's ``remat``) runs each
    layer under rematerialization (``_rematerialized``); it changes memory
    and time, never values.  Without grad (the teacher's forward, evals,
    serving) nothing is kept for a backward, so no layer is wrapped.  On
    a training mesh the recompute runs the layer's forward collectives
    again (its amax maxima and row sums), in the same order on every rank;
    torch's early-stopping recompute ends at the last tensor the backward
    needs, so a layer's last row sum does not run again.

    Numerics probes: when ``qcfg.numerics`` is on and a tape is installed,
    each layer's probes are taken in a scope of their own and merged into
    ``[n_layers]`` series under ``layers.<site>`` (``_merge_probes``).  The
    BF16 segments keep the numerics flag, so the decoder's hidden-state tap
    covers them too; their quant probes stay silent.
    """
    from ..core.qconfig import BF16

    n = n_layers(stacked_params)
    skip_first = min(skip_first, n)
    skip_last = min(skip_last, n - skip_first)
    tape = obs_numerics.active() if qcfg.numerics else None
    skip_qc = (dataclasses.replace(BF16, numerics=True)
               if tape is not None else BF16)
    bounds = [(0, skip_first, skip_qc), (skip_first, n - skip_last, qcfg),
              (n - skip_last, n, skip_qc)]
    if not torch.is_grad_enabled():
        remat = "none"
    params = unstack(stacked_params, n)
    xs = unstack(stacked_xs, n) if stacked_xs is not None else [None] * n
    ys, probes = [], []
    for lo, hi, qc in bounds:
        fn = body_fn(qc)
        for i in range(lo, hi):
            layer = _rematerialized(fn, remat)
            if tape is not None:
                layer = _probe_scoped(layer, tape)
            carry, y = layer(carry, (params[i], xs[i]))
            if tape is not None:
                y, p = y
                probes.append(p)
            ys.append(y)
    if tape is not None:
        for site, stats in _merge_probes(probes).items():
            tape.put(f"layers.{site}", stats)
    return carry, ys


def _probe_scoped(fn, tape):
    """Run one layer in a tape scope of its own and return its probes as
    an extra component of ``y``: ``(carry, (y, probes))``."""
    def wrapped(carry, inp):
        tape.push_scope()
        try:
            carry, y = fn(carry, inp)
        finally:
            probes = tape.pop_scope()
        return carry, (y, probes)
    return wrapped


def _merge_probes(layers: list) -> dict:
    """Key-union merge of per-layer probe dicts into ``[n_layers]`` f32
    series (a mesh's partial sums f64; the stack of each stat along a new
    leading axis).  A site missing from a layer (the BF16 segments record no quant probes) is
    NaN for that layer, so every series keeps the length ``n_layers``."""
    sites = sorted({s for d in layers for s in d})
    out = {}
    for site in sites:
        stats = sorted({k for d in layers if site in d for k in d[site]})
        out[site] = {}
        for st in stats:
            first = next(d[site][st] for d in layers
                         if site in d and st in d[site])
            # f32, or f64 for a training mesh's partial sums and counts
            dt = torch.float64 if first.dtype == torch.float64 else torch.float32
            parts = [d[site][st].to(dt)
                     if site in d and st in d[site]
                     else torch.full(first.shape, float("nan"),
                                     dtype=dt, device=first.device)
                     for d in layers]
            out[site][st] = torch.stack(parts)
    return out
