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

from ..core.nvfp4 import PackedNVFP4


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                 # logical axis names, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | embed
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


def scan_layers(body_fn, carry, stacked_params, stacked_xs, qcfg,
                skip_first: int = 0, skip_last: int = 0):
    """Run the layer stack in up to three segments, as the reference's
    ``jax.lax.scan`` does: the first ``skip_first`` and last ``skip_last``
    layers under ``BF16``, the middle under ``qcfg``.

    ``body_fn(qcfg)(carry, (layer_params, layer_xs)) -> (carry, y)``;
    returns the final carry and the list of per-layer ``y``.  The layer
    slices come from ``unstack``.  Rematerialization (``cfg.remat``)
    changes memory, not values, and is not ported yet: every layer's
    activations stay live for the backward.
    """
    from ..core.qconfig import BF16

    if qcfg.numerics:
        raise NotImplementedError("numerics probes are part of the "
                                  "observability slice of the port")
    n = n_layers(stacked_params)
    skip_first = min(skip_first, n)
    skip_last = min(skip_last, n - skip_first)
    bounds = [(0, skip_first, BF16), (skip_first, n - skip_last, qcfg),
              (n - skip_last, n, BF16)]
    params = unstack(stacked_params, n)
    xs = unstack(stacked_xs, n) if stacked_xs is not None else [None] * n
    ys = []
    for lo, hi, qc in bounds:
        fn = body_fn(qc)
        for i in range(lo, hi):
            carry, y = fn(carry, (params[i], xs[i]))
            ys.append(y)
    return carry, ys
