"""AdamW (port of ``repro.optim.adamw``).

The interface mirrors the reference's: ``opt.init(params) -> state``;
``opt.update(grads, state, params, step) -> (updates, state)``, where the
updates are added to the parameters by the caller.  Trees are nested dicts
of tensors.  Gradients are clipped by their global norm, the moments are
bias-corrected, and the moments are kept in ``state_dtype`` (f32 or bf16);
the step count, the schedule and the bias corrections are f32 tensors, as
in the reference.  The update is functional: new tensors, old ones left as
they are.  ``apply`` fuses the update with its addition to the parameters,
leaf by leaf and slice by slice, for the training step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..models.common import tree_leaves, tree_map

_F32 = torch.float32
_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# values of a leaf that ``AdamW.apply`` updates at a time (rows of its
# leading axis: a layer of a stacked weight, a band of the embedding)
_SLICE = 1 << 24


class AdamWState(NamedTuple):
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class ShardedNorm:
    """A global norm over a training mesh's stored shards: each leaf's sum
    of squares times its weight (1 / the ranks holding the same shard, in
    ``tree_leaves`` order; a leaf whose columns are held by more ranks
    than the rest, an MQA fused QKV tile's KV head, has an f32 weight a
    column of its last dim), the weighted sum summed over every rank by
    ``reduce``, so each element counts once."""
    weights: tuple
    reduce: Callable

    def square_sum(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s (or a slice of it's) sum of squares, weighted by
        column where its weight is a tensor (``total`` weighs the rest)."""
        sq = torch.square(x.to(_F32))
        w = self.weights[i]
        return torch.sum(sq) if isinstance(w, float) else torch.sum(sq * w)

    def total(self, sq: list) -> torch.Tensor:
        return self.reduce(sum((w if isinstance(w, float) else 1.0) * s
                               for w, s in zip(self.weights, sq)))


def global_norm(tree, norm: ShardedNorm | None = None) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32 (over the mesh with
    ``norm``)."""
    leaves = tree_leaves(tree)
    if norm is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                              for x in leaves))
    return torch.sqrt(norm.total([norm.square_sum(i, x)
                                  for i, x in enumerate(leaves)]))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-6        # paper: 1e-6 .. 1e-5 (Table 6)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    state_dtype: str = "float32"       # float32 | bfloat16

    def init(self, params) -> AdamWState:
        dt = _STATE_DTYPES[self.state_dtype]
        z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamWState(m=tree_map(z, params), v=tree_map(z, params))

    def _coefficients(self, grads, step: torch.Tensor,
                      norm: ShardedNorm | None = None):
        """(clip scale or None, bias corrections bc1 and bc2, lr) of a step
        at int32 ``step``, all f32 tensors on the gradients' device; the
        clip norm over the mesh with ``norm``."""
        dev = tree_leaves(grads)[0].device
        scale = None
        if self.clip_norm:
            gn = global_norm(grads, norm)
            scale = torch.clamp(self.clip_norm / torch.clamp_min(gn, 1e-12),
                                max=1.0)
        t = (step + 1).to(device=dev, dtype=_F32)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=_F32, device=dev), t)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=_F32, device=dev), t)
        lr = self.lr(step.to(dev)) if callable(self.lr) else self.lr
        return scale, bc1, bc2, lr

    def _leaf(self, g, m, v, p, scale, bc1, bc2, lr):
        """One leaf's (f32 update, new m, new v)."""
        b1, b2 = self.b1, self.b2
        g = g.to(_F32)
        if scale is not None:
            g = g * scale
        m32 = b1 * m.to(_F32) + (1 - b1) * g
        v32 = b2 * v.to(_F32) + (1 - b2) * g * g
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p.to(_F32)
        return -lr * u, m32.to(m.dtype), v32.to(v.dtype)

    def update(self, grads, state: AdamWState, params, step: torch.Tensor,
               norm: ShardedNorm | None = None):
        """(updates in f32, new state) for gradients at int32 ``step``."""
        c = self._coefficients(grads, step, norm)
        out = tree_map(lambda g, m, v, p: self._leaf(g, m, v, p, *c), grads,
                       state.m, state.v, params)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), AdamWState(m=pick(1), v=pick(2))

    def apply(self, grads, state: AdamWState, params, step: torch.Tensor,
              norm: ShardedNorm | None = None):
        """``update`` and the add, leaf by leaf and in slices of a leaf:
        (new parameters, new state, global norm of the updates).  The new
        parameters and moments are bitwise what ``update`` followed by
        ``(p.f32 + u).to(p.dtype)`` gives (every operation is elementwise
        but the clip scale, taken first); the updates' norm sums each
        leaf's squares slice by slice, so it may differ from
        ``global_norm(updates)`` in its last bits.

        Memory: no f32 update of a whole leaf is ever alive, only of one
        slice (``_SLICE`` values), and each gradient leaf is dropped from
        ``grads`` once used.  So the step's transient is the new state
        (the old one stays: the update is functional), not the new state
        plus f32 copies of the largest leaf's update and its moments, as a
        donated, fused update in the reference's jitted step needs no
        more.

        ``norm``: the trees are a training mesh's stored shards (the
        moments stored like their parameters); the clip norm and the
        updates' norm are taken over the mesh (``ShardedNorm``)."""
        c = self._coefficients(grads, step, norm)
        sq = []

        def one(g, m, v, p):
            new_p, new_m, new_v = (torch.empty_like(p), torch.empty_like(m),
                                   torch.empty_like(v))
            rows = max(1, _SLICE // max(1, p[0].numel())) if p.ndim else 1
            leaf_sq = []
            for i in range(0, p.shape[0] if p.ndim else 1, rows):
                sl = slice(i, i + rows) if p.ndim else ...
                u, new_m[sl], new_v[sl] = self._leaf(g[sl], m[sl], v[sl],
                                                     p[sl], *c)
                leaf_sq.append(torch.sum(torch.square(u)) if norm is None
                               else norm.square_sum(len(sq), u))
                new_p[sl] = (p[sl].to(_F32) + u).to(p.dtype)
            sq.append(sum(leaf_sq))
            return new_p, new_m, new_v

        def walk(g, m, v, p):
            new_p, new_m, new_v = {}, {}, {}
            for k in sorted(p):              # tree_leaves' order
                if isinstance(p[k], dict):
                    new_p[k], new_m[k], new_v[k] = walk(g[k], m[k], v[k], p[k])
                else:
                    new_p[k], new_m[k], new_v[k] = one(g.pop(k), m[k], v[k],
                                                       p[k])
            return new_p, new_m, new_v

        new_p, new_m, new_v = walk(grads, state.m, state.v, params)
        total = sum(sq) if norm is None else norm.total(sq)
        return new_p, AdamWState(m=new_m, v=new_v), torch.sqrt(total)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor * peak``;
    f32 arithmetic on the step tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(_F32)
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, peak_lr * cos)
    return lr


def constant(lr_value: float) -> Callable:
    return lambda step: torch.full((), lr_value, dtype=_F32,
                                   device=step.device)
