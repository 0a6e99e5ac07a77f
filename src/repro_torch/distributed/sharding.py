"""Logical-axis sharding rules with a divisibility fallback, and each
rank's tiles (port of ``repro.distributed.sharding``: ``make_rules``'s
``tp_only`` table, ``resolve``, ``resolve_packed``, the warn-once fallback,
``device_bytes`` and ``shard_params``).

Parameters carry logical axis names (``ParamSpec.axes``); the rules map a
name to the mesh's "model" axis or to nothing.  ``resolve`` gives, per
dim, "model" where that dim splits over the group and None where it stays
whole, dropping "model" where the group's size does not divide the dim
(and warning once per parameter: a silently replicated weight is how TP
regressions hide).  ``resolve_packed`` does the same for a
``PackedNVFP4`` leaf, whose contraction axis is stored last: the output
dim N splits as a dense dim does (column-parallel), and the packed K dim
splits only in whole 16-element blocks with no K padding (row-parallel).

Where the reference places global arrays with ``NamedSharding``s,
``shard_params`` returns rank r's tree of tiles.  One layout differs: the
reference splits the fused QKV projection's N dim contiguously and GSPMD
then reshards q, k and v to heads.  The port permutes the rows of W^T (and
of the bias) so that rank r's contiguous tile holds exactly its own q, k
and v heads, which the head-local attention needs.  Choosing rows of W^T
is exact: every output element is the unsharded GEMM's.  GQA stays
aligned only when the KV heads divide the group.

The MoE leaves follow the same rules.  An expert stack [E, K, N] splits
on E where its config shards experts (``moe_shard="ep"``: the leading
stored dim of a packed stack, codes and block scales alike, the per-layer
tensor scale whole), or on the FFN dim under ``moe_shard="tp"`` (or when
E does not divide the group and the FFN dim does): the gate and up stacks
column-parallel, the down stack's packed K in whole blocks only.  The
router [d, E] splits on E.  An FP8 KV pool's pages and f32 scale planes
split on the KV-head dim, by the same "kv" rule.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping

import torch

from ..core import nvfp4
from ..core.nvfp4 import BLOCK, PackedNVFP4
from ..models.common import ParamSpec, tree_leaves

MODEL = "model"
# ``make_rules(mesh, "tp_only")``'s table: weights replicated except the
# tensor-parallel dims (serving at low batch); the data axis has size 1
TP_ONLY = {"batch": (), "vocab": (MODEL,), "mlp": (MODEL,), "qkv": (MODEL,),
           "heads": (MODEL,), "kv": (MODEL,), "expert": (MODEL,),
           "rnn": (MODEL,), "headdim": (MODEL,), "embed": (), "seq": (),
           "layers": (), "inner": (), "none": ()}
# leaves whose N dim is the fused [q heads | k heads | v heads] projection:
# every leaf whose name ends so (whisper's cross-attention "x_wqkv" too)
FUSED_QKV = ("wqkv", "bqkv")
# the MoE expert stacks [E, K, N]: split on E ("expert", ``moe_shard="ep"``)
# or on the FFN dim ("mlp", ``moe_shard="tp"``)
EXPERT_STACKS = ("moe_wg", "moe_wu", "moe_wd")


@dataclasses.dataclass(frozen=True)
class Rules:
    table: Mapping[str, tuple]

    def axes_for(self, name: str) -> tuple:
        return tuple(self.table.get(name, ()))


def make_rules() -> Rules:
    """The ``tp_only`` rules (the reference's ``fsdp_tp`` training mesh is
    a later slice of the port)."""
    return Rules(TP_ONLY)


_FALLBACK_WARNED: set = set()


def _warn_fallback(param: str, ax_name: str, dim: int, size: int) -> None:
    """Warn once per (param, logical axis, group size) when a dim that the
    rules would split stays whole."""
    key = (param, ax_name, size)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(
        f"sharding fallback: param {param!r} dim {dim} (logical axis "
        f"{ax_name!r}) drops mesh axes {{'model': {size}}} — stays "
        "replicated on them", RuntimeWarning, stacklevel=3)


def resolve(spec: ParamSpec, size: int, rules: Rules, name: str = "") -> tuple:
    """Per dim, "model" where the dim splits ``size`` ways, else None (the
    first dim that wants the axis and divides takes it)."""
    used, out = False, []
    for dim, ax_name in zip(spec.shape, spec.axes):
        want = MODEL in rules.axes_for(ax_name) and not used and size > 1
        ok = want and dim % size == 0
        if want and not ok:
            _warn_fallback(name or f"{spec.axes}{spec.shape}", ax_name, dim,
                           size)
        out.append(MODEL if ok else None)
        used = used or ok
    return tuple(out)


def resolve_packed(spec: ParamSpec, size: int, rules: Rules,
                   name: str = "") -> tuple:
    """Per stored dim of a ``PackedNVFP4`` leaf (the non-contraction dims
    in order, then K), "model" or None; codes and scales share it and the
    tensor scale is replicated.  K splits only when every shard owns
    whole 16-element blocks and K is not padded."""
    ax = spec.contract_axis % len(spec.shape)
    k = spec.shape[ax]
    kp = k + (-k) % BLOCK
    pname = name or f"{spec.axes}{spec.shape}"
    used, parts = False, []
    for i, (dim, ax_name) in enumerate(zip(spec.shape, spec.axes)):
        if i == ax:
            continue
        want = MODEL in rules.axes_for(ax_name) and not used and size > 1
        ok = want and dim % size == 0
        if want and not ok:
            _warn_fallback(pname, ax_name, dim, size)
        parts.append(MODEL if ok else None)
        used = used or ok
    want_k = MODEL in rules.axes_for(spec.axes[ax]) and not used and size > 1
    ok_k = want_k and nvfp4.row_splits(k, kp, size)
    if want_k and not ok_k:
        _warn_fallback(pname, f"{spec.axes[ax]} (packed K)", k, size)
    return (*parts, MODEL if ok_k else None)


def device_bytes(tree) -> int:
    """Bytes this rank holds of a tree of local tiles and replicated
    leaves (every leaf of the port's trees is local)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, PackedNVFP4):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def _fused(name: str) -> bool:
    """Is the leaf at tree path ``name`` a fused QKV projection?"""
    return name.rsplit(".", 1)[-1].endswith(FUSED_QKV)


def _kv_local(n_heads: int, n_kv: int, size: int, name: str = "") -> int:
    """The KV heads a rank holds: its share where they divide the group,
    the one KV head of MQA replicated; raises otherwise (GQA stays
    aligned only so)."""
    if n_heads % size or (n_kv % size and n_kv != 1):
        raise NotImplementedError(
            f"{name or 'wqkv'}: {n_heads} query and {n_kv} KV heads do not "
            f"split over {size} ranks (GQA stays aligned only when the KV "
            "heads divide the group, or one KV head is replicated)")
    return n_kv // size if n_kv % size == 0 else n_kv


def local_heads(n_heads: int, n_kv: int, size: int) -> tuple[int, int]:
    """(query heads, KV heads) of a rank's fused QKV tile over ``size``
    ranks: the layout ``shard_params`` cuts, and the models read."""
    return n_heads // size, _kv_local(n_heads, n_kv, size)


def _qkv_rows(n_heads: int, n_kv: int, head_dim: int, size: int,
              name: str) -> torch.Tensor:
    """The order of the fused QKV projection's N rows that puts rank r's
    q heads, then its k heads, then its v heads in its contiguous tile
    (an MQA head's rows in every rank's tile)."""
    kh = _kv_local(n_heads, n_kv, size, name)
    qh = n_heads // size
    q0, k0, v0 = 0, n_heads * head_dim, (n_heads + n_kv) * head_dim
    rows = []
    for r in range(size):
        kr = 0 if kh == n_kv else r
        rows += [torch.arange(q0 + r * qh * head_dim, q0 + (r + 1) * qh * head_dim),
                 torch.arange(k0 + kr * kh * head_dim, k0 + (kr + 1) * kh * head_dim),
                 torch.arange(v0 + kr * kh * head_dim, v0 + (kr + 1) * kh * head_dim)]
    return torch.cat(rows)


def _fused_tile(heads: tuple, size: int) -> int:
    """The N width of a rank's fused QKV tile: its query heads and its
    KV heads (the whole one of MQA)."""
    n_heads, n_kv, head_dim = heads
    qh, kh = local_heads(n_heads, n_kv, size)
    return (qh + 2 * kh) * head_dim


def _cut(t: torch.Tensor, axis: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[axis] // size
    return t.narrow(axis, rank * n, n).contiguous()


def _cut_packed(p: PackedNVFP4, axis: int, rank: int,
                size: int) -> PackedNVFP4:
    """A packed leaf's tile on a leading stored dim (an expert stack's E):
    codes and block scales cut alike, the tensor scale too where it varies
    along that dim (else it is broadcast and stays whole)."""
    ts = p.tensor_scale
    if ts.ndim >= -axis and ts.shape[axis] > 1:
        ts = _cut(ts, axis, rank, size)
    return PackedNVFP4(_cut(p.codes, axis, rank, size),
                       _cut(p.scales, axis, rank, size), ts.clone(), p.orig_k)


def _stored(spec: ParamSpec) -> tuple:
    """A packed leaf's codes shape: the non-contraction dims, then K/2."""
    full = list(spec.shape)
    k = full.pop(spec.contract_axis % len(full))
    return (*full, (k + (-k) % BLOCK) // 2)


def _axis(parts: tuple) -> int | None:
    """The dim (counted from the end) that splits, or None."""
    return parts.index(MODEL) - len(parts) if MODEL in parts else None


def _is_tile(name: str, held: tuple, full: tuple, axis: int | None,
             size: int, tile_n: int | None = None) -> bool:
    """False for a leaf held whole, True for one held as its tile on
    ``axis`` (``tile_n`` wide there: a fused QKV tile with a replicated
    KV head); any other shape raises (a wrongly cut leaf must not pass)."""
    if held == full:
        return False
    if axis is not None:
        tile = list(full)
        tile[axis] = tile_n if tile_n is not None else tile[axis] // size
        if held == tuple(tile):
            return True
    raise ValueError(f"{name or 'leaf'}: shape {held} is neither the whole "
                     f"{full} nor its tile over {size} ranks")


def _tile_n(name: str, heads: tuple | None, axis: int | None, n_axis: int,
            size: int) -> int | None:
    """A fused QKV leaf's tile width where it splits on its N dim
    (``n_axis``: -2 of packed codes, -1 of a dense weight or bias), or
    None for an even cut."""
    if heads and axis == n_axis and _fused(name):
        return _fused_tile(heads, size)
    return None


def shard_leaf(spec: ParamSpec, leaf, rank: int, size: int, rules: Rules,
               name: str = "", heads: tuple | None = None):
    """Rank ``rank``'s tile of one leaf.  A leaf already at its tile's
    shape is returned as it is, so a loader that cuts tiles as it builds
    the weights and the engine's own cut compose; a leaf of any other
    shape than the whole or the tile raises.

    ``heads``: (n_heads, n_kv_heads, head_dim) of the config; the fused
    QKV leaves (``_fused``) are regrouped by head first."""
    if isinstance(leaf, PackedNVFP4):
        axis = _axis(resolve_packed(spec, size, rules, name))
        tile_n = _tile_n(name, heads, axis, -2, size)
        if axis is None or _is_tile(name, tuple(leaf.codes.shape),
                                    _stored(spec), axis, size, tile_n):
            return leaf
        if axis == -1:
            return nvfp4.tp_tile(leaf, "row", rank, size)
        if axis != -2:
            return _cut_packed(leaf, axis, rank, size)
        rows = (_qkv_rows(*heads, size, name).to(leaf.codes.device)
                if tile_n is not None else None)
        return nvfp4.tp_tile(leaf, "column", rank, size, rows)
    axis = _axis(resolve(spec, size, rules, name))
    tile_n = _tile_n(name, heads, axis, -1, size)
    if axis is None or _is_tile(name, tuple(leaf.shape), tuple(spec.shape),
                                axis, size, tile_n):
        return leaf
    if tile_n is not None:
        leaf = leaf.index_select(-1, _qkv_rows(*heads, size, name).to(
            leaf.device))
    return _cut(leaf, axis % leaf.ndim, rank, size)


def shard_params(params, specs, tp, rules: Rules, heads: tuple | None = None):
    """Rank ``tp.rank``'s tree: every leaf's tile (``shard_leaf``), the
    leaves that do not split shared with ``params``.  The tree path is the
    warn-once key, so two parameters with the same axes each warn."""
    def walk(sp, pr, path):
        if isinstance(sp, dict):
            return {k: walk(sp[k], pr[k], f"{path}.{k}" if path else k)
                    for k in pr}
        return shard_leaf(sp, pr, tp.rank, tp.size, rules, path, heads)

    return walk(specs, params, "")


def shard_counts(specs, params, size: int, rules: Rules,
                 heads: tuple | None = None, state=None) -> dict:
    """Packed leaves, packed leaves this rank holds as tiles (read from the
    shapes held: column- and row-parallel weights must not silently
    replicate), packed leaves the rules keep whole (no dim of theirs maps
    to the group), and the tree's bytes over the group: a tile counts as
    the whole leaf, a replicated leaf once.  The MoE expert stacks
    (``EXPERT_STACKS``) are counted apart too: how many, how many held as
    tiles (on E or on the FFN dim), and their bytes on this rank.

    ``heads``: as ``shard_leaf`` takes it (a fused QKV tile may hold a
    replicated KV head).  ``state``: (slot-state specs, the rank's slab
    tree), each leaf counted as split or whole (``local_specs``'s shape,
    or the whole spec's): "state_leaves" {path: {"split", "bytes"}},
    "state_total", "state_sharded"."""
    out = {"packed_total": 0, "packed_sharded": 0, "packed_rule_whole": 0,
           "weight_bytes_total": 0, "expert_total": 0, "expert_sharded": 0,
           "expert_bytes": 0}

    def walk(sp, pr, path):
        if isinstance(sp, dict):
            for k in pr:
                walk(sp[k], pr[k], f"{path}.{k}" if path else k)
            return
        with warnings.catch_warnings():        # warned when it was cut
            warnings.simplefilter("ignore")
            if isinstance(pr, PackedNVFP4):
                axis = _axis(resolve_packed(sp, size, rules, path))
                tile_n = _tile_n(path, heads, axis, -2, size)
                held = tuple(pr.codes.shape)
                split = _is_tile(path, held, _stored(sp), axis, size, tile_n)
                out["packed_total"] += 1
                out["packed_sharded"] += split
                out["packed_rule_whole"] += not any(
                    MODEL in rules.axes_for(a) for a in sp.axes)
                tiles = pr.codes.numel() + pr.scales.numel()   # 1 B each
                nbytes = tiles + pr.tensor_scale.numel() * 4
                whole = (tiles // held[-2] * _stored(sp)[-2] if tile_n
                         else tiles * (size if split else 1))
                out["weight_bytes_total"] += (whole
                                              + pr.tensor_scale.numel() * 4)
            else:
                axis = _axis(resolve(sp, size, rules, path))
                tile_n = _tile_n(path, heads, axis, -1, size)
                split = _is_tile(path, tuple(pr.shape), tuple(sp.shape),
                                 axis, size, tile_n)
                nbytes = pr.numel() * pr.element_size()
                out["weight_bytes_total"] += (
                    nbytes // pr.shape[-1] * sp.shape[-1] if tile_n
                    else nbytes * (size if split else 1))
        if path.rsplit(".", 1)[-1] in EXPERT_STACKS:
            out["expert_total"] += 1
            out["expert_sharded"] += split
            out["expert_bytes"] += nbytes

    walk(specs, params, "")
    if state is not None:
        out.update(_state_counts(*state, size, rules))
    return out


def local_shape(spec: ParamSpec, size: int, rules: Rules,
                name: str = "") -> tuple:
    """A slot-state leaf's shape on one rank: its first dim that the rules
    split over the group and that divides, cut ``size`` ways; a head's dim
    ("headdim") is never cut (head-local attention holds whole heads)."""
    rules = Rules({**rules.table, "headdim": ()})
    parts = resolve(spec, size, rules, name)
    return tuple(d // size if p == MODEL else d
                 for d, p in zip(spec.shape, parts))


def local_specs(specs, size: int, rules: Rules):
    """A slot-state spec tree at each leaf's local shape (``local_shape``):
    the slabs one rank allocates."""
    def walk(sp, path):
        if isinstance(sp, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in sp.items()}
        return dataclasses.replace(sp, shape=local_shape(sp, size, rules,
                                                         path))
    return walk(specs, "")


def _state_counts(specs, data, size: int, rules: Rules) -> dict:
    """Each slab leaf split (held at its local shape) or whole, and its
    bytes on this rank; any other shape raises."""
    leaves = {}

    def walk(sp, d, path):
        if isinstance(sp, dict):
            for k in sp:
                walk(sp[k], d[k], f"{path}.{k}" if path else k)
            return
        with warnings.catch_warnings():        # warned when it was cut
            warnings.simplefilter("ignore")
            loc = local_shape(sp, size, rules, path)
        held = tuple(d.shape)
        if held not in (tuple(sp.shape), loc):
            raise ValueError(f"state {path}: shape {held} is neither the "
                             f"whole {tuple(sp.shape)} nor its tile {loc}")
        leaves[path] = {"split": held != tuple(sp.shape),
                        "bytes": d.numel() * d.element_size()}

    walk(specs, data, "")
    return {"state_leaves": leaves, "state_total": len(leaves),
            "state_sharded": sum(v["split"] for v in leaves.values())}
