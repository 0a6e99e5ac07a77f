"""Logical-axis sharding rules with a divisibility fallback, and each
rank's tiles (port of ``repro.distributed.sharding``: ``make_rules``'s
four tables, ``resolve``, ``resolve_packed``, the warn-once fallback,
``ShapeOnlyMesh``, ``partition_factor``, ``device_bytes``,
``shard_params``, and the counterparts of ``tree_shardings`` and
``batch_specs_to_shardings`` for the training mesh).

Parameters carry logical axis names (``ParamSpec.axes``); the rules map a
name to mesh axes.  Two forms of ``resolve``:

  * over a named mesh shape (``ShapeOnlyMesh``, or any object with
    ``shape`` and ``axis_names``): the reference's, letter for letter.
    Per dim, the greedy largest prefix of the rule's axes whose product
    divides the dim, a mesh axis used once per spec; the result is the
    ``PartitionSpec``'s entries as a tuple (None, one axis name, or a
    tuple of names).  ``partition_factor`` prices it.
  * over a tensor-parallel group's ``size`` (an int; the serving engine's
    form): per dim, "model" where that dim splits over the group and None
    where it stays whole, dropping "model" where the size does not
    divide the dim.

Each drop warns once per parameter: a silently replicated weight is how
TP regressions hide.  ``resolve_packed`` does the same for a
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

The training mesh (``distributed.ctx.Mesh``, data x model ranks): a
leaf's ``Placement`` names the dim its data axis splits and the dim the
model axis splits.  ``tree_shards`` cuts each rank's stored shard: the
model tile ``shard_leaf`` cuts (the fused QKV regrouped by head), then
the data rank's slice of it (ZeRO-3: only the stored shards live between
steps).  ``gather_tiles`` all-gathers the shards over the data group back
into model tiles before a forward, ``gather_full`` the whole leaves.
``batch_rows`` is a data rank's rows of the global batch
(``fault.host_batch_slices``).  ``constrain`` has no counterpart, as
``ctx.cst`` has none: no activation is resharded implicitly.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Mapping

import numpy as np
import torch

from ..core import nvfp4
from ..core.nvfp4 import BLOCK, PackedNVFP4
from ..models.common import ParamSpec, tree_leaves, tree_map

MODEL = "model"
DATA = "data"
POD = "pod"
RULE_MODES = ("fsdp_tp", "fsdp_only", "tp_only", "dp_only")
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


def make_rules(mode: str = "tp_only", mesh=None) -> Rules:
    """The reference's tables: ``fsdp_tp`` (weights on "model" along their
    tensor-parallel dim and on the data axes along ``embed``, the batch on
    the data axes), ``fsdp_only`` (every weight dim and the batch on the
    data axes), ``tp_only`` (weights replicated but the tensor-parallel
    dims; the serving engine's) and ``dp_only`` (only the batch split).
    The data axes are ("pod", "data") where ``mesh`` has a "pod" axis."""
    names = tuple(getattr(mesh, "axis_names", ()) or ())
    dp = (POD, DATA) if POD in names else (DATA,)
    tp = (MODEL,)
    if mode == "fsdp_tp":
        table = {
            "batch": dp, "embed": dp,
            "vocab": tp, "mlp": tp, "qkv": tp, "heads": tp, "kv": tp,
            "expert": tp, "rnn": tp, "headdim": tp,
            "seq": (), "layers": (), "inner": (), "none": (),
        }
    elif mode == "fsdp_only":
        table = {"batch": dp, "embed": dp, "vocab": dp, "mlp": dp,
                 "qkv": dp, "heads": dp, "kv": dp, "expert": dp, "rnn": dp,
                 "headdim": dp, "seq": (), "layers": (), "inner": (),
                 "none": ()}
    elif mode == "tp_only":
        table = {"batch": dp,
                 "vocab": tp, "mlp": tp, "qkv": tp, "heads": tp, "kv": tp,
                 "expert": tp, "rnn": tp, "headdim": tp,
                 "embed": (), "seq": (), "layers": (), "inner": (),
                 "none": ()}
    elif mode == "dp_only":
        table = {"batch": dp, "embed": (), "vocab": (), "mlp": (), "qkv": (),
                 "heads": (), "kv": (), "expert": (), "rnn": (), "headdim": (),
                 "seq": (), "layers": (), "inner": (), "none": ()}
    else:
        raise ValueError(mode)
    return Rules(table)


class ShapeOnlyMesh:
    """A mesh of names and sizes only (``shape``, ``axis_names``), for the
    sharding arithmetic: ``resolve`` and ``partition_factor`` never touch a
    device or a process group."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def partition_factor(parts: tuple, mesh) -> int:
    """How many ways the mesh-form ``resolve``'s entries split a tensor."""
    f = 1
    for entry in parts:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            f *= int(mesh.shape[a])
    return f


_FALLBACK_WARNED: set = set()


def _warn_fallback(param: str, ax_name: str, dim: int, sizes) -> None:
    """Warn once per (param, logical axis, dropped axis sizes) when a dim
    that the rules would split stays whole on some mesh axes (``sizes``:
    an int, the group's size on "model", or {axis: size})."""
    if isinstance(sizes, int):
        sizes = {MODEL: sizes}
    key = (param, ax_name, tuple(sorted(sizes.items())))
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(
        f"sharding fallback: param {param!r} dim {dim} (logical axis "
        f"{ax_name!r}) drops mesh axes {sizes} — stays replicated on them",
        RuntimeWarning, stacklevel=3)


def _assign_axes(dim: int, want: list, mesh, divides=None) -> tuple:
    """The greedy largest prefix of ``want`` whose product divides ``dim``
    (``divides(prod)`` in its place for the packed K dim)."""
    for k in range(len(want), 0, -1):
        cand = tuple(want[:k])
        prod = math.prod(int(mesh.shape[a]) for a in cand)
        if divides(prod) if divides is not None else dim % prod == 0:
            return cand
    return ()


def _entry(assigned: tuple):
    """A ``PartitionSpec`` entry: one axis name, a tuple of names, or None."""
    return assigned[0] if len(assigned) == 1 else (assigned or None)


def _resolve_mesh(spec: ParamSpec, mesh, rules: Rules, name: str) -> tuple:
    used: set = set()
    out = []
    for dim, ax_name in zip(spec.shape, spec.axes):
        want = [a for a in rules.axes_for(ax_name) if a not in used]
        assigned = _assign_axes(dim, want, mesh)
        if len(assigned) < len(want):
            _warn_fallback(name or f"{spec.axes}{spec.shape}", ax_name, dim,
                           {a: int(mesh.shape[a])
                            for a in want[len(assigned):]})
        out.append(_entry(assigned))
        used.update(assigned)
    return tuple(out)


def resolve(spec: ParamSpec, size, rules: Rules, name: str = "") -> tuple:
    """Per dim, where it splits.  ``size`` an int (a tensor-parallel
    group): "model" where the dim splits ``size`` ways, else None (the
    first dim that wants the axis and divides takes it).  ``size`` a mesh
    (``ShapeOnlyMesh``): the reference's ``PartitionSpec`` entries."""
    if not isinstance(size, int):
        return _resolve_mesh(spec, size, rules, name)
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


def _resolve_packed_mesh(spec: ParamSpec, mesh, rules: Rules,
                         name: str) -> tuple:
    ax = spec.contract_axis % len(spec.shape)
    k = spec.shape[ax]
    kp = k + (-k) % BLOCK
    used: set = set()
    parts = []
    pname = name or f"{spec.axes}{spec.shape}"
    for i, (dim, ax_name) in enumerate(zip(spec.shape, spec.axes)):
        if i == ax:
            continue
        want = [a for a in rules.axes_for(ax_name) if a not in used]
        assigned = _assign_axes(dim, want, mesh)
        if len(assigned) < len(want):
            _warn_fallback(pname, ax_name, dim, {
                a: int(mesh.shape[a]) for a in want[len(assigned):]})
        parts.append(assigned)
        used.update(assigned)
    want_k = [a for a in rules.axes_for(spec.axes[ax]) if a not in used]

    def div_k(prod: int) -> bool:
        return (k == kp and (kp // 2) % prod == 0
                and (kp // BLOCK) % prod == 0)

    k_assigned = _assign_axes(kp, want_k, mesh, divides=div_k)
    if len(k_assigned) < len(want_k):
        _warn_fallback(pname, f"{spec.axes[ax]} (packed K)", k, {
            a: int(mesh.shape[a]) for a in want_k[len(k_assigned):]})
    codes = (*[_entry(a) for a in parts], _entry(k_assigned))
    return codes, codes, ()


def resolve_packed(spec: ParamSpec, size, rules: Rules,
                   name: str = "") -> tuple:
    """Per stored dim of a ``PackedNVFP4`` leaf (the non-contraction dims
    in order, then K), "model" or None over a group of ``size``; codes and
    scales share it and the tensor scale is replicated.  K splits only
    when every shard owns whole 16-element blocks and K is not padded.
    ``size`` a mesh: the reference's (codes, scales, tensor_scale)
    ``PartitionSpec`` entries."""
    if not isinstance(size, int):
        return _resolve_packed_mesh(spec, size, rules, name)
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


# ---------------------------------------------------------------------------
# the training mesh: each rank's stored shards (the counterparts of
# ``tree_shardings`` and ``batch_specs_to_shardings``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lies on a data x model mesh: the dim the data axis
    splits and the dim the model axis splits (None where it stays whole),
    and the ``partition_factor``: the ranks that hold distinct pieces."""
    data_dim: int | None
    model_dim: int | None
    factor: int


def placement(spec: ParamSpec, shape: Mapping[str, int], rules: Rules,
              name: str = "") -> Placement:
    """A leaf's ``Placement`` on a runtime mesh of ``shape``
    ({"data": D, "model": M}), by the mesh form of ``resolve``."""
    mesh = ShapeOnlyMesh(shape)
    parts = resolve(spec, mesh, rules, name)
    dims = {DATA: None, MODEL: None}
    for i, entry in enumerate(parts):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dims[a] = i
    return Placement(dims[DATA], dims[MODEL], partition_factor(parts, mesh))


def placements(specs, shape: Mapping[str, int], rules: Rules):
    """A ``Placement`` for every leaf of a spec tree (its dotted path the
    warn-once key)."""
    def walk(sp, path):
        if isinstance(sp, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in sp.items()}
        return placement(sp, shape, rules, path)
    return walk(specs, "")


def replication(pl: Placement, shape: Mapping[str, int]) -> int:
    """How many ranks of the mesh hold the same shard of a leaf."""
    return math.prod(shape.values()) // pl.factor


def shard_tensor(spec: ParamSpec, leaf: torch.Tensor, mesh, rules: Rules,
                 name: str = "", heads: tuple | None = None) -> torch.Tensor:
    """Rank ``mesh``'s stored shard of one dense leaf: its model tile
    (``shard_leaf``: the fused QKV regrouped by head), then the data
    rank's slice of the tile along the placement's data dim."""
    shape, c = mesh.shape, mesh.coords
    pl = placement(spec, shape, rules, name)
    if pl.model_dim is not None and shape[MODEL] > 1:
        axis = _axis(resolve(spec, shape[MODEL], rules, name))
        if axis is None or axis % len(spec.shape) != pl.model_dim:
            raise ValueError(f"{name or 'leaf'}: the model dim {pl.model_dim} "
                             f"of the mesh's resolve is not the group's {axis}")
        leaf = shard_leaf(spec, leaf, c[MODEL], shape[MODEL], rules, name,
                          heads)
    if pl.data_dim is not None and shape[DATA] > 1:
        leaf = _cut(leaf, pl.data_dim, c[DATA], shape[DATA])
    return leaf


def tree_shards(params, specs, mesh, rules: Rules, heads: tuple | None = None):
    """Rank ``mesh``'s stored shard of every leaf of ``params`` (whole
    leaves: ``shard_tensor``)."""
    def walk(sp, pr, path):
        if isinstance(sp, dict):
            return {k: walk(sp[k], pr[k], f"{path}.{k}" if path else k)
                    for k in pr}
        return shard_tensor(sp, pr, mesh, rules, path, heads)
    return walk(specs, params, "")


def gather_tiles(shards, places, mesh):
    """The model tiles of a tree of stored shards: each leaf all-gathered
    over the data group along its data dim (the shard itself where the
    leaf does not split over data)."""
    def one(x, pl):
        if pl.data_dim is None or mesh.data.size == 1:
            return x
        return mesh.data.all_gather(x, pl.data_dim)
    return tree_map(one, shards, places)


def replicated_cols(spec: ParamSpec, pl: Placement, shape: Mapping[str, int],
                    name: str, heads: tuple | None) -> slice | None:
    """The columns of a leaf's model tile that every model rank holds a
    copy of: an MQA fused QKV tile's one KV head (``_kv_local``), its k
    and v rows after the rank's query heads; None for any other leaf.
    Their gradient is summed over the model group (each rank's is the
    partial of its own query heads) and they count once in a norm."""
    m = shape[MODEL]
    if (heads is None or not _fused(name) or m == 1
            or pl.model_dim != len(spec.shape) - 1):
        return None
    n_heads, n_kv, head_dim = heads
    qh, kh = local_heads(n_heads, n_kv, m)
    if kh != n_kv or n_kv % m == 0:
        return None
    return slice(qh * head_dim, (qh + 2 * kh) * head_dim)


def replicated_tree(specs, places, shape: Mapping[str, int],
                    heads: tuple | None):
    """``replicated_cols`` of every leaf of a spec tree."""
    def walk(sp, pl, path):
        if isinstance(sp, dict):
            return {k: walk(sp[k], pl[k], f"{path}.{k}" if path else k)
                    for k in sp}
        return replicated_cols(sp, pl, shape, path, heads)
    return walk(specs, places, "")


def reduce_to_shards(tile_grads, places, mesh, replicated=None):
    """Gradients of the model tiles summed over the data group, each rank
    keeping its stored shard: the data rank's slice where the leaf splits
    over data (the f32 sum of every rank's slice, in rank order), the
    whole sum where it is replicated there (every rank the same bits).
    ``replicated`` (``replicated_tree``): a tile's columns that every
    model rank holds are first summed over the model group."""
    dp, tp = mesh.data, mesh.model

    def one(g, pl, cols=None):
        if cols is not None:
            g = g.clone()
            g[..., cols] = tp.all_reduce(g[..., cols])
        if dp.size == 1:
            return g
        if pl.data_dim is None:
            return dp.all_reduce(g)
        return dp.reduce_scatter(g, pl.data_dim)
    if replicated is None:
        return tree_map(one, tile_grads, places)
    return tree_map(lambda g, pl, c: one(g, pl, c), tile_grads, places,
                    replicated)


def _qkv_order(heads: tuple, size: int, name: str) -> torch.Tensor:
    """The positions in the model tiles gathered in rank order that put a
    fused QKV leaf's N rows back in their order: each row's first copy
    (an MQA KV head's, rank 0's)."""
    rows = _qkv_rows(*heads, size, name).numpy()
    return torch.from_numpy(np.unique(rows, return_index=True)[1])


def gather_full(shards, specs, places, mesh, rules: Rules,
                heads: tuple | None = None, leaf_fn=None):
    """Whole leaves from a tree of stored shards, on every rank: each
    leaf's model tile (its shard all-gathered over the data group, as
    ``gather_tiles`` does) all-gathered over the model group, the fused
    QKV's rows put back in their order.  Leaf by leaf: ``leaf_fn`` (say,
    a copy to the host, or None on the ranks that do not keep it) takes
    each whole leaf as it is made, so one whole leaf at a time is alive
    on the device."""
    dp, tp = mesh.data, mesh.model

    def walk(sp, x, pl, path):
        if isinstance(sp, dict):
            return {k: walk(sp[k], x[k], pl[k], f"{path}.{k}" if path else k)
                    for k in x}
        if pl.data_dim is not None and dp.size > 1:
            x = dp.all_gather(x, pl.data_dim)
        if pl.model_dim is not None and tp.size > 1:
            x = tp.all_gather(x, pl.model_dim)
            if heads and _fused(path) and pl.model_dim == len(sp.shape) - 1:
                x = x.index_select(-1, _qkv_order(heads, tp.size, path).to(
                    x.device))
        return x if leaf_fn is None else leaf_fn(x)
    return walk(specs, shards, places, "")


def batch_rows(batch: dict, mesh) -> dict:
    """A data rank's rows of the global batch (every tensor's leading
    dim): ``fault.host_batch_slices`` over the data group."""
    from .fault import host_batch_slices

    lo, hi = host_batch_slices(next(iter(batch.values())).shape[0],
                               mesh.shape[DATA])[mesh.coords[DATA]]
    return {k: v[lo:hi] for k, v in batch.items()}


def stored_share(tree, specs, places, heads: tuple | None = None,
                 shape: Mapping[str, int] | None = None) -> tuple[int, int]:
    """(bytes a rank holds of a tree of stored shards, the bytes it should
    hold: each leaf's whole size in its stored dtype over the leaf's
    partition factor; an MQA fused QKV leaf's model tile holds its KV
    head whole beside the rank's query heads (``_kv_local``), counted so
    with ``heads`` and the mesh ``shape``)."""
    held = share = 0
    for (path, sp), leaf, pl in zip(_paths(specs), tree_leaves(tree),
                                    tree_leaves(places)):
        held += leaf.numel() * leaf.element_size()
        n = math.prod(sp.shape)
        if (heads is not None and shape is not None
                and replicated_cols(sp, pl, shape, path, heads) is not None):
            n = (n // sp.shape[-1] * _fused_tile(heads, shape[MODEL])
                 * shape[MODEL])
        share += n * leaf.element_size() // pl.factor
    return held, share


def _paths(specs, path: str = "") -> list:
    """(dotted path, spec) of every leaf of a spec tree, in
    ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _paths(specs[k], f"{path}.{k}" if path else k)]
    return [(path, specs)]
