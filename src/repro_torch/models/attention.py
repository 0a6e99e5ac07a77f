"""Attention: GQA, blockwise softmax, dense KV cache and the paged KV pool
(port of ``repro.models.attention``, lines 27-219 and 266-380).

The reference computes attention in plain jnp, outside any Pallas kernel,
so the port computes it in plain torch: the same chunked online softmax for
prompts, one query against the cache for decode.  Scores and the
probability-value product take bf16 operands with f32 accumulation: the
operands are cast to f32 (a bf16 x bf16 product is exact in f32).

The cache is a dict of tensors ``{"k", "v"}`` [L, B, S_max, Hkv, hd] and
is updated IN PLACE by ``cache_update_layer`` (the reference returns a new
array); a sliding-window cache is a ring of ``window`` positions, slot
``p % window`` holding position ``p``.  The slab engine's per-row write,
``cache_update_slots``, makes new tensors instead: a slab tree may be held
as a snapshot.  The paged pool is updated in place too.

FP8 KV (the ``moe_hybrid`` recipe): a cache or pool layer then holds E4M3
``k``/``v`` and f32 ``k_scale``/``v_scale`` [..., Hkv], one scale per
(position, head) row, written through ``_quant_kv`` (``core.nvfp4.
fp8_quantize``, bitwise the jitted reference) and read through
``_dequant_kv``.  Writes into E4M3 tensors go through their uint8 views:
the bytes move unchanged, and indexed copies and selects take them on
every device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import nvfp4
from ..kernels import ops
from ..kernels import paged_attention as kpa

NEG_INF = -1e30


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _scale(hd: int) -> float:
    """1 / sqrt(hd) computed in f32, as the reference does (a Python float
    holding that f32 value: no host-to-device copy per call)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        q_offset: int = 0,
                        kv_valid: int | None = None) -> torch.Tensor:
    """q: [B,Sq,H,hd], k/v: [B,Sk,Hkv,hd] -> [B,Sq,H,hd].

    Online softmax over kv chunks, per q chunk; padded keys are masked.
    ``q_offset`` is the absolute position of q[0] (a chunk of a longer
    prompt), ``window`` > 0 masks keys ``window`` or more positions older
    than the query, ``kv_valid`` masks keys at positions >= it (k and v
    may be a right-padded allocation).  A fully masked kv chunk adds
    exactly nothing: its probabilities are 0.0 and the max unchanged.
    """
    b, sq0, h, hd = q.shape
    sk0, hkv = k.shape[1], k.shape[2]
    k, v = repeat_kv(k, h // hkv), repeat_kv(v, h // hkv)
    q_chunk, kv_chunk = min(q_chunk, sq0), min(kv_chunk, sk0)
    pq, pk = (-sq0) % q_chunk, (-sk0) % kv_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    sq, sk = sq0 + pq, sk0 + pk
    dev = q.device
    scale = _scale(hd)

    qh = q.transpose(1, 2)                       # [B,H,Sq,hd]
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    q_pos = torch.arange(sq, device=dev) + q_offset
    k_pos = torch.arange(sk, device=dev)
    n_keys = sk0 if kv_valid is None else kv_valid
    outs = []
    for q0 in range(0, sq, q_chunk):
        qi = qh[:, :, q0:q0 + q_chunk].to(torch.float32)
        qpos = q_pos[q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32, device=dev)
        for k0 in range(0, sk, kv_chunk):
            ki = kh[:, :, k0:k0 + kv_chunk].to(torch.float32)
            vi = vh[:, :, k0:k0 + kv_chunk].to(torch.float32)
            kpos = k_pos[k0:k0 + kv_chunk]
            s = (qi @ ki.transpose(-1, -2)) * scale
            mask = (kpos[None, :] < n_keys).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m2 = torch.maximum(m, torch.amax(s, -1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + torch.sum(p, -1)
            pv = p.to(q.dtype).to(torch.float32) @ vi
            acc = acc * corr[..., None] + pv
            m = m2
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.cat(outs, 2).transpose(1, 2)     # [B,Sq,H,hd]
    return out[:, :sq0].to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def _quant_kv(x):
    """[B, S, H, hd] -> (e4m3 values, [B, S, H] f32 scales), one scale per
    (position, head) row."""
    t = nvfp4.fp8_quantize(x, dim=-1)
    return t.values, t.scale[..., 0]


def _dequant_kv(vals, scale, dtype=torch.bfloat16):
    return nvfp4.fp8_dequantize(nvfp4.FP8Tensor(vals, scale[..., None]), dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An E4M3 tensor's uint8 view (the same storage); others as they are."""
    return t.view(torch.uint8) if t.dtype == nvfp4.FP8_E4M3 else t


def _stored(layer_cache: dict, k_new, v_new) -> dict:
    """What a write stores for new kv [B, S, Hkv, hd]: {"k", "v"} in the
    cache's dtype, and for an FP8 cache the quantized values with their
    "k_scale", "v_scale" [B, S, Hkv]."""
    if layer_cache.get("k_scale") is None:
        dt = layer_cache["k"].dtype
        return {"k": k_new.to(dt), "v": v_new.to(dt)}
    kq, ks = _quant_kv(k_new)
    vq, vs = _quant_kv(v_new)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def cache_update_layer(layer_cache: dict, k_new, v_new, pos: int) -> dict:
    """Write new kv at positions [pos, pos + S) of one layer's cache slice
    {k, v[, k_scale, v_scale]} [B, S_max, Hkv, hd], IN PLACE; returns the
    same dict."""
    for name, new in _stored(layer_cache, k_new, v_new).items():
        s = new.shape[1]
        _bytes(layer_cache[name])[:, pos:pos + s] = _bytes(new)
    return layer_cache


def ring_align(a: torch.Tensor, window: int) -> torch.Tensor:
    """The last ``window`` positions of a [B, S, ...] prompt KV with
    S > window, laid out as the ring keeps them: slot ``p % window``
    holds position ``p``."""
    s = a.shape[1]
    return torch.roll(a[:, s - window:], s % window, 1)


def cache_prefill_layer(layer_cache: dict, k_new, v_new, window: int = 0) -> dict:
    """Write a prompt's kv [B, S, Hkv, hd] into one layer's cache slice,
    IN PLACE, from slot 0; a windowed layer whose prompt outruns its ring
    keeps the last ``window`` positions, ring-aligned."""
    if window and k_new.shape[1] > window:
        k_new, v_new = ring_align(k_new, window), ring_align(v_new, window)
    return cache_update_layer(layer_cache, k_new, v_new, 0)


def cache_update_slots(layer_cache: dict, k_new, v_new, positions,
                       active) -> dict:
    """Per-row decode write into a dense [B, S_alloc, Hkv, hd] cache layer:
    row b's k_new/v_new [B, 1, Hkv, hd] at slot ``positions[b]`` (ring
    callers pass ``pos % S_alloc``); inactive rows keep their values (the
    reference drops their writes).  An FP8 layer stores ``_quant_kv``'s
    values and scales, the bits ``cache_update_layer`` stores.  Returns a
    new dict of NEW tensors (an exact select, as the reference's
    out-of-place scatter): the given cache is not written."""
    s_alloc = layer_cache["k"].shape[1]
    slot = torch.arange(s_alloc, device=positions.device)
    hit = (slot[None, :] == positions[:, None]) & active[:, None]
    out = dict(layer_cache)
    for name, new in _stored(layer_cache, k_new, v_new).items():
        old = layer_cache[name]
        sel = hit.reshape(*hit.shape, *([1] * (old.ndim - 2)))
        out[name] = torch.where(sel, _bytes(new), _bytes(old)).view(old.dtype)
    return out


def cache_read_layer(layer_cache: dict, dtype=torch.bfloat16):
    if layer_cache.get("k_scale") is not None:
        return (_dequant_kv(layer_cache["k"], layer_cache["k_scale"], dtype),
                _dequant_kv(layer_cache["v"], layer_cache["v_scale"], dtype))
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)


def decode_attend(q, layer_cache: dict, pos, *, window: int = 0) -> torch.Tensor:
    """One-token decode: q [B,1,H,hd] against cache [B,S_max,Hkv,hd].

    ``pos``: number of valid cache positions (the new token's kv already
    written), an int for every row or a [B] tensor, one per row.  A
    windowed cache is a ring: slot i holds the most recent position
    p(i) = i + S_max * floor((pos - 1 - i) / S_max), valid when
    pos - window <= p(i) < pos.  The mask is integer arithmetic, so the
    per-row form equals the scalar form row by row.  The two products run
    one batch row at a time (``_per_row``), so a row's output does not
    depend on how many rows share the call.
    """
    k, v = cache_read_layer(layer_cache, q.dtype)
    b, s_max, hkv, hd = k.shape
    h = q.shape[2]
    k, v = repeat_kv(k, h // hkv), repeat_kv(v, h // hkv)
    dev = q.device
    s = _per_row("bqhd,bkhd->bhqk", q.to(torch.float32),
                 k.to(torch.float32)) * _scale(hd)
    slot = torch.arange(s_max, device=dev)[None, :]        # [1, S_max]
    rpos = pos[:, None] if torch.is_tensor(pos) else pos    # [B, 1] or int
    if window:
        newest = rpos - 1
        abs_pos = slot + s_max * torch.div(newest - slot, s_max,
                                           rounding_mode="floor")
        valid = ((abs_pos >= 0) & (abs_pos >= rpos - window)
                 & (abs_pos <= newest))
    else:
        valid = slot < rpos
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, -1)
    out = _per_row("bhqk,bkhd->bqhd", p.to(q.dtype).to(torch.float32),
                   v.to(torch.float32))
    return out.to(q.dtype)


def _per_row(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` for operands with a leading batch axis, one
    batch row a call.  cuBLAS picks its batched kernel by the batch count,
    so a row's sums would depend on how many rows share the call: on an
    H100 the slab engine's decode at 4 slots parted from batch-1
    ``serve_batch`` through this product alone (``chip_smoke.py`` phase 5f,
    ROADMAP C.1 (b)).  One row a call gives every row the batch-1 result."""
    if a.shape[0] == 1:
        return torch.einsum(eq, a, b)
    return torch.cat([torch.einsum(eq, a[i:i + 1], b[i:i + 1])
                      for i in range(a.shape[0])])


# ---------------------------------------------------------------------------
# Paged KV pool (continuous-batching engine; reference lines 266-380)
#
# One layer of the pool is {"k", "v": [n_blocks, bs, Hkv, hd]} (+ f32
# "k_scale"/"v_scale" [n_blocks, bs, Hkv] for FP8 pages).  A request's block
# table maps position p to (table[p // bs], p % bs); the slot of the
# gathered view IS the absolute position, so masking is position
# arithmetic.
# ---------------------------------------------------------------------------


def paged_write_plan(block_tables, positions, active, bs: int):
    """Where the active entries of a [B] or [B, S] write land: (src, dst),
    ``src`` indexing the flattened [B * S] new rows and ``dst`` the
    flattened [n_blocks * bs] pool slots.  Inactive entries are dropped,
    as the reference's out-of-bounds scatter drops them.  Computed once
    per forward and shared by every layer (one host sync)."""
    if positions.ndim == 1:
        positions = positions[:, None]
    active = torch.broadcast_to(active[:, None] if active.ndim == 1 else active,
                                positions.shape)
    mb = block_tables.shape[1]
    page = torch.clamp(positions // bs, 0, mb - 1).long()
    blk = torch.gather(block_tables.long(), 1, page)
    src = torch.nonzero(active.reshape(-1)).reshape(-1)
    dst = (blk * bs + positions % bs).reshape(-1)[src]
    return src, dst


def paged_scatter(pool_sl: dict, k_new, v_new, plan) -> dict:
    """Write k_new/v_new [B, S, Hkv, hd] into a pool layer IN PLACE along a
    ``paged_write_plan``; an FP8 pool stores ``_quant_kv``'s values and
    scales, the bits the dense cache stores.  Returns the same dict."""
    src, dst = plan
    for name, new in _stored(pool_sl, k_new, v_new).items():
        page = _bytes(pool_sl[name])
        flat = page.view(-1, *page.shape[2:])       # [n_blocks * bs, ...]
        rows = _bytes(new).reshape(-1, *new.shape[2:])[src]
        flat.index_copy_(0, dst, rows)
    return pool_sl


def paged_update_layer(pool_sl: dict, k_new, v_new, block_tables, positions,
                       active) -> dict:
    """Scatter new KV for S >= 1 positions per batch row into a pool layer,
    IN PLACE (the reference returns a new pool).

    k_new/v_new [B, S, Hkv, hd]; positions [B] (S == 1) or [B, S] absolute
    write positions; active [B] or [B, S]: inactive entries are dropped,
    never touching live blocks.
    """
    plan = paged_write_plan(block_tables, positions, active,
                            pool_sl["k"].shape[1])
    return paged_scatter(pool_sl, k_new, v_new, plan)


def paged_gather_layer(pool_sl: dict, block_tables, dtype=torch.bfloat16):
    """Dense per-request views [B, MB * bs, Hkv, hd] of the pool pages,
    FP8 pages dequantized to ``dtype``.  Table entries of unallocated
    logical blocks may be any in-range id: callers mask by position."""
    return kpa.gather(pool_sl, block_tables, dtype)


def paged_attend(q, pool_sl: dict, block_tables, pos, *, window: int = 0):
    """Decode/verify attention against the paged pool, the gather-then-
    attend two-step: q [B, S, H, hd].

    ``pos``: per-query valid-key counts, [B] for every query of a row (the
    one-token decode step) or [B, S] (verify and paged prefill pass
    lens + i + 1 for query i: the causal mask within the chunk).  Masked
    keys reach the softmax as exp(-1e30 - max) = 0, so a query's output
    does not depend on how many blocks its table addresses.  ``window``
    masks by absolute position.  The arithmetic is ``decode_attend``'s,
    with a per-(row, query) mask; several queries a row are attended one
    at a time (``kernels.paged_attention.plain`` says why), so query i is
    bitwise a one-token decode's.
    """
    if q.shape[1] > 1:
        qpos = torch.broadcast_to(pos[:, None] if pos.ndim == 1 else pos,
                                  q.shape[:2])
        return torch.cat([paged_attend(q[:, i:i + 1], pool_sl, block_tables,
                                       qpos[:, i], window=window)
                          for i in range(q.shape[1])], 1)
    k, v = paged_gather_layer(pool_sl, block_tables, q.dtype)
    b, s_alloc, hkv, hd = k.shape
    h = q.shape[2]
    k, v = repeat_kv(k, h // hkv), repeat_kv(v, h // hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * _scale(hd)
    slot = torch.arange(s_alloc, device=q.device)
    qpos = pos[:, None] if pos.ndim == 1 else pos      # [B, 1] or [B, S]
    valid = slot[None, None, :] < qpos[:, :, None]      # [B, S|1, S_alloc]
    if window:
        valid = valid & (slot[None, None, :] >= qpos[:, :, None] - window)
    s = torch.where(valid[:, None, :, :], s, NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def paged_attend_fused(q, pool_sl: dict, block_tables, pos, *, window: int = 0):
    """``paged_attend`` through the ``paged_attention`` kernel (K7): gather,
    FP8 dequant and attend in one launch, no dense copy of the pages.  On
    CPU tensors it runs the kernel's plain version."""
    return ops.paged_attention(q, pool_sl, block_tables, pos, window=window)
