"""Decoder-only LM, dense and MoE families (port of
``repro.models.decoder``).

The same functional protocol and parameter tree as the reference:

    param_specs(cfg)                          -> ParamSpec tree
    init_params(cfg, gen, device)             -> params
    apply(cfg, params, batch, qcfg, output)   -> [B, S, V] logits (or hidden)
    init_cache(cfg, batch, s_max, device)     -> cache
    prefill(cfg, params, batch, qcfg, s_max)  -> (last-token logits, cache)
    decode_step(cfg, params, cache, batch, qcfg) -> (logits, cache)
    decode_step_paged / verify_step_paged  -> (logits, pool)

``decode_step`` and ``prefill`` write the KV cache IN PLACE; the cache's
``pos`` is a Python int.  A sliding-window layer (``cfg.window``, the
local attention of the ``rglru_hybrid`` family) keeps a ring of
``window`` positions.

Under a tensor-parallel context (``distributed.ctx``) ``params`` holds
this rank's tiles: attention takes its head counts from the local QKV
tile (head-local attention, the KV cache and pool hold the local KV
heads), the embedding is vocab-parallel (the local rows looked up, the
rest masked, the sum over the group exact since each token has one
nonzero term), and ``_lm_head`` all-gathers the local logits to the full
vocabulary on every rank; under grad (training on a mesh) both go
through ``ctx``'s autograd collectives, so the embedding's gradient
reaches each rank's own rows and the logits' its own vocabulary tile.  The paged forwards of the engine write the pool
in place too.  A MoE layer (``n_experts``) runs ``layers.moe_ffn`` with
a shared expert behind a sigmoid gate (Qwen1.5-MoE) or a dense residual
FFN (Arctic); under TP both are ordinary column- and row-parallel sites
and the gate [d, 1] stays whole.  The slab engine's per-row decode (``_block_slots``) and
the paged engine's chunked prefill (``prefill_chunk_paged``) are here
too; under TP the slab decode's attention layers attend their local KV
heads, or an MQA config's one KV head, replicated on every rank.  FP8 KV (the ``moe_hybrid`` recipe, ``_kv_fp8``): the dense cache
and the pool hold E4M3 K and V with f32 scales per (position, head), so
under TP a rank's KV heads carry their own scales;
``prefill`` attends its prompt's BF16 KV and stores it quantized, the
decode and paged forwards quantize each new row as they write it, and the
chunked prefill attends its BF16 scratch and quantizes only the pool's
copy, as the reference does.

M-RoPE (Qwen2-VL, ``cfg.mrope_sections``): ``apply``, ``prefill`` and
``decode_step`` take ``batch["pos3"]`` [B, S, 3] (t, h, w position ids;
[B, 1, 3] at decode) and, when given, ``batch["vis_embeds"]`` [B, S, d]
spliced over the token embeddings where ``batch["vis_mask"]`` [B, S] is
set (the vision frontend is a stub in the reference too).  The paged and
slab forwards take no ``pos3``: the engine refuses the config (its state
plan holds "vision_prefix").
"""
from __future__ import annotations

import torch

from ..core.nvfp4 import PackedNVFP4
from ..core.qconfig import QuantConfig
from ..distributed import ctx, sharding
from ..obs import numerics as obs_numerics
from . import attention as attn
from . import common, layers


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _norm_specs(cfg, d):
    P = common.ParamSpec
    if cfg.norm == "rmsnorm":
        return {"w": P((d,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        return {"w": P((d,), ("embed",), init="ones"),
                "b": P((d,), ("embed",), init="zeros")}
    return {}          # layernorm_np: non-parametric (OLMo)


def run_norm(cfg, p, x):
    return layers.apply_norm(cfg, x, p.get("w"), p.get("b"))


def _layer_specs(cfg):
    P = common.ParamSpec
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    h = cfg.n_heads
    spec = {
        "ln1": _norm_specs(cfg, d),
        "wqkv": P((d, cfg.qkv_dim), ("embed", "qkv"), kind="attn"),
        "wo": P((h * hd, d), ("qkv", "embed"), kind="attn", scale=0.5),
        "ln2": _norm_specs(cfg, d),
    }
    if cfg.qkv_bias:
        spec["bqkv"] = P((cfg.qkv_dim,), ("qkv",), init="zeros")
    if cfg.n_experts:
        ffe, e = cfg.moe_d_ff, cfg.n_experts
        eax = "expert" if cfg.moe_shard == "ep" else "none"
        spec["router"] = P((d, e), ("embed", "expert"), kind="router")
        spec["moe_wg"] = P((e, d, ffe), (eax, "embed", "mlp"), kind="mlp",
                           contract_axis=1)
        spec["moe_wu"] = P((e, d, ffe), (eax, "embed", "mlp"), kind="mlp",
                           contract_axis=1)
        spec["moe_wd"] = P((e, ffe, d), (eax, "mlp", "embed"), kind="mlp",
                           contract_axis=1, scale=0.5)
        if cfg.shared_d_ff:
            sf = cfg.shared_d_ff
            spec["sh_wg"] = P((d, sf), ("embed", "mlp"), kind="mlp")
            spec["sh_wu"] = P((d, sf), ("embed", "mlp"), kind="mlp")
            spec["sh_wd"] = P((sf, d), ("mlp", "embed"), kind="mlp", scale=0.5)
            spec["sh_gate"] = P((d, 1), ("embed", "none"), kind="router")
        if cfg.moe_dense_residual:
            spec["res_wg"] = P((d, ff), ("embed", "mlp"), kind="mlp")
            spec["res_wu"] = P((d, ff), ("embed", "mlp"), kind="mlp")
            spec["res_wd"] = P((ff, d), ("mlp", "embed"), kind="mlp", scale=0.5)
    elif cfg.mlp == "swiglu":
        spec["wg"] = P((d, ff), ("embed", "mlp"), kind="mlp")
        spec["wu"] = P((d, ff), ("embed", "mlp"), kind="mlp")
        spec["wd"] = P((ff, d), ("mlp", "embed"), kind="mlp", scale=0.5)
    else:
        spec["wi"] = P((d, ff), ("embed", "mlp"), kind="mlp")
        spec["wd"] = P((ff, d), ("mlp", "embed"), kind="mlp", scale=0.5)
    return spec


def param_specs(cfg):
    P = common.ParamSpec
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": P((v, d), ("vocab", "embed"), init="embed", kind="embed"),
        "layers": common.stack_specs(_layer_specs(cfg), cfg.n_layers),
        "final_norm": _norm_specs(cfg, d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, v), ("embed", "vocab"), kind="lm_head",
                             scale=1.0)
    return specs


def init_params(cfg, gen: torch.Generator, device="cuda"):
    return common.init_params(param_specs(cfg), gen, device)


def unembed(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------


def _local_heads(cfg) -> tuple[int, int]:
    """(query heads, KV heads) of this rank's fused QKV tile: the query
    heads split evenly over the active group, and the rank's share of the
    KV heads or, under MQA, the one KV head replicated."""
    return sharding.local_heads(cfg.n_heads, cfg.n_kv_heads, ctx.tp_size())


def _rope(cfg, x, pos):
    """RoPE, or M-RoPE over ``pos`` [B, S, 3] for a config with
    ``mrope_sections``."""
    if cfg.mrope_sections:
        if pos.ndim != 3:
            raise ValueError(f"{cfg.name}: M-RoPE takes pos3 [B, S, 3] "
                             f"positions, got {tuple(pos.shape)}")
        return layers.apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    return layers.apply_rope(x, pos, cfg.rope_theta)


def _qkv(qcfg, cfg, p, h, pos):
    """The layer's q, k, v [B, S, heads, hd] (this rank's heads), q and k
    rotated to positions ``pos``."""
    hd = cfg.head_dim
    nh, nkv = _local_heads(cfg)
    qkv = layers.qdense(qcfg, "attn", h, p["wqkv"], p.get("bqkv"),
                        parallelism="column")
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    q = _rope(cfg, attn.split_heads(q, nh, hd), pos)
    k = _rope(cfg, attn.split_heads(k, nkv, hd), pos)
    return q, k, attn.split_heads(v, nkv, hd)


def _out_proj(qcfg, p, out):
    """The attention output [B, S, heads, hd] through ``wo``."""
    b, s = out.shape[:2]
    return layers.qdense(qcfg, "attn", out.reshape(b, s, -1), p["wo"],
                         parallelism="row")


def _attention(qcfg, cfg, p, h, pos, mode, cache_sl, pos_idx):
    q, k, v = _qkv(qcfg, cfg, p, h, pos)
    if mode == "decode":
        s_max = cache_sl["k"].shape[1]
        write_at = pos_idx % s_max if cfg.window else pos_idx
        attn.cache_update_layer(cache_sl, k, v, write_at)
        out = attn.decode_attend(q, cache_sl, pos_idx + 1, window=cfg.window)
    else:
        out = attn.blockwise_attention(q, k, v, causal=True,
                                       window=cfg.window)
        if mode == "prefill":
            attn.cache_prefill_layer(cache_sl, k, v, cfg.window)
    return _out_proj(qcfg, p, out)


def _ffn(qcfg, cfg, p, h):
    """The layer's FFN: (out, aux); aux holds the MoE dispatch metrics."""
    if not cfg.n_experts:
        if cfg.mlp == "swiglu":
            return layers.swiglu_mlp(qcfg, h, p["wg"], p["wu"], p["wd"]), {}
        return layers.gelu_mlp(qcfg, h, p["wi"], p["wd"]), {}
    out, aux = layers.moe_ffn(qcfg, cfg, h, p["router"], p["moe_wg"],
                              p["moe_wu"], p["moe_wd"])
    if cfg.shared_d_ff:
        sh = layers.swiglu_mlp(qcfg, h, p["sh_wg"], p["sh_wu"], p["sh_wd"])
        gate = torch.sigmoid(layers.qdense(qcfg, "router", h, p["sh_gate"])
                             .to(torch.float32))
        out = out + (sh.to(torch.float32) * gate).to(out.dtype)
    if cfg.moe_dense_residual:
        out = out + layers.swiglu_mlp(qcfg, h, p["res_wg"], p["res_wu"],
                                      p["res_wd"])
    return out, aux


def _block(qcfg, cfg, p, x, pos, mode, cache_sl, pos_idx):
    h = run_norm(cfg, p["ln1"], x)
    x = x + _attention(qcfg, cfg, p, h, pos, mode, cache_sl, pos_idx)
    h = run_norm(cfg, p["ln2"], x)
    return x + _ffn(qcfg, cfg, p, h)[0]


def _attention_slots(qcfg, cfg, p, h, lens, active, cache_sl):
    """Per-row decode attention against a dense [B, S_alloc, ...] cache
    layer for the slab engine: ``lens`` [B] is each row's cached-token
    count (this token's position), ``active`` [B] masks rows with no
    work.  Per-row RoPE, ring writes at ``lens % S_alloc`` for a windowed
    layer and per-row validity: an active row computes what a batch-1
    ``decode_step`` computes.  Returns (out, new cache layer: new tensors)."""
    q, k, v = _qkv(qcfg, cfg, p, h, lens[:, None])
    s_max = cache_sl["k"].shape[1]
    write_at = lens % s_max if cfg.window else lens
    new_cache = attn.cache_update_slots(cache_sl, k, v, write_at, active)
    out = attn.decode_attend(q, new_cache, lens + 1, window=cfg.window)
    return _out_proj(qcfg, p, out), new_cache


def _block_slots(qcfg, cfg, p, x, lens, active, cache_sl):
    """A transformer layer of the slab decode step (per-row positions):
    (x, new cache layer)."""
    h = run_norm(cfg, p["ln1"], x)
    a, new_cache = _attention_slots(qcfg, cfg, p, h, lens, active, cache_sl)
    x = x + a
    h = run_norm(cfg, p["ln2"], x)
    return x + _ffn(qcfg, cfg, p, h)[0], new_cache


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    """The embedding lookup; vocab-parallel when ``params["embed"]`` holds
    this rank's rows: local rows looked up, the others -0.0 (the identity
    of a float sum), summed over the group in f32, which is exact."""
    table = params["embed"]
    v_local = table.shape[0]
    if v_local == cfg.vocab_size:
        return table[tokens]
    tp = ctx.current()
    local = tokens - tp.rank * v_local
    mine = (local >= 0) & (local < v_local)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.full_like(rows, -0.0))
    return ctx.reduce_from_model(rows, tp)


def _embed_inputs(cfg, params, batch):
    """The token embeddings, with a VLM's precomputed patch embeddings
    ``vis_embeds`` spliced in where ``vis_mask`` is set."""
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.mrope_sections and "vis_embeds" in batch:
        m = batch["vis_mask"][..., None]
        x = torch.where(m, batch["vis_embeds"].to(x.dtype), x)
    return x


def _positions(cfg, batch, s, offset=0):
    if cfg.mrope_sections:
        return batch["pos3"]                            # [B, S, 3]
    tokens = batch["tokens"]
    return (torch.arange(s, device=tokens.device) + offset).expand(
        tokens.shape[0], s)


def _lm_head(qcfg, cfg, params, x):
    """The logits: a column-parallel site over the rank's vocabulary tile,
    all-gathered; an unembedding the rules keep whole (a vocabulary that
    does not divide the group, whisper-tiny's 51865) is every rank's same
    product, its input's gradient not summed over the group."""
    x = run_norm(cfg, params["final_norm"], x)
    w = unembed(cfg, params)
    n = w.shape[-2] if isinstance(w, PackedNVFP4) else w.shape[-1]
    whole = n == cfg.vocab_size
    logits = layers.qdense(qcfg, "lm_head", x, w,
                           parallelism=None if whole else "column")
    if logits.shape[-1] != cfg.vocab_size:      # this rank's vocab tile
        logits = ctx.gather_from_model(logits, ctx.current(), -1)
    return logits


def apply(cfg, params, batch, qcfg: QuantConfig,
          output: str = "logits") -> torch.Tensor:
    """Teacher-forcing forward: [B,S] tokens -> [B,S,V] logits, or with
    ``output="hidden"`` the final-normed [B,S,d] hidden states (the
    chunked loss applies the unembedding itself).  The layers run under
    ``cfg.remat`` when grad is on (``common.scan_layers``)."""
    x = _embed_inputs(cfg, params, batch)
    pos = _positions(cfg, batch, x.shape[1])

    def body(qc):
        def fn(carry, inp):
            p, _ = inp
            y = _block(qc, cfg, p, carry, pos, "train", None, None)
            if qc.numerics:
                # per-layer hidden-state tap: scan_layers stacks these
                # into [n_layers, B, S, d] for teacher-student geometry
                tape = obs_numerics.active()
                if tape is not None:
                    tape.put("hidden", {"h": y.detach()})
            return y, None
        return fn

    x, _ = common.scan_layers(body, x, params["layers"], None, qcfg,
                              qcfg.skip_first_layers, qcfg.skip_last_layers,
                              cfg.remat)
    if output == "hidden":
        return run_norm(cfg, params["final_norm"], x)
    return _lm_head(qcfg, cfg, params, x)


def cache_specs(cfg, batch_size, s_max, n_shards: int = 1):
    """Specs of the dense cache (a windowed one holds at most ``window``
    positions); ``n_shards`` ranks split the KV heads.  An FP8 cache
    (``moe_hybrid``) holds E4M3 K and V and f32 ``k_scale``/``v_scale``
    [L, B, s_alloc, Hkv]."""
    s_alloc = min(s_max, cfg.window) if cfg.window else s_max
    shape = (cfg.n_layers, batch_size, s_alloc, cfg.n_kv_heads // n_shards,
             cfg.head_dim)
    return _kv_specs(cfg, shape, ("layers", "batch", "seq", "kv", "headdim"))


def _kv_specs(cfg, shape, axes):
    """Zero K and V of ``shape``: bf16, or under FP8 KV E4M3 with f32
    ``k_scale``/``v_scale`` over all but the head dim."""
    P = common.ParamSpec
    fp8 = _kv_fp8(cfg)
    kdt = torch.float8_e4m3fn if fp8 else torch.bfloat16
    c = {"k": P(shape, axes, dtype=kdt, init="zeros"),
         "v": P(shape, axes, dtype=kdt, init="zeros")}
    if fp8:
        for name in ("k_scale", "v_scale"):
            c[name] = P(shape[:-1], axes[:-1], dtype=torch.float32,
                        init="zeros")
    return c


def init_cache(cfg, batch_size, s_max, device="cuda",
               n_shards: int = 1) -> dict:
    """Zero cache {"k", "v"} [L, B, s_alloc, Hkv, hd] (bf16, or E4M3 with
    f32 scales under FP8 KV) and ``pos`` 0 (Hkv / ``n_shards`` KV heads on
    each of ``n_shards`` ranks; s_alloc is ``s_max``, or at most
    ``window`` for a windowed config)."""
    cache = {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
             for name, spec in cache_specs(cfg, batch_size, s_max,
                                           n_shards).items()}
    cache["pos"] = 0
    return cache


def _kv_fp8(cfg):
    return cfg.quant_recipe == "moe_hybrid"


def _cache_slices(cache):
    return {k: v for k, v in cache.items() if k != "pos"}


def decode_step(cfg, params, cache, batch, qcfg: QuantConfig):
    """One-token decode: batch["tokens"] [B,1] against the cache, which is
    updated in place and returned with ``pos`` advanced."""
    x = _embed_inputs(cfg, params, batch)
    pos_idx = cache["pos"]
    if cfg.mrope_sections:
        pos = batch["pos3"]                             # [B, 1, 3]
    else:
        pos = torch.full((x.shape[0], 1), pos_idx, dtype=torch.int64,
                         device=x.device)

    def body(qc):
        def fn(carry, inp):
            p, csl = inp
            return _block(qc, cfg, p, carry, pos, "decode", csl, pos_idx), None
        return fn

    x, _ = common.scan_layers(body, x, params["layers"], _cache_slices(cache),
                              qcfg, qcfg.skip_first_layers,
                              qcfg.skip_last_layers)
    logits = _lm_head(qcfg, cfg, params, x)
    cache["pos"] = pos_idx + 1
    return logits, cache


def prefill(cfg, params, batch, qcfg: QuantConfig, s_max: int | None = None):
    """Prompt pass: (last-token logits [B,1,V], cache holding the prompt's
    kv in an allocation of ``s_max`` positions; a windowed config keeps
    at most ``window``, ring-aligned)."""
    x = _embed_inputs(cfg, params, batch)
    b, s = batch["tokens"].shape
    pos = _positions(cfg, batch, s)
    cache = init_cache(cfg, b, max(s_max or s, s), device=x.device,
                       n_shards=ctx.tp_size())

    def body(qc):
        def fn(carry, inp):
            p, csl = inp
            return _block(qc, cfg, p, carry, pos, "prefill", csl, None), None
        return fn

    x, _ = common.scan_layers(body, x, params["layers"], _cache_slices(cache),
                              qcfg, qcfg.skip_first_layers,
                              qcfg.skip_last_layers)
    logits = _lm_head(qcfg, cfg, params, x[:, -1:])
    cache["pos"] = s
    return logits, cache


# ---------------------------------------------------------------------------
# paged-pool forwards (continuous-batching engine, ``repro_torch.serve``;
# reference lines 338-533)
# ---------------------------------------------------------------------------


def paged_pool_specs(cfg, n_blocks: int, block_size: int, n_shards: int = 1):
    """Specs of the block-granular KV pool shared by all requests:
    [L, n_blocks, block_size, Hkv, hd] per K and V, plus f32 scales beside
    FP8 pages (the ``moe_hybrid`` recipe), as the dense cache.  Under
    tensor parallelism each of ``n_shards`` ranks holds
    Hkv / ``n_shards`` KV heads."""
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads // n_shards,
             cfg.head_dim)
    return _kv_specs(cfg, shape,
                     ("layers", "blocks", "blockslot", "kv", "headdim"))


def init_paged_pool(cfg, n_blocks: int, block_size: int, device="cuda",
                    n_shards: int = 1) -> dict:
    """A zero pool (this rank's KV heads) on ``device``."""
    return {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
            for name, spec in paged_pool_specs(cfg, n_blocks, block_size,
                                               n_shards).items()}


def write_prompt_to_pool(pool: dict, cache: dict, block_ids) -> dict:
    """Scatter a batch-1 ``prefill`` cache (logical length P) into pool
    blocks ``block_ids`` [ceil(P / block_size)], IN PLACE; the tail of the
    last block is zero-filled (masked by the request length at read)."""
    bs = pool["k"].shape[2]
    ids = torch.as_tensor(block_ids, dtype=torch.long,
                          device=pool["k"].device)
    for name in [k for k in pool if k in cache]:
        # FP8 pages move as bytes (zero bytes are E4M3 zeros)
        c = attn._bytes(cache[name].to(pool[name].dtype))   # [L, 1, P, ...]
        l, _, p_len = c.shape[:3]
        pad = (-p_len) % bs
        blocks = c[:, 0]
        if pad:
            blocks = torch.cat([blocks, blocks.new_zeros(
                (l, pad, *blocks.shape[2:]))], 1)
        blocks = blocks.reshape(l, (p_len + pad) // bs, bs, *c.shape[3:])
        attn._bytes(pool[name])[:, ids] = blocks
    return pool


def _attention_paged(qcfg, cfg, p, h, pos, psl, block_tables, positions,
                     plan, fused: bool = False):
    """Paged attention for S >= 1 new positions per slot.

    ``positions``: [B] (one-token decode) or [B, S] (multi-token verify)
    absolute write positions, the same positions RoPE gets in ``pos``;
    ``plan``: the ``attention.paged_write_plan`` of the active entries.
    Query i attends positions < its own position + 1.  ``fused`` routes
    the attend through the ``paged_attention`` kernel (K7); the two-step
    stays as its oracle.
    """
    q, k, v = _qkv(qcfg, cfg, p, h, pos)
    attn.paged_scatter(psl, k, v, plan)
    attend = attn.paged_attend_fused if fused else attn.paged_attend
    out = attend(q, psl, block_tables, positions + 1, window=cfg.window)
    return _out_proj(qcfg, p, out)


def _paged_forward(cfg, params, pool, block_tables, positions, tok_active,
                   batch, qcfg, fused):
    """The layer stack over the pool for tokens at ``positions`` ([B] or
    [B, S]); the pool is written in place.  Returns logits [B, S, V]."""
    x = embed_tokens(cfg, params, batch["tokens"])
    pos = positions[:, None] if positions.ndim == 1 else positions
    plan = attn.paged_write_plan(block_tables, positions, tok_active,
                                 pool["k"].shape[2])

    def body(qc):
        def fn(carry, inp):
            p, psl = inp
            h = run_norm(cfg, p["ln1"], carry)
            y = carry + _attention_paged(qc, cfg, p, h, pos, psl, block_tables,
                                         positions, plan, fused=fused)
            h = run_norm(cfg, p["ln2"], y)
            return y + _ffn(qc, cfg, p, h)[0], None
        return fn

    x, _ = common.scan_layers(body, x, params["layers"], pool, qcfg,
                              qcfg.skip_first_layers, qcfg.skip_last_layers)
    return _lm_head(qcfg, cfg, params, x)


def decode_step_paged(cfg, params, pool, block_tables, lens, active, batch,
                      qcfg: QuantConfig, fused: bool = False):
    """One-token decode for a slot batch against the paged pool.

    batch["tokens"] [n_slots, 1]; block_tables [n_slots, MB] pool block
    ids; lens [n_slots] cached-token counts; active [n_slots] bool.
    Inactive slots compute logits the engine ignores, and their pool
    writes are dropped.  The pool is updated IN PLACE (the reference
    donates it).  Returns (logits [n_slots, 1, V], pool).
    """
    logits = _paged_forward(cfg, params, pool, block_tables, lens, active,
                            batch, qcfg, fused)
    return logits, pool


def verify_step_paged(cfg, params, pool, block_tables, lens, active, n_prop,
                      batch, qcfg: QuantConfig, fused: bool = False):
    """Score K1 positions per slot at once: the speculative verify step,
    and the engine's block-granular paged prefill.

    batch["tokens"] [n_slots, K1]: token 0 is the slot's next input, tokens
    1..n_prop[b] follow it (the tail is padding).  KV for every fed position
    lens + i (i <= n_prop) is written to the pool IN PLACE; query i attends
    positions < lens + i + 1.  Positions past n_prop neither write nor
    influence live positions; their logits are garbage.  With
    ``act_scope="token"`` the logits at position i are those of a one-token
    decode on the same prefix.  Returns (logits [n_slots, K1, V], pool).
    """
    k1 = batch["tokens"].shape[1]
    offs = torch.arange(k1, device=lens.device)
    positions = lens[:, None] + offs[None, :]
    tok_active = active[:, None] & (offs[None, :] <= n_prop[:, None])
    logits = _paged_forward(cfg, params, pool, block_tables, positions,
                            tok_active, batch, qcfg, fused)
    return logits, pool


# ---------------------------------------------------------------------------
# chunked prefill (the engine's prefill_mode="chunked"; reference lines
# 364-377 and 536-608)
# ---------------------------------------------------------------------------


def prefill_scratch_specs(cfg, s_alloc: int, n_shards: int = 1):
    """BF16 KV scratch [L, 1, s_alloc, Hkv, hd] for one request's chunked
    prefill: later chunks attend the prompt's BF16 prefix here, as whole-
    prompt prefill attends BF16 KV; the pool gets its own copy for the
    decode steps.  ``n_shards`` ranks split the KV heads."""
    P = common.ParamSpec
    shape = (cfg.n_layers, 1, s_alloc, cfg.n_kv_heads // n_shards,
             cfg.head_dim)
    axes = ("layers", "batch", "seq", "kv", "headdim")
    return {"k": P(shape, axes, init="zeros"), "v": P(shape, axes, init="zeros")}


def _attention_prefill_chunk(qcfg, cfg, p, h, pos, ssl, psl, bt, positions,
                             tok_active, start: int, n_valid: int):
    """One layer's attention over a chunk of C prompt tokens at positions
    start..start + C - 1 (the first ``n_valid`` real): its kv written to
    the scratch from ``start`` and, per valid token, to the pool, both IN
    PLACE; the chunk's queries attend the scratch's prefix."""
    q, k, v = _qkv(qcfg, cfg, p, h, pos)
    c = q.shape[1]
    # the scratch keeps the chunk from ``start`` (its padded tail, masked
    # by kv_valid, only as far as the allocation reaches)
    n_w = min(c, ssl["k"].shape[1] - start)
    ssl["k"][:, start:start + n_w] = k[:, :n_w].to(ssl["k"].dtype)
    ssl["v"][:, start:start + n_w] = v[:, :n_w].to(ssl["v"].dtype)
    out = attn.blockwise_attention(q, ssl["k"], ssl["v"], causal=True,
                                   window=cfg.window, q_offset=start,
                                   kv_valid=start + n_valid)
    # the pool's copy, one write per valid chunk token
    attn.paged_update_layer(psl, k.transpose(0, 1), v.transpose(0, 1), bt,
                            positions, tok_active)
    return _out_proj(qcfg, p, out)


def prefill_chunk_paged(cfg, params, scratch, pool, block_table, start: int,
                        n_valid: int, batch, qcfg: QuantConfig):
    """Prefill one fixed-size prompt chunk of a single request.

    batch["tokens"] [1, C] (the chunk, right-padded past ``n_valid``);
    ``scratch``: the BF16 prefix KV (``prefill_scratch_specs``);
    ``block_table`` [MB] this request's pool blocks; ``start``: tokens
    already prefilled; ``n_valid``: real tokens in this chunk (1..C).
    The scratch and the pool are written IN PLACE.  Returns the logits at
    the last real position [1, 1, V].  Activation amaxes cover the chunk
    (padding included), so the logits approximate whole-prompt prefill's;
    a chunk that is the whole prompt derives the same amaxes."""
    x = embed_tokens(cfg, params, batch["tokens"])
    c = x.shape[1]
    offs = torch.arange(c, device=x.device)
    pos = (offs + start)[None, :]                     # [1, C]
    positions = offs + start                          # [C] pool positions
    tok_active = offs < n_valid
    bt = block_table[None, :].expand(c, block_table.shape[0])

    def body(qc):
        def fn(carry, inp):
            p, sl = inp
            h = run_norm(cfg, p["ln1"], carry)
            y = carry + _attention_prefill_chunk(
                qc, cfg, p, h, pos, sl["scratch"], sl["pool"], bt, positions,
                tok_active, start, n_valid)
            h = run_norm(cfg, p["ln2"], y)
            return y + _ffn(qc, cfg, p, h)[0], None
        return fn

    x, _ = common.scan_layers(body, x, params["layers"],
                              {"scratch": scratch, "pool": pool}, qcfg,
                              qcfg.skip_first_layers, qcfg.skip_last_layers)
    return _lm_head(qcfg, cfg, params, x[:, n_valid - 1:n_valid])
