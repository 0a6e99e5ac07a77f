"""Whisper-style encoder-decoder (arXiv:2212.04356), the transformer
backbone only (port of ``repro.models.whisper``).  The conv/mel frontend
is a stub, as in the reference: the encoder takes precomputed frame
embeddings ``enc_frames`` [B, enc_seq, d].

Encoder: bidirectional self-attention and a GELU MLP, sinusoidal
positions on the frames.  Decoder: causal self-attention, cross-attention
to the encoder's output, a GELU MLP, sinusoidal positions.  Every GEMM
but the tied unembedding carries a bias.

The serve state (``cache_specs``): the decoder's dense self-attention KV
[L, B, s_max, H, hd] and the encoder's output ``enc_out`` [B, enc_seq, d].
The cross-attention KV is computed from ``enc_out`` again at every decode
step, as the reference does.  ``decode_step`` writes the self-attention
KV in place; the slab engine's ``decode_step_slots`` writes each active
slot's row at its own position into new tensors, and ``enc_out`` is
never written after prefill.

Under a tensor-parallel context (``distributed.ctx``) ``params`` holds
this rank's tiles: the fused ``wqkv`` and cross-attention ``x_wqkv``
tiles (and their biases) are regrouped by head and column-parallel, so
attention is head-local and the self-attention KV holds the rank's
heads; ``wo``, ``x_wo`` and the MLP's ``wd`` are row-parallel, their
biases added once after the sum.  The encoder runs under TP at admission
and ``enc_out`` stays whole.  The embedding is vocab-parallel where the
vocabulary divides the group and the logits are then all-gathered;
whisper-tiny's 51865 does not divide, so its embedding stays whole.
"""
from __future__ import annotations

import torch

from ..core.qconfig import QuantConfig
from . import attention as attn
from . import common, decoder, layers
from .decoder import _norm_specs, run_norm


def _attn_specs(cfg, prefix=""):
    P = common.ParamSpec
    d, hd = cfg.d_model, cfg.head_dim
    return {
        prefix + "wqkv": P((d, cfg.qkv_dim), ("embed", "qkv"), kind="attn"),
        prefix + "bqkv": P((cfg.qkv_dim,), ("qkv",), init="zeros"),
        prefix + "wo": P((cfg.n_heads * hd, d), ("qkv", "embed"), kind="attn",
                         scale=0.5),
    }


def _mlp_specs(cfg):
    P = common.ParamSpec
    d, ff = cfg.d_model, cfg.d_ff
    return {"wi": P((d, ff), ("embed", "mlp"), kind="mlp"),
            "bi": P((ff,), ("mlp",), init="zeros"),
            "wd": P((ff, d), ("mlp", "embed"), kind="mlp", scale=0.5),
            "bd": P((d,), ("embed",), init="zeros")}


def _enc_layer(cfg):
    return {"ln1": _norm_specs(cfg, cfg.d_model), **_attn_specs(cfg),
            "ln2": _norm_specs(cfg, cfg.d_model), **_mlp_specs(cfg)}


def _dec_layer(cfg):
    return {"ln1": _norm_specs(cfg, cfg.d_model), **_attn_specs(cfg),
            "ln_x": _norm_specs(cfg, cfg.d_model),
            **_attn_specs(cfg, "x_"),
            "ln2": _norm_specs(cfg, cfg.d_model), **_mlp_specs(cfg)}


def param_specs(cfg):
    P = common.ParamSpec
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": P((v, d), ("vocab", "embed"), init="embed", kind="embed"),
        "enc_layers": common.stack_specs(_enc_layer(cfg), cfg.n_enc_layers),
        "enc_norm": _norm_specs(cfg, d),
        "dec_layers": common.stack_specs(_dec_layer(cfg), cfg.n_layers),
        "final_norm": _norm_specs(cfg, d),
    }


def init_params(cfg, gen: torch.Generator, device="cuda"):
    return common.init_params(param_specs(cfg), gen, device)


def unembed(cfg, params):
    return params["embed"].T           # Whisper ties its embeddings


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(qcfg, cfg, p, h, prefix=""):
    """The fused projection's output [.., (q | k | v) of this rank's heads]
    and the rank's (query, KV) head counts."""
    w = p[prefix + "wqkv"]
    qkv = layers.qdense(qcfg, "attn", h, w, p[prefix + "bqkv"],
                        parallelism="column")
    return qkv, decoder._local_heads(cfg)


def _split_qkv(cfg, qkv, heads):
    hd = cfg.head_dim
    nh, nkv = heads
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    return (attn.split_heads(q, nh, hd), attn.split_heads(k, nkv, hd),
            attn.split_heads(v, nkv, hd))


def _out(qcfg, p, out, prefix=""):
    b, s = out.shape[:2]
    return layers.qdense(qcfg, "attn", out.reshape(b, s, -1),
                         p[prefix + "wo"], parallelism="row")


def _self_attention(qcfg, cfg, p, h, causal, mode="train", cache_sl=None,
                    pos_idx=None):
    """Returns (out, the prompt's kv in prefill mode, else None); decode
    writes ``cache_sl`` in place at ``pos_idx``."""
    q, k, v = _split_qkv(cfg, *_qkv(qcfg, cfg, p, h))
    new = None
    if mode == "decode":
        attn.cache_update_layer(cache_sl, k, v, pos_idx)
        out = attn.decode_attend(q, cache_sl, pos_idx + 1)
    else:
        out = attn.blockwise_attention(q, k, v, causal=causal)
        if mode == "prefill":
            new = {"k": k, "v": v}
    return _out(qcfg, p, out), new


def _cross_attention(qcfg, cfg, p, h, enc_kv):
    """``enc_kv``: {"k", "v"} [B, enc_seq, H, hd] from the encoder's output;
    the queries take the first third of ``x_wqkv``'s output (its first
    ``H hd`` features of the rank's tile), as the reference does."""
    hd = cfg.head_dim
    qkv, (nh, _) = _qkv(qcfg, cfg, p, h, "x_")
    q = attn.split_heads(qkv[..., : nh * hd], nh, hd)
    out = attn.blockwise_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return _out(qcfg, p, out, "x_")


def _cross_kv(qcfg, cfg, p, enc_out):
    _, k, v = _split_qkv(cfg, *_qkv(qcfg, cfg, p, enc_out, "x_"))
    return {"k": k, "v": v}


def _mlp(qcfg, p, h):
    return layers.gelu_mlp(qcfg, h, p["wi"], p["wd"], p["bi"], p["bd"])


# ---------------------------------------------------------------------------
# encoder and decoder
# ---------------------------------------------------------------------------


def encode(cfg, params, frames, qcfg: QuantConfig):
    """frames [B, enc_seq, d] (the stub's embeddings) -> the encoder's
    final-normed hidden states."""
    x = frames.to(cfg.param_dtype)
    x = x + layers.sinusoidal_pos(x.shape[1], cfg.d_model,
                                  x.device).to(x.dtype)

    def body(qc):
        def fn(carry, inp):
            p, _ = inp
            h = run_norm(cfg, p["ln1"], carry)
            y = carry + _self_attention(qc, cfg, p, h, causal=False)[0]
            h = run_norm(cfg, p["ln2"], y)
            return y + _mlp(qc, p, h), None
        return fn

    x, _ = common.scan_layers(body, x, params["enc_layers"], None, qcfg,
                              0, 0, cfg.remat)
    return run_norm(cfg, params["enc_norm"], x)


def _dec_block(qcfg, cfg, p, x, enc_out, mode, cache_sl, pos_idx):
    h = run_norm(cfg, p["ln1"], x)
    a, new = _self_attention(qcfg, cfg, p, h, True, mode, cache_sl, pos_idx)
    x = x + a
    h = run_norm(cfg, p["ln_x"], x)
    x = x + _cross_attention(qcfg, cfg, p, h, _cross_kv(qcfg, cfg, p, enc_out))
    h = run_norm(cfg, p["ln2"], x)
    return x + _mlp(qcfg, p, h), new


def _embed(cfg, params, tokens, pe_rows):
    """Token embeddings plus the sinusoidal rows ``pe_rows`` [S or B, d]
    (f32, rounded to the embedding's dtype)."""
    x = decoder.embed_tokens(cfg, params, tokens)
    return x + pe_rows.to(x.dtype)


def _head(qcfg, cfg, params, x):
    return decoder._lm_head(qcfg, cfg, params, x)


def apply(cfg, params, batch, qcfg: QuantConfig,
          output: str = "logits") -> torch.Tensor:
    """batch: ``tokens`` [B, S] (the decoder's), ``enc_frames`` [B, enc_seq,
    d] (the stub's).  Returns [B, S, V] logits, or the final-normed hidden
    states with ``output="hidden"``."""
    enc_out = encode(cfg, params, batch["enc_frames"], qcfg)
    s = batch["tokens"].shape[1]
    x = _embed(cfg, params, batch["tokens"],
               layers.sinusoidal_pos(s, cfg.d_model, enc_out.device))

    def body(qc):
        def fn(carry, inp):
            p, _ = inp
            return _dec_block(qc, cfg, p, carry, enc_out, "train", None,
                              None)[0], None
        return fn

    x, _ = common.scan_layers(body, x, params["dec_layers"], None, qcfg,
                              0, 0, cfg.remat)
    if output == "hidden":
        return run_norm(cfg, params["final_norm"], x)
    return _head(qcfg, cfg, params, x)


def cache_specs(cfg, batch_size, s_max):
    P = common.ParamSpec
    kv_shape = (cfg.n_layers, batch_size, s_max, cfg.n_kv_heads, cfg.head_dim)
    kv_axes = ("layers", "batch", "seq", "kv", "headdim")
    return {
        "k": P(kv_shape, kv_axes, init="zeros"),
        "v": P(kv_shape, kv_axes, init="zeros"),
        "enc_out": P((batch_size, cfg.enc_seq, cfg.d_model),
                     ("batch", "seq", "embed"), init="zeros"),
    }


def init_cache(cfg, batch_size, s_max, device="cuda") -> dict:
    """A zero serve state for ``batch_size`` rows and ``pos`` 0."""
    cache = common.zeros_from_specs(cache_specs(cfg, batch_size, s_max),
                                    device)
    cache["pos"] = 0
    return cache


def prefill(cfg, params, batch, qcfg: QuantConfig, s_max: int | None = None):
    """Encode ``enc_frames`` and run the decoder's prompt: (last-token
    logits [B, 1, V], the serve state, its self-attention KV padded to
    ``s_max`` positions)."""
    enc_out = encode(cfg, params, batch["enc_frames"], qcfg)
    b, s = batch["tokens"].shape
    x = _embed(cfg, params, batch["tokens"],
               layers.sinusoidal_pos(s, cfg.d_model, enc_out.device))

    def body(qc):
        def fn(carry, inp):
            p, _ = inp
            return _dec_block(qc, cfg, p, carry, enc_out, "prefill", None,
                              None)
        return fn

    x, kv = common.scan_layers(body, x, params["dec_layers"], None, qcfg,
                               0, 0, cfg.remat)
    kv = common.stack_trees(kv)                       # [L, B, S, H, hd]
    if s_max and s_max > s:
        kv = common.tree_map(lambda a: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, s_max - s)), kv)
    cache = dict(kv, enc_out=enc_out, pos=s)
    return _head(qcfg, cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, cache, batch, qcfg: QuantConfig):
    """One-token decode: batch["tokens"] [B, 1] at ``cache["pos"]``; the
    self-attention KV is written IN PLACE.  Returns (logits [B, 1, V], the
    cache with ``pos`` advanced)."""
    pos_idx = cache["pos"]
    pe = layers.sinusoidal_pos(cache["k"].shape[2], cfg.d_model,
                               cache["k"].device)
    x = _embed(cfg, params, batch["tokens"], pe[pos_idx:pos_idx + 1])
    enc_out = cache["enc_out"]

    def body(qc):
        def fn(carry, inp):
            p, csl = inp
            return _dec_block(qc, cfg, p, carry, enc_out, "decode", csl,
                              pos_idx)[0], None
        return fn

    x, _ = common.scan_layers(body, x, params["dec_layers"],
                              {"k": cache["k"], "v": cache["v"]}, qcfg)
    cache["pos"] = pos_idx + 1
    return _head(qcfg, cfg, params, x), cache


def slot_state_specs(cfg, n_slots, s_max):
    """Per-slot serve state: the decoder's dense self-KV [n_slots, s_max,
    ...] and one encoder output per request.  The self-KV is finite, so
    the engine bounds prompt + generation by ``s_max``."""
    return cache_specs(cfg, n_slots, s_max)


def _self_attention_slots(qcfg, cfg, p, h, lens, active, cache_sl):
    """Per-row causal self-attention: each active slot writes at its own
    position ``lens[b]`` and attends its first ``lens[b] + 1`` positions,
    row for row the static decode path.  Returns (out, the new cache
    layer: new tensors)."""
    q, k, v = _split_qkv(cfg, *_qkv(qcfg, cfg, p, h))
    new = attn.cache_update_slots(cache_sl, k, v, lens, active)
    out = attn.decode_attend(q, new, lens + 1)
    return _out(qcfg, p, out), new


def decode_step_slots(cfg, params, state, batch, lens, active, qcfg):
    """Batched decode over engine slots at independent positions ``lens``
    [n_slots]; ``active`` [n_slots] bool.  A sinusoidal row depends only
    on its position, not on the table's length, so ``pe[lens]`` is the
    static path's row.  Inactive slots keep their state (their KV writes
    are dropped, ``enc_out`` is only read); ``state`` is not written."""
    pe = layers.sinusoidal_pos(state["k"].shape[2], cfg.d_model,
                               state["k"].device)
    x = _embed(cfg, params, batch["tokens"], pe[lens][:, None])
    enc_out = state["enc_out"]

    def body(qc):
        def fn(carry, inp):
            p, csl = inp
            h = run_norm(cfg, p["ln1"], carry)
            a, new = _self_attention_slots(qc, cfg, p, h, lens, active, csl)
            y = carry + a
            h = run_norm(cfg, p["ln_x"], y)
            y = y + _cross_attention(qc, cfg, p, h,
                                     _cross_kv(qc, cfg, p, enc_out))
            h = run_norm(cfg, p["ln2"], y)
            return y + _mlp(qc, p, h), new
        return fn

    x, kv = common.scan_layers(body, x, params["dec_layers"],
                               {"k": state["k"], "v": state["v"]}, qcfg)
    return (_head(qcfg, cfg, params, x),
            dict(common.stack_trees(kv), enc_out=enc_out))
