"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks and periodic local
attention (port of ``repro.models.rglru``).

RG-LRU (Griffin, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t)                  (recurrence gate)
    i_t = sigmoid(W_x x_t)                  (input gate)
    a_t = exp(-c softplus(lam) r_t)         (per-channel decay, c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

A recurrent layer wraps the LRU with a width-4 causal depthwise conv and a
GeLU-gated output, then a SwiGLU MLP.  Layer ``i`` is a local-attention
transformer layer (``decoder._block``, window ``cfg.window``; 0 = full)
when ``(i + 1) % attn_period == 0``, else recurrent: the stack is
``n_sb`` super-blocks of ``attn_period - 1`` recurrent layers and one
attention layer, then a remainder of recurrent layers.  The parameter
tree is the reference's: ``blocks/rec`` leaves [n_sb, n_rec, ...] (two
leading stack axes, "layers" and "inner"; PTQ gives a packed leaf a
tensor scale per [layer, inner] slice), ``blocks/attn`` [n_sb, ...] and
``rem`` [n_rem, ...].

Prefill and training run the recurrence as a log-depth scan over whole
tensors (``_lru_scan``: the odd/even recursion of
``jax.lax.associative_scan``, in f32, so the products and sums are the
reference's); decode carries ``h`` and the conv's last inputs as O(1)
state.  The serve state:

    init_cache / prefill / decode_step   the static path (``serve_batch``):
        the attention KV written IN PLACE, the recurrent state new;
    slot_state_specs / decode_step_slots the slab engine: per-slot state
        at independent positions, returned as NEW tensors through
        ``common.merge_slot_state`` (inactive slots keep theirs bit for
        bit; a tree a caller holds is never written).

``prefill`` pads the attention KV of a windowless config to ``s_max``,
as ``cache_specs`` sizes it; the reference returns the prompt's length
there, and its decode then writes past the end (``ROADMAP.md`` C).

Under a tensor-parallel context (``distributed.ctx``) ``params`` holds
this rank's tiles, and every width comes from them: ``wx`` and ``wgate``
are column-parallel (the rank's slice of ``d_rnn``), so the conv, ``lam``
and the conv and ``h`` state are local slices; ``w_a`` and ``w_i``'s
packed tiles split on their output dim and take the whole post-conv
``z``, all-gathered once a layer, while their dense tiles (training on a
mesh) split on their input dim, as the reference's rules place them, and
reduce-scatter their partial pre-activations (``_gates``); ``b = beta * i
* z`` stays on the local slice; ``wo`` and the MLP's ``wd`` are
row-parallel.  Under grad every collective is ``ctx``'s autograd form.
The attention layers are the decoder's (local query heads; the local KV
heads, or an MQA config's one KV head replicated), the embedding
vocab-parallel and the logits all-gathered.
"""
from __future__ import annotations

import torch

from ..core.nvfp4 import PackedNVFP4
from ..core.qconfig import QuantConfig
from ..distributed import ctx
from . import common, decoder, layers
from .decoder import _norm_specs, run_norm

C_LRU = 8.0


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _rec_layer_specs(cfg):
    P = common.ParamSpec
    d, dr, ff = cfg.d_model, cfg.d_rnn, cfg.d_ff
    return {
        "ln1": _norm_specs(cfg, d),
        "wx": P((d, dr), ("embed", "rnn"), kind="recurrent"),
        "wgate": P((d, dr), ("embed", "rnn"), kind="recurrent"),
        "conv_w": P((cfg.conv_width, dr), ("none", "rnn"), scale=0.5),
        "conv_b": P((dr,), ("rnn",), init="zeros"),
        "w_a": P((dr, dr), ("rnn", "rnn"), kind="recurrent"),
        "w_i": P((dr, dr), ("rnn", "rnn"), kind="recurrent"),
        "lam": P((dr,), ("rnn",), init="lru_lambda"),
        "wo": P((dr, d), ("rnn", "embed"), kind="recurrent", scale=0.5),
        "ln2": _norm_specs(cfg, d),
        "wg": P((d, ff), ("embed", "mlp"), kind="mlp"),
        "wu": P((d, ff), ("embed", "mlp"), kind="mlp"),
        "wd": P((ff, d), ("mlp", "embed"), kind="mlp", scale=0.5),
    }


def _counts(cfg):
    """(super-blocks, recurrent layers in each, trailing recurrent layers)."""
    p = cfg.attn_period
    n_sb = cfg.n_layers // p
    return n_sb, p - 1, cfg.n_layers - n_sb * p


def param_specs(cfg):
    P = common.ParamSpec
    d, v = cfg.d_model, cfg.vocab_size
    n_sb, n_rec, n_rem = _counts(cfg)
    rec = _rec_layer_specs(cfg)
    specs = {
        "embed": P((v, d), ("vocab", "embed"), init="embed", kind="embed"),
        "blocks": {
            "rec": common.stack_specs(common.stack_specs(rec, n_rec, "inner"),
                                      n_sb),
            "attn": common.stack_specs(decoder._layer_specs(cfg), n_sb),
        },
        "final_norm": _norm_specs(cfg, d),
    }
    if n_rem:
        specs["rem"] = common.stack_specs(rec, n_rem)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, v), ("embed", "vocab"), kind="lm_head")
    return specs


def init_params(cfg, gen: torch.Generator, device="cuda"):
    return common.init_params(param_specs(cfg), gen, device)


def unembed(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv of width W: x [B, S, D], ``state`` the last
    W - 1 inputs [B, W-1, D] (decode) or None (zeros).  Returns (y, the
    new state: the last W - 1 inputs).  Each product and each sum rounds
    to x's dtype, in the reference's order."""
    wdt, d = w.shape
    if state is None:
        pad = torch.zeros((x.shape[0], wdt - 1, d), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                      # [B, S + W - 1, D]
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(wdt)) + b
    return y.to(x.dtype), xp[:, -(wdt - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(qcfg, p, z, tp):
    """The recurrence and input gates' pre-activations, f32, on this rank's
    channels.  Under TP packed tiles (serving) split the gates' output dim:
    they take the whole ``z``, all-gathered once.  Dense tiles (training on
    a mesh, and serving's "qdq" weights) split their input dim, as the
    rules place an ``("rnn", "rnn")`` weight: the local ``z`` multiplies
    each and the partial pre-activations are reduce-scattered to the
    rank's channels, their gradient all-gathered back
    (``ctx.scatter_from_model``)."""
    ws = (p["w_a"], p["w_i"])
    if tp is None or tp.size == 1:
        ys = [layers.qdense(qcfg, "recurrent", z, w) for w in ws]
    elif isinstance(ws[0], PackedNVFP4):
        zf = tp.all_gather(z, -1)
        ys = [layers.qdense(qcfg, "recurrent", zf, w, parallelism="column")
              for w in ws]
    else:
        ys = [layers.qdense(qcfg, "recurrent", z, w,
                            parallelism="row_scatter") for w in ws]
    return [y.to(torch.float32) for y in ys]


def _lru_gates(qcfg, p, z):
    """(a, b) of h_t = a_t h_{t-1} + b_t, f32, from the conv output z
    (this rank's slice of it under TP; ``_gates``)."""
    r, i = (torch.sigmoid(y) for y in _gates(qcfg, p, z, ctx.current()))
    log_a = -C_LRU * _softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return a, beta * (i * z.to(torch.float32))


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along axis 1 (``even`` as long as ``odd`` or
    one longer)."""
    n_o = odd.shape[1]
    pairs = torch.stack([even[:, :n_o], odd], 2)
    out = pairs.reshape(even.shape[0], 2 * n_o, *even.shape[2:])
    return torch.cat([out, even[:, n_o:]], 1) if even.shape[1] > n_o else out


def _lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1: the odd/even
    recursion of ``jax.lax.associative_scan`` with the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2), whole tensors at each of
    its log2(S) levels, so every product and sum is the reference's."""
    def combine(x, y):
        (a1, b1), (a2, b2) = x, y
        return a1 * a2, a2 * b1 + b2

    def scan(el):
        n = el[0].shape[1]
        if n < 2:
            return el
        odd = scan(combine(tuple(e[:, 0:-1:2] for e in el),
                           tuple(e[:, 1::2] for e in el)))
        if n % 2 == 0:
            even = combine(tuple(e[:, :-1] for e in odd),
                           tuple(e[:, 2::2] for e in el))
        else:
            even = combine(odd, tuple(e[:, 2::2] for e in el))
        even = tuple(torch.cat([e[:, :1], r], 1) for e, r in zip(el, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    return scan((a, b))[1]


def _rec_block(qcfg, cfg, p, x, mode, state_sl):
    """One recurrent layer; ``state_sl`` {"conv" [B, W-1, dr], "h"
    [B, 1, dr] f32} in decode.  Returns (x, its new state)."""
    h_in = run_norm(cfg, p["ln1"], x)
    z = layers.qdense(qcfg, "recurrent", h_in, p["wx"], parallelism="column")
    gate = layers.qdense(qcfg, "recurrent", h_in, p["wgate"],
                         parallelism="column")
    z, conv_state = _causal_conv(z, p["conv_w"], p["conv_b"],
                                 state_sl["conv"] if mode == "decode" else None)
    a, b = _lru_gates(qcfg, p, z)
    if mode == "decode":
        hh = a * state_sl["h"].to(torch.float32) + b
        h_last = hh
    else:
        hh = _lru_scan(a, b)
        h_last = hh[:, -1:]
    y = hh.to(x.dtype) * layers.gelu(gate)
    x = x + layers.qdense(qcfg, "recurrent", y, p["wo"], parallelism="row")
    h2 = run_norm(cfg, p["ln2"], x)
    x = x + layers.swiglu_mlp(qcfg, h2, p["wg"], p["wu"], p["wd"])
    return x, {"conv": conv_state, "h": h_last.to(torch.float32)}


def _rec_stack(qcfg, cfg, stacked, x, mode, states):
    """The recurrent layers of a stack [n, ...] in order; ``states`` their
    stacked decode state or None.  Returns (x, stacked new states)."""
    n = common.n_layers(stacked)
    ps = common.unstack(stacked, n)
    ss = common.unstack(states, n) if states is not None else [None] * n
    new = []
    for p, st in zip(ps, ss):
        x, st = _rec_block(qcfg, cfg, p, x, mode, st)
        new.append(st)
    return x, common.stack_trees(new)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _embed(cfg, params, batch):
    return decoder.embed_tokens(cfg, params, batch["tokens"])


def _positions(x, offset=0):
    b, s = x.shape[:2]
    return (torch.arange(s, device=x.device) + offset).expand(b, s)


def _head(qcfg, cfg, params, x):
    return decoder._lm_head(qcfg, cfg, params, x)


def _rem(qcfg, cfg, params, x, mode, states=None):
    """The trailing recurrent layers, if any: (x, their states or None)."""
    if "rem" not in params:
        return x, None
    return _rec_stack(qcfg, cfg, params["rem"], x, mode, states)


def apply(cfg, params, batch, qcfg: QuantConfig,
          output: str = "logits") -> torch.Tensor:
    """Teacher-forcing forward: [B, S] tokens -> [B, S, V] logits, or the
    final-normed hidden states with ``output="hidden"``; the super-blocks
    run under ``cfg.remat`` when grad is on."""
    x = _embed(cfg, params, batch)
    pos = _positions(x)

    def body(qc):
        def fn(carry, inp):
            p, _ = inp
            x, _ = _rec_stack(qc, cfg, p["rec"], carry, "train", None)
            return decoder._block(qc, cfg, p["attn"], x, pos, "train", None,
                                  None), None
        return fn

    x, _ = common.scan_layers(body, x, params["blocks"], None, qcfg, 0, 0,
                              cfg.remat)
    x, _ = _rem(qcfg, cfg, params, x, "train")
    if output == "hidden":
        return run_norm(cfg, params["final_norm"], x)
    return _head(qcfg, cfg, params, x)


def cache_specs(cfg, batch_size, s_max, n_kv: int | None = None):
    """Specs of the serve state: the recurrent layers' conv and h, the
    attention layers' KV (at most ``window`` positions for a windowed
    config) of ``n_kv`` KV heads (all of the config's by default)."""
    P = common.ParamSpec
    n_sb, n_rec, n_rem = _counts(cfg)
    dr, w = cfg.d_rnn, cfg.conv_width
    s_alloc = min(s_max, cfg.window) if cfg.window else s_max

    def rec_specs(lead, lead_axes):
        return {"conv": P((*lead, batch_size, w - 1, dr),
                          (*lead_axes, "batch", "none", "rnn"), init="zeros"),
                "h": P((*lead, batch_size, 1, dr),
                       (*lead_axes, "batch", "none", "rnn"),
                       dtype=torch.float32, init="zeros")}

    kv_shape = (n_sb, batch_size, s_alloc, n_kv or cfg.n_kv_heads,
                cfg.head_dim)
    kv_axes = ("layers", "batch", "seq", "kv", "headdim")
    c = {"blocks": {"rec": rec_specs((n_sb, n_rec), ("layers", "inner")),
                    "kv": {"k": P(kv_shape, kv_axes, init="zeros"),
                           "v": P(kv_shape, kv_axes, init="zeros")}}}
    if n_rem:
        c["rem"] = rec_specs((n_rem,), ("layers",))
    return c


def init_cache(cfg, batch_size, s_max, device="cuda") -> dict:
    """A zero serve state for ``batch_size`` rows and ``pos`` 0."""
    cache = common.zeros_from_specs(cache_specs(cfg, batch_size, s_max),
                                    device)
    cache["pos"] = 0
    return cache


def prefill(cfg, params, batch, qcfg: QuantConfig, s_max: int | None = None):
    """Prompt pass: (last-token logits [B, 1, V], serve state).  The
    attention KV is a ring of ``window`` positions (the last ones, ring-
    aligned, or the prompt's and zeros), or without a window the prompt's
    kv padded to ``s_max`` positions."""
    x = _embed(cfg, params, batch)
    b, s = batch["tokens"].shape
    pos = _positions(x)
    s_alloc = cfg.window or max(s_max or s, s)
    n_kv = decoder._local_heads(cfg)[1]
    kv = common.zeros_from_specs(
        cache_specs(cfg, b, s_alloc, n_kv)["blocks"]["kv"], x.device)

    def body(qc):
        def fn(carry, inp):
            p, kv_sl = inp
            x, st = _rec_stack(qc, cfg, p["rec"], carry, "prefill", None)
            x = decoder._block(qc, cfg, p["attn"], x, pos, "prefill", kv_sl,
                               None)
            return x, st
        return fn

    x, rec = common.scan_layers(body, x, params["blocks"], kv, qcfg, 0, 0,
                                cfg.remat)
    cache = {"blocks": {"rec": common.stack_trees(rec), "kv": kv}, "pos": s}
    x, rem = _rem(qcfg, cfg, params, x, "prefill")
    if rem is not None:
        cache["rem"] = rem
    return _head(qcfg, cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, cache, batch, qcfg: QuantConfig):
    """One-token decode: batch["tokens"] [B, 1] at ``cache["pos"]``.  The
    attention KV is written IN PLACE; the recurrent state is new.
    Returns (logits [B, 1, V], the cache with ``pos`` advanced)."""
    x = _embed(cfg, params, batch)
    pos_idx = cache["pos"]
    pos = torch.full((x.shape[0], 1), pos_idx, dtype=torch.int64,
                     device=x.device)

    def body(qc):
        def fn(carry, inp):
            p, sl = inp
            x, st = _rec_stack(qc, cfg, p["rec"], carry, "decode", sl["rec"])
            x = decoder._block(qc, cfg, p["attn"], x, pos, "decode", sl["kv"],
                               pos_idx)
            return x, st
        return fn

    x, rec = common.scan_layers(body, x, params["blocks"], cache["blocks"],
                                qcfg)
    new = {"blocks": {"rec": common.stack_trees(rec),
                      "kv": cache["blocks"]["kv"]}, "pos": pos_idx + 1}
    x, rem = _rem(qcfg, cfg, params, x, "decode", cache.get("rem"))
    if rem is not None:
        new["rem"] = rem
    return _head(qcfg, cfg, params, x), new


def slot_state_specs(cfg, n_slots, s_max):
    """Per-slot serve-state slabs (batch axis = slot): the recurrent
    layers' conv and h, and the attention KV, a ring of exactly ``window``
    positions for a windowed config (constant per slot however long a
    request runs), else ``s_max`` positions."""
    s_eff = max(s_max, cfg.window) if cfg.window else s_max
    return cache_specs(cfg, n_slots, s_eff)


def decode_step_slots(cfg, params, state, batch, lens, active, qcfg):
    """Batched decode over engine slots at independent positions ``lens``
    [n_slots]; ``active`` [n_slots] bool.  The recurrent layers step every
    row; the attention layers use per-row RoPE, ring writes and validity
    (``decoder._block_slots``).  Returns (logits [n_slots, 1, V], the new
    state): inactive slots keep theirs bit for bit, and ``state`` itself
    is not written."""
    x = _embed(cfg, params, batch)

    def body(qc):
        def fn(carry, inp):
            p, sl = inp
            x, st = _rec_stack(qc, cfg, p["rec"], carry, "decode", sl["rec"])
            x, kv = decoder._block_slots(qc, cfg, p["attn"], x, lens, active,
                                         sl["kv"])
            return x, {"rec": st, "kv": kv}
        return fn

    x, ys = common.scan_layers(body, x, params["blocks"], state["blocks"],
                               qcfg)
    new = {"blocks": common.stack_trees(ys)}
    x, rem = _rem(qcfg, cfg, params, x, "decode", state.get("rem"))
    if rem is not None:
        new["rem"] = rem
    specs = slot_state_specs(cfg, batch["tokens"].shape[0], 0)
    return (_head(qcfg, cfg, params, x),
            common.merge_slot_state(specs, state, new, active))
