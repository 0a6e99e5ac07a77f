"""RWKV6 "Finch" (arXiv:2404.05892): attention-free time mix with a
data-dependent per-channel decay, and a channel-mix FFN (port of
``repro.models.rwkv6``).

Per head (head dim N = ``cfg.rwkv_head_dim``), per token:

    out_t = r_t^T (S_{t-1} + diag(u * k_t) v_t^T)        (the WKV readout)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T                (the state update)

with w_t = exp(-exp(w0 + lora_w(x_t))) per channel, and r, k, v, w, g
from token-shifted ddlerp mixes (a low-rank data-dependent token shift).

Training and prefill run the WKV chunk-parallel, as the reference does
(``_wkv_chunked``): the sequence is cut into chunks of ``CHUNK`` tokens; a
loop over the steps of a chunk runs every chunk at once from a zero
state, then a loop over the chunks carries the state across them with the
per-channel decay products, and each token adds its share of the state
that entered its chunk.  Everything is f32.  A sequence of S tokens needs
``S % min(CHUNK, S) == 0`` (the reference asserts it): a prompt holds at
most ``CHUNK`` tokens or a multiple of ``CHUNK``; padding would change the
state, so another length raises ``ValueError``.  Decode is the O(1)
recurrence.

The serve state (``cache_specs``): per layer the last normed input of the
time mix and of the channel mix (the token shift's carry, bf16) and the
WKV state S [B, H, N, N] (f32).  ``decode_step_slots`` steps the engine's
slots at independent positions (the recurrence has none) and returns new
tensors through ``common.merge_slot_state``: inactive slots keep theirs
bit for bit.

Under a tensor-parallel context (``distributed.ctx``) ``params`` holds
this rank's tiles, and the head count comes from them: ``wr``, ``wk``,
``wv`` and ``wg`` are column-parallel (the rank's heads), ``w0``, ``u``,
``ln_x`` and ``dec_w2`` are local slices, the token shift's ddlerp
(``ts_w1``, ``ts_w2``, ``dec_w1``) stays whole and replicated, the group
norm stays head-local and ``wo`` is row-parallel; the state ``S`` holds
the rank's heads and the shift carries stay whole.  In the channel mix
``cm_wr`` is column-parallel and ``cm_wv``'s row-parallel output is the
whole width, so the receptance is all-gathered before the product.
Under grad (training on a mesh) the gather is ``ctx.gather_from_model``
and the decay LoRA's hidden passes ``ctx.copy_to_model`` before
``dec_w2``, so ``dec_w1`` and the mix get their whole gradient.  The
embedding is vocab-parallel and the logits all-gathered.
"""
from __future__ import annotations

import torch

from ..core.qconfig import QuantConfig
from ..distributed import ctx
from . import common, decoder, layers
from .decoder import _norm_specs, run_norm

CHUNK = 64
LORA_R = 32          # ddlerp low rank
DECAY_R = 64         # decay LoRA rank


def _n_heads(cfg):
    return cfg.d_model // cfg.rwkv_head_dim


def _layer_specs(cfg):
    P = common.ParamSpec
    d = cfg.d_model
    return {
        "ln1": _norm_specs(cfg, d),
        # token-shift ddlerp: shared W1, per-stream mix and W2 (r, k, v, w, g)
        "mu": P((5, d), ("none", "embed"), init="zeros"),
        "ts_w1": P((d, 5 * LORA_R), ("embed", "none"), kind="recurrent"),
        "ts_w2": P((5, LORA_R, d), ("none", "none", "embed"), scale=0.1),
        # projections
        "wr": P((d, d), ("embed", "rnn"), kind="recurrent"),
        "wk": P((d, d), ("embed", "rnn"), kind="recurrent"),
        "wv": P((d, d), ("embed", "rnn"), kind="recurrent"),
        "wg": P((d, d), ("embed", "rnn"), kind="recurrent"),
        "wo": P((d, d), ("rnn", "embed"), kind="recurrent", scale=0.5),
        # decay: w0 + LoRA
        "w0": P((d,), ("rnn",), init="zeros"),
        "dec_w1": P((d, DECAY_R), ("embed", "none"), kind="recurrent"),
        "dec_w2": P((DECAY_R, d), ("none", "rnn"), scale=0.1),
        "u": P((d,), ("rnn",), init="zeros"),           # the bonus
        "ln_x": P((d,), ("rnn",), init="ones"),         # per-head group norm
        # channel mix (the k and r streams each get a token-shift mix)
        "ln2": _norm_specs(cfg, d),
        "cm_mu": P((2, d), ("none", "embed"), init="zeros"),
        "cm_wr": P((d, d), ("embed", "rnn"), kind="mlp"),
        "cm_wk": P((d, cfg.d_ff), ("embed", "mlp"), kind="mlp"),
        "cm_wv": P((cfg.d_ff, d), ("mlp", "embed"), kind="mlp", scale=0.5),
    }


def param_specs(cfg):
    P = common.ParamSpec
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": P((v, d), ("vocab", "embed"), init="embed", kind="embed"),
        "layers": common.stack_specs(_layer_specs(cfg), cfg.n_layers),
        "final_norm": _norm_specs(cfg, d),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, v), ("embed", "vocab"), kind="lm_head")
    return specs


def init_params(cfg, gen: torch.Generator, device="cuda"):
    return common.init_params(param_specs(cfg), gen, device)


def unembed(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------


def _token_shift(x, x_prev_last):
    """The x_{t-1} stream of x [B, S, d]; ``x_prev_last`` [B, 1, d] is the
    carry (decode), or None (zeros)."""
    if x_prev_last is None:
        x_prev_last = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev_last.to(x.dtype), x[:, :-1]], 1)


def _ddlerp(qcfg, p, x, xp):
    """Finch's data-dependent lerp: the five mixed streams r, k, v, w, g
    [B, S, 5, d]."""
    dx = xp - x
    a = torch.tanh(layers.qdense(qcfg, "recurrent", x + 0.5 * dx, p["ts_w1"]))
    b, s, _ = x.shape
    a = a.reshape(b, s, 5, LORA_R)
    # a bf16 einsum: f32 products and sums, rounded once
    coef = torch.einsum("bsir,ird->bsid", a.to(torch.float32),
                        p["ts_w2"].to(torch.float32)).to(x.dtype)
    mix = p["mu"][None, None] + coef                             # [B,S,5,d]
    return x[:, :, None, :] + dx[:, :, None, :] * mix


def _wkv_chunked(r, k, v, w, u, s0):
    """Chunk-parallel WKV, f32: r, k, v, w [B, S, H, N] (w the per-channel
    decay in [0, 1)), u [H, N], s0 [B, H, N, N] the state entering the
    sequence.  Returns (out [B, S, H, N], the final state)."""
    b, s, h, n = r.shape
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(
            f"rwkv6: the chunked WKV takes a sequence of at most {CHUNK} "
            f"tokens or a multiple of {CHUNK} (s % min({CHUNK}, s) == 0), "
            f"got {s}")
    nc = s // c
    rc, kc, vc, wc = (t.reshape(b, nc, c, h, n) for t in (r, k, v, w))

    # pass 1: a scan over each chunk's steps from a zero state, every chunk
    # at once
    uu = u[None, None, :, :, None]
    st = torch.zeros((b, nc, h, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(c):
        kv = kc[:, :, t, :, :, None] * vc[:, :, t, :, None, :]   # [B,nc,H,N,N]
        outs.append((rc[:, :, t, :, None, :] @ (st + uu * kv))[..., 0, :])
        st = wc[:, :, t, :, :, None] * st + kv
    out_local = torch.stack(outs, 2)                             # [B,nc,c,H,N]

    # the decay within a chunk: the state seen before token t decays by
    # prod_{tau < t} w_tau, the whole chunk by prod over all its tokens
    logw = torch.log(torch.clamp(wc, 1e-30, 1.0))
    cum = torch.cumsum(logw, 2)
    a_before = torch.exp(cum - logw)
    a_chunk = torch.exp(cum[:, :, -1])                           # [B,nc,H,N]

    # pass 2: the state entering each chunk
    s_run = s0.to(torch.float32)
    s_in = []
    for i in range(nc):
        s_in.append(s_run)
        s_run = a_chunk[:, i, :, :, None] * s_run + st[:, i]
    s_in = torch.stack(s_in, 1)                                  # [B,nc,H,N,N]

    # combine: out_t += (r_t * prod_{tau < t} w) . S_in
    r_dec = (rc * a_before).permute(0, 1, 3, 2, 4)               # [B,nc,H,c,N]
    out_inter = (r_dec @ s_in).permute(0, 1, 3, 2, 4)            # [B,nc,c,H,N]
    return (out_local + out_inter).reshape(b, s, h, n), s_run


def _time_mix(qcfg, cfg, p, x, state, mode):
    """``state``: {"x_prev_tm" [B, 1, d], "S" [B, H, N, N]} or None
    (training); H and the projections' width are this rank's under TP.
    Returns (y, the new state)."""
    b, s, _ = x.shape
    n = cfg.rwkv_head_dim
    h = _n_heads(cfg) // ctx.tp_size()
    d = h * n
    xp = _token_shift(x, state["x_prev_tm"] if mode == "decode" else None)
    mixed = _ddlerp(qcfg, p, x, xp)
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(5))

    f32 = torch.float32

    def col(xi, w):
        return layers.qdense(qcfg, "recurrent", xi, w, parallelism="column")

    r = col(xr, p["wr"]).to(f32)
    k = col(xk, p["wk"]).to(f32)
    v = col(xv, p["wv"]).to(f32)
    g = col(xg, p["wg"])
    # the decay LoRA: ``dec_w1`` whole on every rank, ``dec_w2`` its columns
    # of the rank's channels, so the hidden's gradient is summed over the
    # model group (each rank's columns see their share of it)
    lora = torch.tanh(layers.qdense(qcfg, "recurrent", xw, p["dec_w1"])
                      .to(f32))
    dec = p["w0"].to(f32) + ctx.copy_to_model(lora, ctx.current()) @ p[
        "dec_w2"].to(f32)
    w = torch.exp(-torch.exp(torch.clamp(dec, -38.0, 20.0)))    # [0, 1)

    rs, ks, vs, ws = (t.reshape(b, s, h, n) for t in (r, k, v, w))
    u = p["u"].to(f32).reshape(h, n)
    s0 = (state["S"] if mode == "decode"      # prefill: a zero state
          else torch.zeros((b, h, n, n), dtype=f32, device=x.device))
    if mode == "decode":
        kv = ks[:, 0, :, :, None] * vs[:, 0, :, None, :]
        out = (rs[:, 0, :, None, :] @ (s0 + u[None, :, :, None] * kv))
        out = out.reshape(b, 1, h, n)
        s_fin = ws[:, 0, :, :, None] * s0 + kv
    else:
        out, s_fin = _wkv_chunked(rs, ks, vs, ws, u, s0)

    # per-head group norm, then the gate
    mu = torch.mean(out, -1, keepdim=True)
    var = torch.mean(torch.square(out - mu), -1, keepdim=True)
    of = (out - mu) * torch.rsqrt(var + 1e-5)
    of = of.reshape(b, s, d) * p["ln_x"].to(f32)
    y = of.to(x.dtype) * layers.silu(g)
    y = layers.qdense(qcfg, "recurrent", y, p["wo"], parallelism="row")
    return y, {"x_prev_tm": x[:, -1:], "S": s_fin}


def _gather_receptance(r: torch.Tensor) -> torch.Tensor:
    """Under TP the channel mix's receptance, this rank's columns
    all-gathered whole; its backward keeps this rank's columns of the
    gradient (every rank computes the same product downstream)."""
    if ctx.tp_size() == 1:
        return r
    return ctx.gather_from_model(r, ctx.current(), -1)


def _channel_mix(qcfg, p, x, state, mode):
    xp = _token_shift(x, state["x_prev_cm"] if mode == "decode" else None)
    dx = xp - x
    mu = p["cm_mu"].to(x.dtype)
    xk = x + dx * mu[0]
    xr = x + dx * mu[1]
    r = torch.sigmoid(layers.qdense(qcfg, "mlp", xr, p["cm_wr"],
                                    parallelism="column")
                      .to(torch.float32)).to(x.dtype)
    r = _gather_receptance(r)
    hk = torch.square(torch.relu(layers.qdense(qcfg, "mlp", xk, p["cm_wk"],
                                               parallelism="column")))
    y = r * layers.qdense(qcfg, "mlp", hk, p["cm_wv"], parallelism="row")
    return y, {"x_prev_cm": x[:, -1:]}


def _block(qcfg, cfg, p, x, state, mode):
    h1 = run_norm(cfg, p["ln1"], x)
    tm, st1 = _time_mix(qcfg, cfg, p, h1, state, mode)
    x = x + tm
    h2 = run_norm(cfg, p["ln2"], x)
    cm, st2 = _channel_mix(qcfg, p, h2, state, mode)
    return x + cm, {**st1, **st2}


# ---------------------------------------------------------------------------
# the model protocol
# ---------------------------------------------------------------------------


def _head(qcfg, cfg, params, x):
    return decoder._lm_head(qcfg, cfg, params, x)


def apply(cfg, params, batch, qcfg: QuantConfig,
          output: str = "logits") -> torch.Tensor:
    """Teacher-forcing forward: [B, S] tokens -> [B, S, V] logits, or the
    final-normed hidden states with ``output="hidden"``; the layers run
    under ``cfg.remat`` when grad is on."""
    x = decoder.embed_tokens(cfg, params, batch["tokens"])

    def body(qc):
        def fn(carry, inp):
            p, _ = inp
            return _block(qc, cfg, p, carry, None, "train")[0], None
        return fn

    x, _ = common.scan_layers(body, x, params["layers"], None, qcfg,
                              qcfg.skip_first_layers, qcfg.skip_last_layers,
                              cfg.remat)
    if output == "hidden":
        return run_norm(cfg, params["final_norm"], x)
    return _head(qcfg, cfg, params, x)


def cache_specs(cfg, batch_size, s_max):
    """Specs of the serve state; its size does not depend on ``s_max``."""
    P = common.ParamSpec
    d, h, n, L = cfg.d_model, _n_heads(cfg), cfg.rwkv_head_dim, cfg.n_layers
    shift = P((L, batch_size, 1, d), ("layers", "batch", "none", "embed"),
              init="zeros")
    return {"x_prev_tm": shift, "x_prev_cm": shift,
            "S": P((L, batch_size, h, n, n),
                   ("layers", "batch", "heads", "none", "none"),
                   dtype=torch.float32, init="zeros")}


def init_cache(cfg, batch_size, s_max, device="cuda") -> dict:
    """A zero serve state for ``batch_size`` rows and ``pos`` 0."""
    cache = common.zeros_from_specs(cache_specs(cfg, batch_size, s_max),
                                    device)
    cache["pos"] = 0
    return cache


def _scan_state(cfg, params, x, qcfg, state, mode):
    """The layer stack over a stacked state tree (no ``pos``): (x, the
    stacked new state)."""
    def body(qc):
        def fn(carry, inp):
            p, st = inp
            return _block(qc, cfg, p, carry, st, mode)
        return fn

    xs = {k: v for k, v in state.items() if k != "pos"}
    x, new = common.scan_layers(body, x, params["layers"], xs, qcfg,
                                qcfg.skip_first_layers, qcfg.skip_last_layers)
    return x, common.stack_trees(new)


def decode_step(cfg, params, cache, batch, qcfg: QuantConfig):
    """One-token decode: batch["tokens"] [B, 1].  Returns (logits
    [B, 1, V], a new state with ``pos`` advanced)."""
    x = decoder.embed_tokens(cfg, params, batch["tokens"])
    x, new = _scan_state(cfg, params, x, qcfg, cache, "decode")
    new["pos"] = cache["pos"] + 1
    return _head(qcfg, cfg, params, x), new


def slot_state_specs(cfg, n_slots, s_max):
    """Per-slot serve-state slabs (batch axis = slot): constant in size,
    whatever the prompt and the generation."""
    return cache_specs(cfg, n_slots, s_max)


def decode_step_slots(cfg, params, state, batch, lens, active, qcfg):
    """Batched decode over engine slots.  The recurrence has no position,
    so this is ``decode_step`` over the slot batch (``lens`` is taken for
    the protocol's sake); inactive slots keep their state bit for bit, and
    ``state`` itself is not written."""
    del lens
    x = decoder.embed_tokens(cfg, params, batch["tokens"])
    x, new = _scan_state(cfg, params, x, qcfg, state, "decode")
    specs = slot_state_specs(cfg, batch["tokens"].shape[0], 0)
    return (_head(qcfg, cfg, params, x),
            common.merge_slot_state(specs, state, new, active))


def prefill(cfg, params, batch, qcfg: QuantConfig, s_max: int | None = None):
    """Prompt pass from a zero state: (last-token logits [B, 1, V], the
    serve state).  The prompt's length must suit the chunked WKV (at most
    ``CHUNK`` tokens or a multiple of ``CHUNK``)."""
    x = decoder.embed_tokens(cfg, params, batch["tokens"])
    b, s = batch["tokens"].shape
    cache = init_cache(cfg, b, s_max or s, x.device)
    x, new = _scan_state(cfg, params, x, qcfg, cache, "prefill")
    new["pos"] = s
    return _head(qcfg, cfg, params, x[:, -1:]), new
