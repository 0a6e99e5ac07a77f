"""Family registry: ``ModelConfig.family`` -> model module, and the
per-layer serve-state plans (port of ``repro.models.registry``)."""
from __future__ import annotations

from . import decoder, rglru, rwkv6, whisper

_FAMILIES = {"decoder": decoder, "rglru_hybrid": rglru, "rwkv6": rwkv6,
             "encdec": whisper}


def get_model(cfg):
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    raise ValueError(f"unknown model family: {cfg.family!r}")


# state kinds the engine's design implements; anything else in a plan makes
# the config unservable.  The port serves "paged_kv" and, through
# ``serve.state.SlabState``, the slab kinds of the families it has.
SUPPORTED_STATE_KINDS = frozenset({
    "paged_kv",          # block-granular KV pool (decoder family)
    "recurrent",         # constant-size RNN state slabs (RWKV6 / RG-LRU)
    "window_kv",         # fixed-window ring KV slabs (RG-LRU local attn)
    "dense_kv",          # finite dense KV slabs (encoder-decoder self-attn)
    "encoder_output",    # immutable per-request encoder slots (cross-attn)
})


def serve_state_plan(cfg) -> tuple:
    """The per-layer state kinds a config needs to serve, deduplicated.

    A plan of ("paged_kv",) serves through the paged pool; other supported
    plans through constant-size slot slabs.  Unsupported kinds (M-RoPE's
    "vision_prefix") are still declared so capability errors can name them.
    """
    if cfg.family == "decoder":
        return ("paged_kv", "vision_prefix") if cfg.mrope_sections \
            else ("paged_kv",)
    if cfg.family == "rwkv6":
        return ("recurrent",)
    if cfg.family == "rglru_hybrid":
        return ("recurrent", "window_kv") if cfg.window \
            else ("recurrent", "dense_kv")
    if cfg.family == "encdec":
        return ("dense_kv", "encoder_output")
    raise ValueError(f"no serve-state plan for family {cfg.family!r}")


def serve_capabilities(cfg) -> dict:
    """Whether the engine can serve ``cfg``, and what is missing if not:
    {"plan", "supported", "missing"}."""
    plan = serve_state_plan(cfg)
    missing = tuple(k for k in plan if k not in SUPPORTED_STATE_KINDS)
    return {"plan": plan, "supported": not missing, "missing": missing}
