"""Config registry: ``get_config(name)`` / ``get_smoke(name)`` /
``--arch <id>`` resolution.  10 assigned architectures + 2 paper models."""
from __future__ import annotations

from . import (acereason_7b, arctic_480b, base, granite_34b, nemotron_nano_9b,
               olmo_1b, qwen2_moe_a27b, qwen2_vl_2b, qwen15_05b, qwen25_14b,
               recurrentgemma_2b, rwkv6_3b, whisper_tiny)
from .base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    # --- 10 assigned architectures ---
    "olmo-1b": olmo_1b,
    "qwen1.5-0.5b": qwen15_05b,
    "qwen2.5-14b": qwen25_14b,
    "granite-34b": granite_34b,
    "arctic-480b": arctic_480b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "rwkv6-3b": rwkv6_3b,
    "whisper-tiny": whisper_tiny,
    # --- the paper's own models ---
    "acereason-7b": acereason_7b,
    "nemotron-nano-9b-sim": nemotron_nano_9b,
}

ASSIGNED = list(_MODULES)[:10]
ALL_ARCHS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
