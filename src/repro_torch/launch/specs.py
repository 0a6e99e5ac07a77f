"""Quantization configs per recipe (port of ``repro.launch.specs``, lines
22-34).  The dry-run's abstract input specs have no counterpart yet."""
from __future__ import annotations

import dataclasses

from ..configs import ModelConfig
from ..core import qconfig


def recipe_qconfig(cfg: ModelConfig) -> qconfig.QuantConfig:
    return {
        "all": qconfig.NVFP4_ALL,
        "hybrid": qconfig.NVFP4_HYBRID,
        "moe_hybrid": qconfig.NVFP4_MOE_HYBRID,
    }[cfg.quant_recipe]


def serve_qconfig(cfg: ModelConfig) -> qconfig.QuantConfig:
    """Serving: weights are quantized offline (already on the E2M1 grid),
    so only activations are fake-quantized at run time."""
    return dataclasses.replace(recipe_qconfig(cfg), quantize_weights=False)
