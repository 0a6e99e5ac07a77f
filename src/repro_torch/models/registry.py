"""Family registry: ``ModelConfig.family`` -> model module (port of
``repro.models.registry``).  The port serves the ``decoder`` family; the
recurrent and encoder-decoder families come with the slab-family slice."""
from __future__ import annotations

from . import decoder

_FAMILIES = {"decoder": decoder}
_LATER = {"rglru_hybrid", "rwkv6", "encdec"}


def get_model(cfg):
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    if cfg.family in _LATER:
        raise NotImplementedError(f"model family {cfg.family!r} is part of "
                                  "the slab-family slice of the port")
    raise ValueError(f"unknown model family: {cfg.family!r}")
