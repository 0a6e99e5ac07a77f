"""Continuous-batching serving engine over packed NVFP4 weights (port of
``repro.serve``).

  * ``state``     — the per-layer state protocol: ``PagedKVState``, the
                    block-granular KV pool of decoder-family archs, and
                    ``SlabState``, per-slot state slabs (recurrent state,
                    window rings, dense KV, encoder outputs)
  * ``paged_kv``  — the pool's host-side refcounted allocator and the
                    content-hashed ``PrefixCache``
  * ``scheduler`` — request admission / slot assignment / retirement and
                    lowest-progress preemption
  * ``sampling``  — greedy, temperature, top-k with per-request seeds
  * ``engine``    — the ``submit / step / drain`` facade over the
                    state backend's forwards

Quickstart::

    from repro_torch.serve import Engine
    eng = Engine(cfg, params, qcfg)            # params on the card
    eng.submit(prompt_tokens, max_new_tokens=16)
    outputs = eng.drain()          # {request id: generated tokens}
"""
from .engine import Engine
from .paged_kv import PagedKVPool
from .sampling import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler
from .state import PagedKVState, SlabState, UnsupportedStateError

__all__ = ["Engine", "PagedKVPool", "PagedKVState", "Request",
           "SamplingParams", "Scheduler", "SlabState",
           "UnsupportedStateError", "sample_tokens"]
