"""Speculative decoding on the continuous-batching engine (port of
``repro.spec``).

  * ``proposer``: draft proposers over mirrored draft state, a paged KV
    pool twin (``DraftProposer``) or per-slot state slabs with their own
    snapshot chain (``SlabDraftProposer``); the drafts are the target's
    own QDQ forward (``self-qdq``), its first layers (``self-truncate``)
    or a second, smaller model (``two-model``);
  * ``engine``: ``SpecEngine``, an ``Engine`` whose decode step drafts k
    tokens a slot, scores the k + 1 positions (one
    ``decoder.verify_step_paged`` on the paged plan; k + 1 masked
    ``decode_step_slots`` calls with state snapshots on a slab plan),
    accepts losslessly and rolls back the rest.

Greedy speculative decode emits token for token what the plain engine
emits, for every draft mode::

    from repro_torch.spec import SpecEngine
    eng = SpecEngine(cfg, params, qcfg, draft_k=4, draft="self-qdq",
                     device="cpu")
    eng.submit(prompt_tokens, max_new_tokens=16)
    outputs = eng.drain()
    eng.stats()["acceptance_rate"], eng.stats()["accepted_per_step"]
"""
from .engine import SpecEngine
from .proposer import DraftProposer, SlabDraftProposer, self_draft_model

__all__ = ["SpecEngine", "DraftProposer", "SlabDraftProposer",
           "self_draft_model"]
