"""Draft proposers: autoregressive k-token proposals over mirrored state
(port of ``repro.spec.proposer``).

A proposer owns a draft model (config, parameters, serving policy) and a
mirror of the target engine's request state: ``DraftProposer`` keeps a
paged KV pool of the same block geometry, addressed by the same block ids
(FP8 pages with their scales when the draft's config keeps FP8 KV);
``SlabDraftProposer`` keeps per-slot state slabs addressed by the same slot
indices.  One allocator, the target's, governs both, so admission,
rollback and retirement stay in the scheduler.

``Request.draft_cached`` counts the leading draft positions computed from
the accepted tokens.  After a round that accepted j of ke proposals it is
``base + min(j + 1, ke)``; when every proposal survives the draft lags the
target by one position, and the next round starts with a one-token
catch-up feed.  Rejected draft positions need no device work on the paged
path (the next round's writes overwrite them); the slab path restores a
snapshot, since recurrent state is cumulative.

Any proposal distribution keeps the engine lossless, so the paged proposer
runs per-token activation scales (``act_scope="token"``), as the verify
step does; its prefill mirrors the target's prefill numerics (row scope
for exact prefill, token scope for paged prefill), so a ``self-qdq`` draft
reproduces the target and accepts nearly everything.

The proposal loop keeps its tokens on the device: a round's proposals
reach the host once, with the verify step's result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import common, decoder
from ..models.registry import get_model
from ..obs import NOOP as OBS_NOOP
from ..serve import state as state_mod
from ..serve.sampling import draft_sample_tokens


def self_draft_model(cfg, params, mode: str = "qdq", n_layers: int = 0):
    """A draft (cfg, params) made from the target itself.

    ``qdq``: the whole model (for a QDQ-served target the target bit for
    bit; for a packed one the same packed weights).  ``truncate``: the
    first ``n_layers`` layers (default half) with the target's embedding,
    final norm and LM head.  The stacked ``layers`` leaves are sliced,
    ``PackedNVFP4`` codes, block scales and per-layer tensor scales alike
    (``PackedNVFP4.__getitem__``): views of the target's tensors, no copy.
    """
    if mode == "qdq":
        return cfg, params
    if mode != "truncate":
        raise ValueError(f"unknown self-draft mode {mode!r}")
    if "layers" not in params:
        raise ValueError(
            "self-truncate needs a stacked 'layers' parameter tree; "
            f"{cfg.family!r} params have none: use self-qdq or two-model")
    dl = n_layers or max(1, cfg.n_layers // 2)
    if not 1 <= dl <= cfg.n_layers:
        raise ValueError(f"draft depth {dl} outside 1..{cfg.n_layers}")
    dcfg = dataclasses.replace(cfg, n_layers=dl, name=f"{cfg.name}-draft{dl}")
    dparams = dict(params)
    dparams["layers"] = common.tree_map(lambda a: a[:dl], params["layers"])
    return dcfg, dparams


def _moe_local(cfg):
    if cfg.n_experts and cfg.moe_dispatch not in ("local", "token"):
        return dataclasses.replace(cfg, moe_dispatch="local")
    return cfg


def _round_out(toks: list, qs: list, ns: int, k: int, device):
    """A round's (draft_tokens [ns, k] int64, draft_probs [ns, k, V] or
    None) from its proposal steps' tokens and q: columns past the steps
    taken are zeros; no q when no step drew (an all-greedy batch, or no
    step at all)."""
    out = torch.zeros((ns, k), dtype=torch.int64, device=device)
    if toks:
        out[:, :len(toks)] = torch.stack(toks, 1)
    if not qs or qs[0] is None:
        return out, None
    probs = torch.stack(qs, 1)
    return out, torch.nn.functional.pad(probs, (0, 0, 0, k - probs.shape[1]))


class DraftProposer:
    """k-token autoregressive proposals against a paged draft pool.

    ``qcfg`` is the draft's serving policy (weights already quantized, no
    run-time weight fake-quant here).  ``pool`` is the TARGET engine's
    ``PagedKVPool``: the mirror copies its geometry and uses its block
    ids, but keeps its own pages on ``device``.  ``obs``: the engine's
    telemetry bundle (``spec_draft_steps_total``, the
    ``spec.draft_prefill`` spans).
    """

    def __init__(self, cfg, params, qcfg, *, pool, device, fused: bool = False,
                 prefill_scope: str = "row", obs=None):
        self.obs = obs if obs is not None else OBS_NOOP
        self._m_draft_steps = self.obs.metrics.counter(
            "spec_draft_steps_total",
            "single-token draft-model decode steps (incl. catch-up feeds)")
        cfg = _moe_local(cfg)
        self.cfg = cfg
        self.dcfg = (dataclasses.replace(cfg, moe_dispatch="token")
                     if cfg.n_experts else cfg)
        # the engine's kernel tier: a self-qdq draft runs the verify step's
        # attention and GEMM numerics, so it reaches the 1.0 ceiling
        self.fused = fused
        self.params = params
        self.device = device
        sq = dataclasses.replace(qcfg, quantize_weights=False)
        if fused and sq.packed_backend == "auto":
            sq = dataclasses.replace(sq, packed_backend="grouped")
        # "row" mirrors the target's exact prefill; the paged-prefill
        # engine passes "token", so draft KV is a function of its prefix
        if prefill_scope not in ("row", "token"):
            raise ValueError(f"unknown prefill_scope {prefill_scope!r}")
        self.prefill_scope = prefill_scope
        self.pcfg = self.dcfg if prefill_scope == "token" else self.cfg
        self.psq = dataclasses.replace(sq, act_scope=prefill_scope)
        self.dsq = dataclasses.replace(sq, act_scope="token")
        self.pool = pool                                  # geometry only
        # under tensor parallelism the target's KV heads split, and so do
        # the draft's (FP8 pages with their scales alike)
        self.data = decoder.init_paged_pool(cfg, pool.n_blocks,
                                            pool.block_size, device,
                                            n_shards=pool.n_shards)

    def _step(self, bt, lens, active, toks, st, tok_idx):
        self._m_draft_steps.inc()
        logits, _ = decoder.decode_step_paged(
            self.dcfg, self.params, self.data, bt, lens, active,
            {"tokens": toks}, self.dsq, fused=self.fused)
        return draft_sample_tokens(logits[:, 0, :], st.temps, st.topks,
                                   st.seeds, tok_idx)

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.data.values())

    # -- per-request lifecycle -------------------------------------------

    def prefill_request(self, req) -> None:
        """Whole-context draft prefill into the request's blocks.  The
        context is ``resume_tokens()``: the prompt, or the prompt and the
        confirmed output after a preemption, so the draft prefix lands
        where the target's ``n_cached`` does."""
        ctx = req.resume_tokens()
        p = len(ctx)
        toks = torch.from_numpy(ctx[None].astype(np.int64)).to(self.device)
        with self.obs.trace.annotate("spec.draft_prefill", rid=req.rid):
            _, cache = decoder.prefill(self.pcfg, self.params,
                                       {"tokens": toks}, self.psq, s_max=None)
            cache = {k: v for k, v in cache.items() if k != "pos"}
            decoder.write_prompt_to_pool(
                self.data, cache, req.block_ids[: self.pool.blocks_for(p)])
        req.draft_cached = p

    # -- the proposal round ----------------------------------------------

    def propose(self, st, k: int):
        """Draft up to ``st.k_eff[s]`` tokens a slot (k is the cap).

        ``st`` holds the round's per-slot numpy arrays: bt [ns, MB], lens
        [ns] accepted KV counts, active, k_eff, last_tok / prev_tok (the
        newest and second-newest tokens), draft_lens (``draft_cached``),
        temps, topks, seeds, tok_idx.  Returns (draft_tokens [ns, k] int64
        on the device, draft_probs [ns, k, V] f32 or None when all rows
        are greedy); rows mean something up to each slot's k_eff.
        """
        dev = self.device
        ns = st.lens.shape[0]
        lag = st.lens - st.draft_lens
        if (st.active & (lag > 1)).any():
            raise AssertionError(f"draft prefix lags > 1 position: {lag}")
        bt = torch.from_numpy(st.bt).to(dev)
        need = st.active & (lag == 1)
        if need.any():
            # catch-up: feed the second-newest token at position draft_lens
            self._step(bt, torch.from_numpy(st.draft_lens).to(dev),
                       torch.from_numpy(need).to(dev),
                       torch.from_numpy(st.prev_tok[:, None]).to(dev), st,
                       st.tok_idx)
        toks, qs = [], []
        cur = torch.from_numpy(st.last_tok).to(dev)
        for i in range(int(st.k_eff.max(initial=0))):
            act_i = st.active & (i < st.k_eff)
            tok, q = self._step(bt, torch.from_numpy(st.lens + i).to(dev),
                                torch.from_numpy(act_i).to(dev), cur[:, None],
                                st, st.tok_idx + i)
            toks.append(tok)
            qs.append(q)
            cur = tok
        return _round_out(toks, qs, ns, k, dev)

    def commit(self, adv) -> None:
        """Post-accept hook: a positional pool needs no device rollback
        (rejected positions are dead behind the prefix counter)."""


class SlabDraftProposer:
    """k-token autoregressive proposals against mirrored state slabs.

    The draft keeps its own per-slot state (its model's
    ``slot_state_specs``), addressed by the engine's slot indices.
    Recurrent state is cumulative, so the proposal loop keeps the state
    tree after the catch-up step and after every proposal (a reference:
    the slab step makes new tensors), and ``commit`` restores each slot's
    tree for its confirmed advance.  The draft decodes at row scope, as
    the stepped verify does (the plain engine's decode), so a ``self-qdq``
    draft reproduces the target exactly.
    """

    def __init__(self, cfg, params, qcfg, *, engine, s_alloc):
        cfg = _moe_local(cfg)
        self.cfg = cfg
        self.eng = engine
        self.device = engine.device
        self.obs = engine.obs
        self._m_draft_steps = self.obs.metrics.counter(
            "spec_draft_steps_total",
            "single-token draft-model decode steps (incl. catch-up feeds)")
        self.model = get_model(cfg)
        sq = dataclasses.replace(qcfg, quantize_weights=False)
        self.psq = self.dsq = dataclasses.replace(sq, act_scope="row")
        self.params = params
        self.specs = self.model.slot_state_specs(cfg, engine.n_slots, s_alloc)
        # under a mesh the rank's tiles of the draft's state
        self.data = common.zeros_from_specs(
            state_mod.slab_specs(cfg, engine.n_slots, s_alloc, engine.mesh,
                                 engine.rules), self.device)
        self._snaps: list = []

    def _step(self, lens, active, toks, st, tok_idx):
        self._m_draft_steps.inc()
        dev = self.device
        logits, self.data = self.model.decode_step_slots(
            self.cfg, self.params, self.data, {"tokens": toks},
            torch.from_numpy(lens).to(dev), torch.from_numpy(active).to(dev),
            self.dsq)
        return draft_sample_tokens(logits[:, 0, :], st.temps, st.topks,
                                   st.seeds, tok_idx)

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in common.tree_leaves(self.data))

    def prefill_request(self, req) -> None:
        """Whole-prompt draft prefill into the request's state slot."""
        with self.obs.trace.annotate("spec.draft_prefill", rid=req.rid):
            _, cache = self.model.prefill(self.cfg, self.params,
                                          self.eng.prefill_batch(req),
                                          self.psq, None)
            cache = {k: v for k, v in cache.items() if k != "pos"}
            self.data = state_mod.slab_write(self.specs, self.data, cache,
                                             req.slot)
        req.draft_cached = req.prompt_len

    def propose(self, st, k: int):
        """``DraftProposer.propose``'s contract (``st.bt`` unused); also
        arms the snapshot chain ``commit`` reads."""
        dev = self.device
        ns = st.lens.shape[0]
        lag = st.lens - st.draft_lens
        if (st.active & (lag > 1)).any():
            raise AssertionError(f"draft prefix lags > 1 position: {lag}")
        need = st.active & (lag == 1)
        if need.any():
            self._step(st.draft_lens, need,
                       torch.from_numpy(st.prev_tok[:, None]).to(dev), st,
                       st.tok_idx)
        # D_i: the draft state after i proposal tokens on top of the
        # caught-up accepted prefix; commit picks one a slot
        self._snaps = [self.data]
        toks, qs = [], []
        cur = torch.from_numpy(st.last_tok).to(dev)
        for i in range(int(st.k_eff.max(initial=0))):
            act_i = st.active & (i < st.k_eff)
            tok, q = self._step(st.lens + i, act_i, cur[:, None], st,
                                st.tok_idx + i)
            toks.append(tok)
            qs.append(q)
            cur = tok
            self._snaps.append(self.data)
        return _round_out(toks, qs, ns, k, dev)

    def commit(self, adv) -> None:
        """Restore each slot's draft state to snapshot ``adv[slot]``, the
        confirmed advance min(j + 1, k_eff) the engine computed."""
        snaps, self._snaps = self._snaps, []
        if not snaps:
            return
        sel = np.minimum(np.asarray(adv, np.int64), len(snaps) - 1)
        self.data = state_mod.slab_restore_select(self.specs, snaps, sel)
