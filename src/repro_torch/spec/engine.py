"""The speculative serving engine: draft k, verify k + 1, accept j + 1,
roll back the rest (port of ``repro.spec.engine``).

``SpecEngine`` replaces the plain engine's one-token decode with a
draft / verify round per scheduling step:

  1. draft: the proposer drafts up to k tokens a running slot against its
     mirrored state (a slot's k is capped at its remaining budget - 1 and
     at its block reservation, ``state.draft_cap``, so no proposal writes
     outside the blocks admission reserved);
  2. verify: one ``decoder.verify_step_paged`` scores the k + 1
     positions of every slot against the target pool (causal masks within
     the chunk, per-slot offsets, per-token activation scales and, for
     MoE, per-token expert dispatch);
  3. accept: ``sampling.speculative_verify_tokens``; greedy rows emit the
     target's argmax chain, token for token the plain engine's;
  4. roll back: a slot advances by its ACCEPTED length; ``n_written``
     keeps the proposal high-water mark and rejected positions stay dead
     behind the length mask until the next round overwrites them
     (``rollback_to``, the pool's ``truncate_to``, frees whole blocks at
     finish).

A slot with one token left runs k_eff = 0, a plain decode through the
same verify call.

Slab plans (RWKV6, RG-LRU, Whisper) keep cumulative state, so their round
is k + 1 masked calls of the plain engine's ``decode_step_slots`` (each
scored position is the plain engine's decode, so greedy parity holds by
construction), keeping the state tree after each; after acceptance each
slot restores the tree of its emitted length (``SlabState.
restore_select``) and the slab proposer restores its own chain.

Telemetry (``obs``): the drafted, accepted and rolled-back token
counters by draft kind, the draft and verify histograms of each round,
the proposers' ``spec_draft_steps_total``, and the spans ``spec.draft``,
``spec.verify`` and (slab plans) ``spec.rollback`` nested in the round's
``engine.decode_step``.  The round's draft time is the host's time to
issue the draft steps (their device work runs on behind it); the verify
time runs to the accepted tokens' arrival on the host.
"""
from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from ..models import decoder
from ..serve import sampling
from ..serve.engine import Engine, _check_tp
from ..serve.scheduler import Request
from .proposer import DraftProposer, SlabDraftProposer, self_draft_model


class SpecEngine(Engine):
    """Speculative decoding over the continuous-batching engine.

    ``draft_k``: proposals a verify (it scores k + 1 positions).
    ``draft``: "self-qdq" (the target's own forward proposes: the
    acceptance ceiling), "self-truncate" (its first ``draft_layers``
    layers, default half) or "two-model" (``draft_model=(dcfg, dparams,
    dqcfg)``, a smaller model on the target's device).  Greedy outputs
    equal the plain ``Engine``'s token for token whatever the draft; the
    draft moves only the acceptance rate.  ``adaptive_k`` picks each
    slot's k from its measured acceptance and the measured draft and
    verify costs.

    Under tensor parallelism (``mesh``) the draft is cut like the target:
    a self draft slices the target's tiles, a two-model draft is cut by
    the same rules (a tree already cut passes as it is), and the draft's
    pool holds the local KV heads.  Adaptive k decides from costs every
    rank shares (the group's max of each round's measured walls), so the
    ranks draft alike.  A slab plan under a mesh raises, as the plain
    engine does.
    """

    def __init__(self, cfg, params, qcfg=None, *, draft_k: int = 4,
                 draft: str = "self-qdq", draft_layers: int = 0,
                 draft_model=None, adaptive_k: bool = False, **kw):
        super().__init__(cfg, params, qcfg, **kw)
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        self.spec_k = int(draft_k)
        self.draft_mode = draft if draft_model is None else "two-model"
        # verify numerics: per-position activation scales (and per-token
        # MoE dispatch) make each scored position a one-token decode's
        self.vsq = dataclasses.replace(self.sq, act_scope="token")
        self.vcfg = (dataclasses.replace(self.cfg, moe_dispatch="token")
                     if self.cfg.n_experts else self.cfg)
        if draft_model is not None:
            dcfg, dparams, dqcfg = draft_model
            if self.mesh is not None:
                _check_tp(dcfg, self.mesh.size)
                dparams = self.shard(dparams, dcfg)
        elif draft in ("self-qdq", "self-truncate"):
            dcfg, dparams = self_draft_model(
                self.cfg, self.params, mode=draft.removeprefix("self-"),
                n_layers=draft_layers)
            dqcfg = self.sq
        else:
            raise ValueError(f"unknown draft mode {draft!r} "
                             "(pass draft_model= for two-model)")
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target vocabularies differ")
        if self.paged:
            self.proposer = DraftProposer(
                dcfg, dparams, dqcfg, pool=self.pool, device=self.device,
                fused=self.fused, obs=self.obs,
                prefill_scope=("token" if self.prefill_mode == "paged"
                               else "row"))
        else:
            if dcfg.family != self.cfg.family:
                raise ValueError(
                    "slab-state speculative serving needs a draft of the "
                    f"target's family; got {dcfg.family!r} for "
                    f"{self.cfg.family!r}")
            self.proposer = SlabDraftProposer(dcfg, dparams, dqcfg,
                                              engine=self,
                                              s_alloc=self.s_alloc)
        self.verify_steps = 0
        self.verify_slot_rounds = 0       # one per (running slot, verify)
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rolled_back_tokens = 0
        # the draft kind is fixed at construction, so the counters by draft
        # kind are bound once; the accounting loop pays plain inc()s
        m = self.obs.metrics
        kind = {"draft": self.draft_mode}
        self._m_drafted = m.counter(
            "spec_draft_tokens_total", "draft tokens proposed",
            labels=("draft",)).labels(**kind)
        self._m_accepted = m.counter(
            "spec_accepted_tokens_total",
            "draft tokens the verify step accepted",
            labels=("draft",)).labels(**kind)
        self._m_rolled_back = m.counter(
            "spec_rolled_back_tokens_total",
            "draft tokens rejected and rolled back",
            labels=("draft",)).labels(**kind)
        self._m_draft_s = m.histogram(
            "spec_draft_seconds", "wall time of one round's draft phase")
        self._m_verify_s = m.histogram(
            "spec_verify_seconds",
            "wall time of one round's verify + accept phase")
        # draft-cost-aware adaptive k: k* = argmax over 1..draft_k of
        # (expected emitted tokens) / (k t_draft + t_verify), acceptance
        # from the slot's own history (else the engine's EWMA)
        self.adaptive_k = bool(adaptive_k)
        self.chosen_k: dict[int, int] = {}    # k -> times chosen
        self._acc_ewma: float | None = None
        self._draft_tok_s: float | None = None
        self._verify_s: float | None = None
        self._req_acc: dict[int, tuple] = {}  # rid -> (drafted, accepted)

    # -- hooks -------------------------------------------------------------

    def _after_prefill(self, req: Request) -> None:
        with torch.inference_mode():
            self.proposer.prefill_request(req)

    def _live_acceptance(self):
        """Cumulative acceptance rate, the series the shadow teacher plots
        beside its live KL (None before any draft)."""
        if not self.drafted_tokens:
            return None
        return self.accepted_tokens / self.drafted_tokens

    def _do_decode(self, finished: list[Request]) -> None:
        if self.paged:
            self._do_decode_paged(finished)
        else:
            self._do_decode_stepped(finished)

    # -- the draft / verify / accept round ---------------------------------

    def _round_state(self, reqs):
        """Per-slot round arrays shared by both verify paths."""
        ns, k = self.n_slots, self.spec_k
        st = types.SimpleNamespace(
            last_tok=np.zeros((ns,), np.int64), prev_tok=np.zeros((ns,), np.int64),
            lens=np.zeros((ns,), np.int32), active=np.zeros((ns,), bool),
            bt=np.zeros((ns, self.max_blocks_per_slot), np.int32),
            k_eff=np.zeros((ns,), np.int32),
            draft_lens=np.zeros((ns,), np.int32),
            temps=np.zeros((ns,), np.float32), topks=np.zeros((ns,), np.int64),
            seeds=np.zeros((ns,), np.int64), tok_idx=np.zeros((ns,), np.int64))
        for r in reqs:
            s = r.slot
            st.last_tok[s] = r.output[-1]
            st.prev_tok[s] = r.output[-2] if len(r.output) > 1 else r.prompt[-1]
            st.lens[s] = r.n_cached
            st.active[s] = True
            st.bt[s, : len(r.block_ids)] = r.block_ids
            st.draft_lens[s] = r.draft_cached
            remaining = r.max_new_tokens - len(r.output)
            k_want = self._choose_k(r) if self.adaptive_k else k
            st.k_eff[s] = max(0, min(k_want, remaining - 1,
                                     self.state.draft_cap(r)))
            if self.adaptive_k:
                ke = int(st.k_eff[s])
                self.chosen_k[ke] = self.chosen_k.get(ke, 0) + 1
            st.temps[s] = r.sampling.temperature
            st.topks[s] = r.sampling.top_k
            st.seeds[s] = r.sampling.seed
            st.tok_idx[s] = len(r.output)
        return st

    def _accept(self, logits, draft_toks, draft_probs, st):
        out, n_emit, n_acc = sampling.speculative_verify_tokens(
            logits, draft_toks, draft_probs, st.k_eff, st.temps, st.topks,
            st.seeds, st.tok_idx)
        return out.cpu().numpy(), n_emit.cpu().numpy(), n_acc.cpu().numpy()

    def _account_round(self, reqs, out_toks, n_emit, n_acc, k_eff, dt,
                       finished):
        """Advance each request by its ACCEPTED tokens; returns per-slot
        (emitted count, confirmed draft advance) for the slab restores."""
        sel = np.zeros((self.n_slots,), np.int64)
        adv = np.zeros((self.n_slots,), np.int64)
        for r in reqs:
            s = r.slot
            ne, j, ke = int(n_emit[s]), int(n_acc[s]), int(k_eff[s])
            self.drafted_tokens += ke
            self.accepted_tokens += j
            self.rolled_back_tokens += ke - j
            self._m_drafted.inc(ke)
            self._m_accepted.inc(j)
            self._m_rolled_back.inc(ke - j)
            if ke:
                d0, a0 = self._req_acc.get(r.rid, (0, 0))
                self._req_acc[r.rid] = (d0 + ke, a0 + j)
                rate = j / ke
                self._acc_ewma = (rate if self._acc_ewma is None
                                  else 0.7 * self._acc_ewma + 0.3 * rate)
            toks_emit = [int(out_toks[s, t]) for t in range(ne)]
            if self.eos_id is not None and self.eos_id in toks_emit:
                # EOS mid-pack: the accepted tail after EOS is dropped
                toks_emit = toks_emit[: toks_emit.index(self.eos_id) + 1]
            base = r.n_cached
            r.n_cached = base + len(toks_emit)        # accepted length only
            r.n_written = max(r.n_written, base + ke + 1)
            r.draft_cached = base + min(j + 1, ke)
            sel[s] = len(toks_emit)
            adv[s] = min(j + 1, ke)
            self.decode_tokens += len(toks_emit)
            self._m_tok_decode.inc(len(toks_emit))
            # a request that got n tokens this step waited dt / n a token
            self.token_lat_s.extend([dt / len(toks_emit)] * len(toks_emit))
            for tok in toks_emit:
                self._emit(r, tok, finished)
            if r.done:
                self._req_acc.pop(r.rid, None)
        return sel, adv

    def _finish_round(self, t0, t_draft, st, n_active):
        dt = time.monotonic() - t0
        t_d, t_v = t_draft, dt - t_draft
        if self.adaptive_k and self.mesh is not None:
            # each rank's walls differ: k is chosen from the group's max,
            # which every rank holds, or the ranks would draft apart
            t_d, t_v = self.mesh.all_reduce(torch.tensor(
                [t_d, t_v], dtype=torch.float64), "max").tolist()
        self._observe_costs(t_d, t_v, int(st.k_eff.max(initial=0)))
        self._note_decode_step(dt, n_active)
        self._m_draft_s.observe(t_draft)
        self._m_verify_s.observe(dt - t_draft)
        self.verify_steps += 1
        self.verify_slot_rounds += n_active
        return dt

    def _do_decode_paged(self, finished: list[Request]) -> None:
        reqs = self.sched.running()
        if reqs:
            # on-demand paging: the verify write at n_cached must fit; the
            # draft depth beyond it is best-effort room (draft_cap reads
            # the grown table)
            reqs = self._ensure_decode_capacity(reqs, extra=self.spec_k)
        if not reqs:
            return
        t0 = time.monotonic()
        dev = self.device
        tr = self.obs.trace
        n = len(reqs)
        # the round is this engine's decode step: the engine-lane span is
        # the plain engine's, the spec.* spans nest in it
        with tr.span("engine.decode_step", n_active=n):
            with torch.inference_mode():
                st = self._round_state(reqs)
                with tr.annotate("spec.draft", n_active=n, k=self.spec_k):
                    draft_toks, draft_probs = self.proposer.propose(
                        st, self.spec_k)
                t_draft = time.monotonic() - t0
                with tr.annotate("spec.verify", n_active=n):
                    tokens = torch.cat([torch.from_numpy(st.last_tok)
                                        .to(dev)[:, None], draft_toks], 1)
                    logits, _ = decoder.verify_step_paged(
                        self.vcfg, self.params, self.pool.data,
                        torch.from_numpy(st.bt).to(dev),
                        torch.from_numpy(st.lens).to(dev),
                        torch.from_numpy(st.active).to(dev),
                        torch.from_numpy(st.k_eff).to(dev),
                        {"tokens": tokens}, self.vsq, fused=self.fused)
                    out_toks, n_emit, n_acc = self._accept(
                        logits, draft_toks, draft_probs, st)
            dt = self._finish_round(t0, t_draft, st, n)
            self._account_round(reqs, out_toks, n_emit, n_acc, st.k_eff, dt,
                                finished)

    def _do_decode_stepped(self, finished: list[Request]) -> None:
        """Slab round: k + 1 masked calls of the plain engine's decode,
        the state tree kept after each; each slot then restores the tree
        of its emitted length (bitwise: the state after its emitted tokens,
        as if it had never drafted) and the proposer its confirmed
        prefix."""
        reqs = self.sched.running()
        if not reqs:
            return
        t0 = time.monotonic()
        k = self.spec_k
        tr = self.obs.trace
        n = len(reqs)
        with tr.span("engine.decode_step", n_active=n):
            with torch.inference_mode():
                st = self._round_state(reqs)
                with tr.annotate("spec.draft", n_active=n, k=k):
                    draft_toks, draft_probs = self.proposer.propose(st, k)
                t_draft = time.monotonic() - t0
                with tr.annotate("spec.verify", n_active=n):
                    tokens = np.concatenate([st.last_tok[:, None],
                                             draft_toks.cpu().numpy()], 1)
                    snaps = [self.state.snapshot()]
                    logits = []
                    for i in range(k + 1):
                        act_i = st.active & (i <= st.k_eff)
                        logits.append(self.state.decode(
                            reqs, tokens[:, i:i + 1], st.lens + i,
                            act_i)[:, 0])
                        snaps.append(self.state.snapshot())
                    out_toks, n_emit, n_acc = self._accept(
                        torch.stack(logits, 1), draft_toks, draft_probs, st)
            dt = self._finish_round(t0, t_draft, st, n)
            sel, adv = self._account_round(reqs, out_toks, n_emit, n_acc,
                                           st.k_eff, dt, finished)
            # lossless rollback: each slot's state becomes the state after
            # its emitted tokens, bitwise, as if it had never drafted
            with tr.span("spec.rollback", n_active=n):
                self.state.restore_select(snaps, sel)
                self.proposer.commit(adv)

    # -- draft-cost-aware adaptive k -----------------------------------------

    def _observe_costs(self, draft_s: float, verify_s: float,
                       n_draft_steps: int) -> None:
        """EWMA of the measured per-token draft cost and per-step verify
        cost."""
        if n_draft_steps > 0:
            per_tok = draft_s / n_draft_steps
            self._draft_tok_s = (per_tok if self._draft_tok_s is None
                                 else 0.7 * self._draft_tok_s + 0.3 * per_tok)
        self._verify_s = (verify_s if self._verify_s is None
                          else 0.7 * self._verify_s + 0.3 * verify_s)

    def _acceptance_for(self, req: Request) -> float:
        """A slot's per-token acceptance estimate: its own history once it
        has 4 drafted tokens, else the engine's EWMA, else 1.0."""
        d, a = self._req_acc.get(req.rid, (0, 0))
        if d >= 4:
            return a / d
        if self._acc_ewma is not None:
            return self._acc_ewma
        return 1.0

    def _choose_k(self, req: Request) -> int:
        """k* = argmax_k E[emitted | k] / (k t_draft + t_verify): with
        per-token acceptance a, a k-token draft expects a (1 - a^k) /
        (1 - a) accepted tokens plus the always-emitted one.  The static
        ``spec_k`` until both costs are measured."""
        if self._draft_tok_s is None or self._verify_s is None:
            return self.spec_k
        a = min(max(self._acceptance_for(req), 0.0), 0.999)
        best_k, best_rate = 1, -1.0
        for k in range(1, self.spec_k + 1):
            e_acc = a * (1.0 - a ** k) / (1.0 - a)
            rate = (e_acc + 1.0) / (k * self._draft_tok_s + self._verify_s)
            if rate > best_rate:
                best_rate, best_k = rate, k
        return best_k

    # -- reporting -------------------------------------------------------------

    def stats(self) -> dict:
        d = super().stats()
        d.update({
            "speculative": True,
            "spec_k": self.spec_k, "draft_mode": self.draft_mode,
            "verify_steps": self.verify_steps,
            "verify_slot_rounds": self.verify_slot_rounds,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "rolled_back_tokens": self.rolled_back_tokens,
            # None before any round: "no data" is not "nothing accepted"
            "acceptance_rate": (self.accepted_tokens / self.drafted_tokens
                                if self.drafted_tokens else None),
            # tokens a slot emits per round (accepted + the one always
            # emitted): 1.0 no gain, k + 1 every proposal accepted
            "accepted_per_step": ((self.accepted_tokens
                                   + self.verify_slot_rounds)
                                  / self.verify_slot_rounds
                                  if self.verify_slot_rounds else None),
            "draft_pool_bytes": self.proposer.nbytes(),
            "adaptive_k": self.adaptive_k,
            "chosen_k_hist": dict(sorted(self.chosen_k.items())),
        })
        return d
