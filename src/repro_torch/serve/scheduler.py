"""Request lifecycle + slot scheduling for the continuous-batching engine
(port of ``repro.serve.scheduler``).

Requests move WAITING -> PREFILL -> RUNNING -> FINISHED.  The scheduler owns
a fixed set of decode slots (the batch rows of the decode step) and the
admission policy, and it allocates/retires *protocol state*
(``serve.state``) rather than raw KV blocks:

  * FIFO, head-of-line: requests are admitted in arrival order; the queue
    head waits until a slot AND the state backend's reservation are both
    available (no small-request bypass, so admission order is predictable
    and starvation-free).
  * Capacity is the backend's business.  Paged KV reserves a worst-case
    block count (ceil((P + max_new - 1) / block_size)) up front so decode
    never exhausts the pool mid-flight.  Slab state (recurrent / window /
    encoder slots) is constant-size per slot — a free slot IS the whole
    reservation, so recurrent requests are never refused for phantom block
    pressure no matter their generation budget; only a finite dense
    self-KV component bounds prompt + generation by the slab allocation.

Retiring a request (EOS, token budget) frees its slot and state the same
step, so the next queued request backfills on the following ``step()``.

Speculative decoding (the reference's ``repro.spec``, a later slice of the
port) accounts state by ACCEPTED length: ``n_cached`` only ever advances
by accepted tokens, ``n_written`` tracks the proposal high-water mark, and
``rollback_to`` releases whatever a rejected proposal tail no longer
justifies (whole dead blocks for paged KV; nothing for slabs, where
device-state rollback is the spec engine's snapshot/restore).  Because the engine caps per-slot draft length at the
backend's ``draft_cap``, proposals never write past the reservation —
admission capacity math is unchanged and decode still never preempts.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

import numpy as np

from .sampling import SamplingParams

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", "finished"


@dataclasses.dataclass
class Request:
    """One generation request and its runtime bookkeeping."""

    rid: int
    prompt: np.ndarray                    # [P] int32
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    extras: Optional[dict] = None         # non-token prefill inputs, e.g.
    #                                       {"enc_frames": [T, n_mels]} for
    #                                       encoder-decoder archs

    state: str = WAITING
    slot: Optional[int] = None
    block_ids: list = dataclasses.field(default_factory=list)
    n_prefilled: int = 0                  # prompt tokens processed so far
    n_cached: int = 0                     # ACCEPTED state positions
    n_written: int = 0                    # write high-water mark (speculative
    #                                       proposals may exceed n_cached;
    #                                       the gap is rolled-back state)
    draft_cached: int = 0                 # draft-model state prefix in sync
    #                                       with the accepted sequence (spec)
    n_cache_hit: int = 0                  # prefix-cache tokens already in the
    #                                       pool when this prefill started
    n_preempts: int = 0                   # times this request was preempted
    output: list = dataclasses.field(default_factory=list)
    finish_reason: str = ""
    submit_step: int = -1
    finish_step: int = -1
    # --- latency telemetry ---
    # monotonic-clock seconds (time.monotonic): differences survive
    # wall-clock adjustments, so TTFT / queue-wait / inter-token stats are
    # always well-defined.  0.0 means "not stamped yet".
    submit_t: float = 0.0
    admit_t: float = 0.0                  # scheduler-stamped at admission
    first_tok_t: float = 0.0              # 0 until the first token emits
    last_tok_t: float = 0.0               # newest emission (inter-token lat)
    finish_t: float = 0.0
    # ONE wall-clock anchor per request (time.time at submit), kept solely
    # so trace export / logs can place the request in absolute time
    submit_wall_t: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def max_cached(self) -> int:
        # the last generated token is returned but its KV is never attended
        return self.prompt_len + self.max_new_tokens - 1

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    @property
    def ttft_s(self) -> float:
        """Submit-to-first-token latency (0.0 until the first emission)."""
        return max(self.first_tok_t - self.submit_t, 0.0) \
            if self.first_tok_t else 0.0

    @property
    def queue_wait_s(self) -> float:
        """Submit-to-admission wait (0.0 until admitted)."""
        return max(self.admit_t - self.submit_t, 0.0) \
            if self.admit_t else 0.0

    def next_input_token(self) -> int:
        """The token the next decode step feeds for this request."""
        return int(self.output[-1])

    def resume_tokens(self) -> np.ndarray:
        """The token context a (re-)prefill must cover: the prompt, plus —
        after preemption — every emitted token except the last (whose KV is
        never cached yet; decode re-feeds it).  Token-causal paged prefill
        over this context reproduces the evicted pool state bit for bit.
        """
        if not self.output:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output[:-1], np.int32)])


class Scheduler:
    """Slot + state-protocol admission.  ``state`` is a backend from
    ``serve.state`` (PagedKVState)."""

    def __init__(self, state, n_slots: int,
                 max_blocks_per_slot: int | None = None):
        self.state = state
        self.pool = getattr(state, "pool", None)   # paged back-compat view
        self.n_slots = n_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.waiting: deque[Request] = deque()
        self.finished: dict[int, Request] = {}
        self._rid = itertools.count()

    # -- submission --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               sampling: SamplingParams | None = None, step: int = -1,
               extras: dict | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(rid=next(self._rid), prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingParams(),
                      extras=extras, submit_step=step)
        # reject-at-submit anything the backend could never admit
        self.state.admission_check(req)
        self.waiting.append(req)
        return req

    # -- admission ---------------------------------------------------------

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def admit_next(self) -> Optional[Request]:
        """Admit the queue head if a slot + its state reservation fit.

        Returns the admitted request (state PREFILL, backend state
        reserved) or None — either the queue is empty or capacity refuses
        admission.
        """
        if not self.waiting:
            return None
        slot = self.free_slot()
        if slot is None:
            return None
        req = self.waiting[0]
        if not self.state.can_reserve(req):
            return None
        self.waiting.popleft()
        req.slot = slot
        self.state.reserve(req)
        req.state = PREFILL
        req.admit_t = time.monotonic()
        self.slots[slot] = req
        return req

    # -- retirement --------------------------------------------------------

    def rollback_to(self, req: Request, n_tokens: int) -> int:
        """Clamp a request's state reservation to ``n_tokens``.

        Paged KV: whole blocks past ``blocks_for(n_tokens)`` return to the
        pool (the speculative accounting is by ACCEPTED length; while a
        request is still generating its worst-case reservation covers every
        position speculation can touch, so mid-flight rollback frees
        nothing — the release happens at EOS / early finish).  Slab state:
        nothing positional to release; only the host high-water mark is
        clamped.  Returns the number of blocks freed (0 for slabs).
        """
        return self.state.rollback_to(req, n_tokens)

    def finish(self, req: Request, reason: str, step: int = -1) -> None:
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_step = step
        req.finish_t = time.monotonic()
        self.state.release(req)
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        self.finished[req.rid] = req

    # -- preemption --------------------------------------------------------

    def preempt(self, req: Request) -> None:
        """Evict a RUNNING request from its slot and re-queue it at the
        queue FRONT (it already waited its turn once).

        Its state references are released (shared prefix blocks survive
        for their other holders — and usually park in the prefix cache, so
        swap-in is cheap), its cache counters reset, and its OUTPUT is
        kept: on re-admission the paged prefill recomputes KV over
        ``resume_tokens()`` bit for bit and decode continues exactly where
        it stopped, so preemption is invisible in the token stream.
        """
        if req.state != RUNNING:
            raise ValueError(f"preempt of request {req.rid} in state "
                             f"{req.state}")
        self.state.release(req)
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        req.n_prefilled = req.n_cached = req.n_written = 0
        req.draft_cached = 0
        req.n_cache_hit = 0
        req.n_preempts += 1
        req.state = WAITING
        self.waiting.appendleft(req)

    def preempt_victim(self, exclude=()) -> Optional[Request]:
        """Lowest-progress RUNNING request (fewest emitted tokens — the
        cheapest recompute), excluding ``exclude``.  Ties break toward the
        higher slot so victim choice is deterministic."""
        cand = [r for r in self.running() if r not in exclude]
        if not cand:
            return None
        return min(cand, key=lambda r: (len(r.output), -r.slot))

    # -- views -------------------------------------------------------------

    def running(self) -> list[Request]:
        return [r for r in self.slots if r is not None and r.state == RUNNING]

    def in_flight(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)
