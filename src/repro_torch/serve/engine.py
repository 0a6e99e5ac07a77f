"""The continuous-batching engine: ``submit`` / ``step`` / ``drain`` (port of
``repro.serve.engine``).

One ``step()`` = admission + prefill under a token budget, then one
batched decode over the running slots.  The config's state plan picks the
backend (``serve.state``):

  * paged KV (decoder family): ``decoder.decode_step_paged`` over
    [n_slots, 1] tokens against the block-granular KV pool, written in
    place;
  * state slabs (the ``rglru_hybrid``, ``rwkv6`` and ``encdec``
    families): the model's ``decode_step_slots`` over constant-size
    per-slot state at independent positions, returned as a new state
    tree.  An encoder-decoder request brings its encoder input in
    ``submit(..., extras={"enc_frames": ...})``.

Prefill modes:

  * "exact": the model's ``prefill`` at the request's own prompt length,
    the cache then written into the pool's blocks or the request's slab
    slot (the static ``serve_batch`` path, request by request);
  * "chunked" (paged plans): ``decoder.prefill_chunk_paged`` at a fixed
    chunk of ``prefill_chunk`` tokens, the prompt's BF16 KV kept in a
    scratch for the later chunks to attend and copied to the pool.  The
    logits are approximate: the activation amaxes cover a chunk, not the
    prompt (a prompt of exactly one chunk gets exact prefill's amaxes);
  * "paged": the context replays in block-size chunks through
    ``decoder.verify_step_paged`` at ``act_scope="token"``, writing and
    attending the pool itself, so each block's bytes are a pure function
    of its token prefix.  Prefix-cache hits and preempt-resume recompute
    need that property.

Requests are numerically independent: serving uses ``act_scope="row"``
activation scales, per-request positions and masks and, for MoE archs,
per-row expert dispatch (``moe_dispatch="local"``; "token" in paged
prefill), so a request's greedy tokens are those of a single-request
``serve_batch``.

With ``fused_kernels`` on (the default "auto" on the paged plan) the
attention of every paged forward runs the ``paged_attention`` kernel (K7)
on the card, and packed MoE expert stacks the grouped GEMM (K3); "off"
runs the gather-then-attend two-step and dequantizes the expert stacks.

Tensor parallelism: ``mesh`` is the port's counterpart of the
reference's mesh, a ``distributed.ctx.TP`` (this process's rank of a
``torch.distributed`` group; ``launch.mesh.spawn`` starts the ranks).
Every rank builds its engine on the same submissions and runs the same
scheduler; the engine cuts its tiles of the parameters at init
(``distributed.sharding.shard_params``) and its pool holds the local KV
heads.  Each forward runs under the context: K4 for the packed GEMMs,
head-local attention, a vocab-parallel embedding and all-gathered logits,
so greedy sampling (and seeded sampling) picks the same tokens on every
rank; ``drain`` checks that.  As in the reference, "auto" turns the fused
tier off under a mesh and ``fused_kernels="on"`` with one raises: the
expert stacks take dequantize-then-multiply and the attention the
gather-then-attend two-step.  MoE configs split their experts (on E, or
on each expert's FFN dim) and route on the all-gathered router logits
(``layers.moe_ffn``); an FP8 pool splits its pages and scale planes by
KV head; the shadow teacher's tiles are cut by the same rules.  The slab
families hold their tiles of the state slabs (``SlabState``): the RG-LRU
hybrids' recurrence by channel (an MQA window ring whole), RWKV's WKV
state by head, whisper's self-attention KV by head; whisper's encoder
runs under TP at admission and its ``enc_out`` stays whole.  A config
whose heads, ``d_ff`` or ``d_rnn`` do not split over the group raises
``NotImplementedError`` naming the dim (``_check_tp``).

FP8 KV (the ``moe_hybrid`` recipe): the pool (or the exact prefill's
dense cache) holds E4M3 K and V with f32 scales, and K7 reads the FP8
pages.  ``_after_prefill`` and ``_do_decode`` are the hooks the
speculative engine (``repro_torch.spec.SpecEngine``) replaces.

Telemetry (``obs``, a ``repro_torch.obs.Observability``): request
lifecycle counters and latency histograms, occupancy gauges, the prefix
cache's and preemption's counters, the dispatch counters of every step
(``obs.dispatch``: one count a call), and with a tracer the spans
``request``, ``queue``, ``prefill``, ``decode`` and the ``first_token``
instant on each request's lane, ``engine.prefill``,
``engine.decode_step``, ``cache_lookup``, ``preempt`` and ``requeue`` on
the engine's.  Every probe reads host values the engine already holds
(its clocks and counts): with telemetry on, no step waits for the card
any longer, and the token streams are bitwise those of an engine
without it.  Without ``obs`` the engine holds the shared ``NOOP`` bundle
and its do-nothing instruments.

The shadow teacher (``shadow_teacher``, the BF16 parameter tree, and
``shadow_rate`` > 0): on every ``round(1 / shadow_rate)``-th decode
step it re-scores each running request's whole context through the
teacher and the serving student, one request a call, and records the
live KL and top-1 agreement at the last position, and per layer the
student's quantization error and the teacher-student hidden divergence
(``self.numerics``, an ``obs.numerics.NumericsRecorder``).  It is
stateless: the pool, the slabs and the sampling streams are untouched.
Under a mesh each rank runs both forwards on its tiles (the teacher is
cut as the student is) and the probes reduce over the group
(``obs.numerics``), so every rank records the same values.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..core.nvfp4 import BLOCK
from ..core.qconfig import BF16
from ..distributed import ctx
from ..distributed import sharding
from ..launch import specs
from ..launch.serve import params_device, resolve_device
from ..models import common, decoder
from ..models.registry import get_model
from ..obs import NOOP as OBS_NOOP
from ..obs import dispatch as obs_dispatch
from ..obs import numerics as obs_numerics
from ..obs.trace import request_tid
from . import state as state_mod
from .sampling import SamplingParams, sample_tokens_seeded
from .scheduler import RUNNING, Request, Scheduler


class Engine:
    """Continuous-batching serving engine over the config's state backend.

    ``qcfg`` is the recipe quantization policy the weights were prepared
    with (the second return of ``launch.serve.load_quantized``); the engine
    derives the serving policy from it (no run-time weight fake-quant,
    per-row activation scales).  ``params`` must live on ``device``, which
    defaults to the card and raises without one.  For a slab plan the
    block geometry only sets ``s_alloc = max_blocks_per_slot *
    block_size``, the bound of a dense-KV slab.  ``prefill_budget`` (prompt
    tokens prefilled per step) defaults to the larger of ``s_alloc`` and
    ``prefill_chunk``.  ``obs`` turns telemetry on; ``shadow_teacher``
    (on ``device``) with ``shadow_rate`` > 0 the shadow teacher.
    """

    def __init__(self, cfg, params, qcfg=None, *, n_slots: int = 8,
                 block_size: int = 16, n_blocks: int = 48,
                 max_blocks_per_slot: int = 8, prefill_mode: str = "exact",
                 prefill_chunk: int = 8, prefill_budget: int | None = None,
                 eos_id: int | None = None, mesh=None, rules=None,
                 fused_kernels: str = "auto", prefix_cache: bool = False,
                 kv_alloc: str = "reserve", headroom: int = 2, obs=None,
                 shadow_teacher=None, shadow_rate: float = 0.0,
                 device="cuda"):
        # refuse unservable configs before touching params or the policy
        plan = state_mod.check_supported(cfg)
        self.state_plan = plan
        self.paged = plan == ("paged_kv",)
        if rules is not None and mesh is None:
            raise ValueError("rules without a mesh: pass the TP context")
        if mesh is not None and not isinstance(mesh, ctx.TP):
            raise TypeError(f"mesh must be a distributed.ctx.TP (this "
                            f"rank of a tensor-parallel group), got "
                            f"{type(mesh).__name__}")
        if prefill_mode not in ("exact", "chunked", "paged"):
            raise ValueError(prefill_mode)
        if prefill_mode in ("chunked", "paged") and not self.paged:
            raise ValueError(
                f"{prefill_mode} prefill requires the paged-KV state plan; "
                f"{cfg.name} plans {' + '.join(plan)}")
        if (prefix_cache or kv_alloc == "ondemand") \
                and prefill_mode != "paged":
            # sharing and preempt-resume replay block-granular chunks
            # through the token-causal verify forward, which makes block
            # content a pure function of its token prefix; exact prefill
            # does not have that property
            raise ValueError(
                "prefix_cache / kv_alloc='ondemand' require "
                f"prefill_mode='paged' (got {prefill_mode!r})")
        if cfg.n_experts and cfg.moe_dispatch not in ("local", "token"):
            # per-row (or per-token) dispatch makes MoE routing independent
            # of co-batched requests, which continuous batching requires
            cfg = dataclasses.replace(cfg, moe_dispatch="local")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.model = get_model(cfg)
        if params_device(params) != self.device:
            raise ValueError(f"params live on {params_device(params)}, the "
                             f"engine on {self.device}")
        self.rules = rules or sharding.make_rules()
        self.mesh = mesh
        if mesh is not None:
            _check_tp(cfg, mesh.size)
            params = self.shard(params)
            if shadow_teacher is not None and shadow_rate > 0.0:
                shadow_teacher = self.shard(shadow_teacher)
        self.params = params
        if qcfg is None:
            qcfg = specs.recipe_qconfig(cfg)
        self.sq = dataclasses.replace(qcfg, quantize_weights=False,
                                      act_scope="row")

        if fused_kernels not in ("on", "off", "auto"):
            raise ValueError(f"fused_kernels={fused_kernels!r}: "
                             "expected 'on', 'off' or 'auto'")
        if fused_kernels == "on" and not self.paged:
            raise ValueError("fused_kernels='on' requires the paged-KV "
                             f"state plan; {cfg.name} plans "
                             f"{' + '.join(plan)}")
        if fused_kernels == "on" and mesh is not None:
            raise ValueError("fused_kernels='on' is single-device only; "
                             "drop the mesh or use 'auto'")
        # "auto" leaves the fused tier off under a mesh, as the reference
        # does: TP runs the gather-then-attend two-step
        self.fused = fused_kernels == "on" or (fused_kernels == "auto"
                                               and self.paged
                                               and mesh is None)
        if self.fused and self.sq.packed_backend == "auto":
            self.sq = dataclasses.replace(self.sq, packed_backend="grouped")

        self.n_slots = n_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.s_alloc = max_blocks_per_slot * block_size
        self.prefill_mode = prefill_mode
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget or max(self.s_alloc,
                                                    prefill_chunk)
        self.eos_id = eos_id
        self.kv_alloc = kv_alloc
        self.state = state_mod.make_state(
            self, cfg, n_slots=n_slots, block_size=block_size,
            n_blocks=n_blocks, max_blocks_per_slot=max_blocks_per_slot,
            s_alloc=self.s_alloc, kv_alloc=kv_alloc, headroom=headroom,
            prefix_cache=prefix_cache)
        self.pool = getattr(self.state, "pool", None)   # paged plans only
        self.sched = Scheduler(self.state, n_slots, max_blocks_per_slot)
        self.scratch = None
        if prefill_mode == "chunked":
            shards = mesh.size if mesh is not None else 1
            self.scratch = common.zeros_from_specs(
                decoder.prefill_scratch_specs(cfg, self.s_alloc, shards),
                self.device)
        # paged prefill replays chunks through the token-scope verify
        # forward (per-position activation scales and, for MoE, per-token
        # expert capacity: sequential-decode semantics, what makes cache
        # hits and preempt-resume exact)
        self.psq = dataclasses.replace(self.sq, act_scope="token")
        self.pcfg = (dataclasses.replace(cfg, moe_dispatch="token")
                     if cfg.n_experts else cfg)

        self.step_count = 0
        self.decode_steps = 0
        self.tokens_generated = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.decode_s = 0.0
        self.prefill_s = 0.0
        # per-token decode latencies (step wall time amortized over the
        # tokens that step emitted): the p50/p95 report
        self.token_lat_s: list[float] = []
        self.decode_step_s: list[float] = []
        self.preempts = 0
        self._init_obs(obs)
        self._init_shadow(shadow_teacher, shadow_rate)

    def _init_obs(self, obs) -> None:
        """Bind the instrument handles ONCE; the hot path only calls bound
        methods.  Without a bundle every handle is the shared no-op."""
        self.obs = obs if obs is not None else OBS_NOOP
        m = self.obs.metrics
        req_events = m.counter("serve_requests_total",
                               "request lifecycle events",
                               labels=("event",))
        self._m_req_submitted = req_events.labels(event="submitted")
        self._m_req_finished = {
            r: req_events.labels(event=f"finished_{r}")
            for r in ("eos", "length")}
        toks = m.counter("serve_tokens_total", "tokens processed per phase",
                         labels=("phase",))
        self._m_tok_prefill = toks.labels(phase="prefill")
        self._m_tok_decode = toks.labels(phase="decode")
        self._m_queue_depth = m.gauge("serve_queue_depth",
                                      "requests waiting for admission")
        self._m_active_slots = m.gauge("serve_active_slots",
                                       "slots occupied at the last decode")
        self._m_state_used = m.gauge(
            "serve_state_used",
            "state backend occupancy, used allocation units "
            "(blocks for paged KV, slots for slabs)")
        self._m_state_capacity = m.gauge(
            "serve_state_capacity", "state backend capacity, same unit")
        self._m_queue_wait = m.histogram("serve_queue_wait_seconds",
                                         "submit-to-admission wait")
        self._m_ttft = m.histogram("serve_ttft_seconds",
                                   "submit-to-first-token latency")
        self._m_itl = m.histogram("serve_inter_token_seconds",
                                  "per-request gap between emitted tokens")
        self._m_prefill_step = m.histogram(
            "serve_prefill_step_seconds",
            "wall time of one step's admission + prefill work")
        self._m_decode_step = m.histogram(
            "serve_decode_step_seconds",
            "wall time of one batched decode (or draft+verify) step")
        # the prefix-cache and preemption plane (never moves with the
        # cache off or reserve allocation)
        self._m_cache_hit = m.counter("prefix_cache_hit_total",
                                      "prefix-cache block hits at admission")
        self._m_cache_miss = m.counter(
            "prefix_cache_miss_total",
            "full prompt blocks that had to be recomputed")
        self._m_cache_evict = m.counter(
            "prefix_cache_evict_total",
            "cached blocks reclaimed under pool pressure")
        self._m_preempt = m.counter(
            "serve_preempt_total",
            "running requests evicted for pool pressure")
        self._m_requeue = m.counter(
            "serve_requeue_total",
            "preempted requests placed back at the queue front")
        self._m_shared_blocks = m.gauge(
            "serve_shared_blocks",
            "pool blocks referenced by more than one request")
        self._m_cached_blocks = m.gauge(
            "serve_cached_blocks",
            "unreferenced pool blocks retained by the prefix cache")
        self._cache_seen = (0, 0)      # (hits, misses) already counted
        self._m_state_capacity.set(self.state.occupancy()[1])

    def _init_shadow(self, teacher, rate: float) -> None:
        self.shadow_teacher = teacher
        self.shadow_rate = float(rate)
        self.shadow_steps = 0
        self.shadow_s = 0.0
        self.numerics = None
        if teacher is not None and self.shadow_rate > 0.0:
            if params_device(teacher) != self.device:
                raise ValueError(f"the shadow teacher lives on "
                                 f"{params_device(teacher)}, the engine on "
                                 f"{self.device}")
            self._shadow_every = max(1, round(1.0 / self.shadow_rate))
            self.numerics = obs_numerics.NumericsRecorder(self.obs.metrics)

    def shard(self, params, cfg=None):
        """This rank's tiles of a parameter tree of ``cfg`` (the engine's
        config by default) under the engine's rules; a tree already cut
        (a tile-by-tile loader's) passes as it is."""
        cfg = cfg or self.cfg
        return sharding.shard_params(
            params, get_model(cfg).param_specs(cfg), self.mesh,
            self.rules, heads=(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               sampling: SamplingParams | None = None,
               extras: dict | None = None) -> int:
        """Queue a request; returns its id.  Admission happens in step().
        ``extras`` carries non-token prefill inputs without a batch dim
        (``enc_frames`` [enc_seq, d] for an encoder-decoder config)."""
        req = self.sched.submit(prompt, max_new_tokens, sampling,
                                step=self.step_count, extras=extras)
        req.submit_t = time.monotonic()
        req.submit_wall_t = time.time()     # the one wall-clock anchor
        self._m_req_submitted.inc()
        self._m_queue_depth.set(len(self.sched.waiting))
        tr = self.obs.trace
        if tr.enabled:
            tid = request_tid(req.rid)
            tr.thread_name(tid, f"request {req.rid}")
            tr.begin("request", tid, rid=req.rid,
                     prompt_len=req.prompt_len,
                     max_new_tokens=max_new_tokens,
                     submit_wall_t=req.submit_wall_t)
            tr.begin("queue", tid)
        return req.rid

    def step(self) -> list[Request]:
        """One scheduling round: admit and prefill queued requests under
        ``prefill_budget`` tokens, then one batched decode step for all
        running slots.  Returns the requests that finished in it.  The
        step's qeinsum and kernel dispatches count into ``obs``."""
        if self.obs.dispatch is None:
            return self._step_impl()
        with obs_dispatch.recording(self.obs.dispatch):
            return self._step_impl()

    def _step_impl(self) -> list[Request]:
        finished: list[Request] = []
        with ctx.maybe_use(self.mesh):
            self._do_prefills(finished)
            reqs = self.sched.running() if self.numerics is not None else ()
            self._do_decode(finished)
            if reqs and self.decode_steps % self._shadow_every == 0:
                self._run_shadow(reqs)
        self.step_count += 1
        return finished

    def drain(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Run ``step()`` until no request is waiting or in flight."""
        steps = 0
        while self.sched.has_work():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"drain exceeded {max_steps} steps")
            self.step()
            steps += 1
        out = self.outputs()
        if self.mesh is not None:
            self._check_ranks_agree(out)
        return out

    def _check_ranks_agree(self, out: dict[int, np.ndarray]) -> None:
        """Every rank sampled from the same gathered logits: raise unless
        all ranks hold the same outputs (a hash of them, all-gathered)."""
        h = hashlib.blake2b(digest_size=8)
        for rid in sorted(out):
            h.update(np.int64(rid).tobytes())
            h.update(out[rid].astype(np.int32).tobytes())
        mine = torch.tensor([int.from_bytes(h.digest(), "little",
                                            signed=True)], dtype=torch.int64)
        every = self.mesh.all_gather(mine.to(self.device), 0).cpu()
        if not bool((every == mine).all()):
            raise RuntimeError(f"tensor-parallel ranks disagree on their "
                               f"outputs (hashes {every.tolist()})")

    def outputs(self) -> dict[int, np.ndarray]:
        return {rid: np.asarray(r.output, np.int32)
                for rid, r in self.sched.finished.items()}

    def stats(self) -> dict:
        d = {"steps": self.step_count, "decode_steps": self.decode_steps,
             "fused_kernels": self.fused,
             "packed_backend": self.sq.packed_backend,
             "moe_dispatch": (self.cfg.moe_dispatch if self.cfg.n_experts
                              else None),
             # the speculative engine's keys, disabled: one shape for both
             # engines' stats and snapshots
             "speculative": False,
             "acceptance_rate": None,
             "accepted_per_step": None,
             "requests_finished": len(self.sched.finished),
             "preempts": self.preempts,
             "tokens_generated": self.tokens_generated,
             "prefill_tokens": self.prefill_tokens,
             "prefill_s": self.prefill_s, "decode_s": self.decode_s,
             "decode_tok_s": self.decode_tokens / max(self.decode_s, 1e-9),
             "e2e_tok_s": self.tokens_generated
             / max(self.decode_s + self.prefill_s, 1e-9)}
        d.update(self._latency_stats())
        d.update(self.state.stats())
        return d

    def _latency_stats(self) -> dict:
        """TTFT and per-token decode latency percentiles (None with no
        data: "no data" and "zero latency" are different answers)."""
        ttfts = [r.ttft_s for r in self.sched.finished.values()
                 if r.first_tok_t]
        out = {}
        for name, vals in (("ttft", ttfts), ("decode_lat", self.token_lat_s),
                           ("decode_step", self.decode_step_s)):
            out[f"{name}_p50_s"] = float(np.percentile(vals, 50)) \
                if vals else None
            out[f"{name}_p95_s"] = float(np.percentile(vals, 95)) \
                if vals else None
        return out

    # -- prefill -----------------------------------------------------------

    def _do_prefills(self, finished: list[Request]) -> None:
        budget = self.prefill_budget
        t0 = time.monotonic()
        any_work = False
        tr = self.obs.trace
        while budget > 0:
            req = self._in_flight_prefill()
            if req is None:
                req = self._admit_next()
                if req is not None:
                    self._on_admit(req)
            if req is None:
                break
            any_work = True
            resumed = bool(req.output)     # re-admitted after preemption
            with tr.annotate("engine.prefill", rid=req.rid):
                if self.prefill_mode == "exact":
                    if req.prompt_len > budget \
                            and budget < self.prefill_budget:
                        break              # defer to next step; never livelock
                    logits = self._prefill_exact(req)
                    used = req.prompt_len
                elif self.prefill_mode == "chunked":
                    logits, used = self._prefill_chunked(req, budget)
                else:
                    logits, used = self._prefill_paged(req, budget)
            budget -= used
            self.prefill_tokens += used
            self._m_tok_prefill.inc(used)
            if logits is None:
                break                      # budget ran out mid-prompt
            if self.prefill_mode == "paged":
                # make this context's full blocks shareable (also re-hits
                # this request's own blocks after a future preemption)
                self.state.register_prefix(req, req.resume_tokens())
            self._after_prefill(req)
            if tr.enabled:
                tr.end("prefill", request_tid(req.rid))
            if resumed:
                # the resume prefill only rebuilds KV over tokens already
                # emitted; its logits re-predict output[-1], which decode
                # re-feeds: emitting here would duplicate a token
                req.state = RUNNING
                if tr.enabled:
                    tr.begin("decode", request_tid(req.rid))
            else:
                self._emit(req, self._sample_one(req, logits), finished)
        dt = time.monotonic() - t0
        self.prefill_s += dt
        if any_work:
            self._m_prefill_step.observe(dt)

    def _admit_next(self) -> Request | None:
        """Admit the queue head, under a ``cache_lookup`` span when the
        prefix cache is live (admission is where the cache walk and the
        hits' acquisition happen, inside ``state.reserve``)."""
        if getattr(self.state, "cache", None) is None \
                or not self.sched.waiting:
            return self.sched.admit_next()
        head = self.sched.waiting[0]
        with self.obs.trace.annotate("cache_lookup", rid=head.rid):
            return self.sched.admit_next()

    def _count_cache_evict(self, n: int) -> None:
        """State-backend hook: ``n`` cached blocks were just reclaimed."""
        if n:
            self._m_cache_evict.inc(n)

    def _sync_cache_counters(self) -> None:
        c = getattr(self.state, "cache", None)
        if c is None:
            return
        h0, m0 = self._cache_seen
        if c.hits > h0:
            self._m_cache_hit.inc(c.hits - h0)
        if c.misses > m0:
            self._m_cache_miss.inc(c.misses - m0)
        self._cache_seen = (c.hits, c.misses)

    def _on_admit(self, req: Request) -> None:
        """A request left the queue for a slot (state reserved)."""
        self._sync_cache_counters()
        self._m_queue_depth.set(len(self.sched.waiting))
        self._m_queue_wait.observe(req.queue_wait_s)
        tr = self.obs.trace
        if tr.enabled:
            tid = request_tid(req.rid)
            tr.end("queue", tid, slot=req.slot,
                   queue_wait_s=req.queue_wait_s)
            tr.begin("prefill", tid, prompt_len=req.prompt_len)

    def _after_prefill(self, req: Request) -> None:
        """Hook: a request's context is fully prefilled (state written),
        its first token not yet sampled.  The speculative engine prefills
        the draft model's mirrored state here."""

    def _in_flight_prefill(self) -> Request | None:
        """An admitted request whose prefill hasn't completed (chunked or
        paged mode mid-prompt, or an exact-mode admission deferred by the
        budget)."""
        for r in self.sched.in_flight():
            if r.state == "prefill":
                return r
        return None

    def prefill_batch(self, req: Request) -> dict:
        """The model's prefill batch for one request: its tokens and its
        extras, each with a batch dim added."""
        batch = {"tokens": torch.from_numpy(
            req.prompt[None].astype(np.int64)).to(self.device)}
        for k, v in (req.extras or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)[None]
        return batch

    def _prefill_exact(self, req: Request) -> torch.Tensor:
        p = req.prompt_len
        with torch.inference_mode():
            logits, cache = self.model.prefill(self.cfg, self.params,
                                               self.prefill_batch(req),
                                               self.sq, None)
            cache = {k: v for k, v in cache.items() if k != "pos"}
            self.state.write_prefill(req, cache)
        req.n_prefilled = req.n_cached = req.n_written = p
        return logits[:, -1, :]

    def _prefill_chunked(self, req: Request, budget: int):
        """Advance chunked prefill by up to ``budget`` tokens, whole chunks
        of ``prefill_chunk``; returns (last-position logits [1, V] | None,
        tokens consumed).  The scratch and the pool are written in place."""
        c = self.prefill_chunk
        dev = self.device
        consumed, logits = 0, None
        bt = self.state.block_tables([req], 1)[0]
        while req.n_prefilled < req.prompt_len and consumed < budget:
            n_valid = min(c, req.prompt_len - req.n_prefilled)
            toks = np.zeros((1, c), np.int64)
            toks[0, :n_valid] = req.prompt[req.n_prefilled:
                                           req.n_prefilled + n_valid]
            with torch.inference_mode():
                lg = decoder.prefill_chunk_paged(
                    self.cfg, self.params, self.scratch, self.pool.data, bt,
                    req.n_prefilled, n_valid,
                    {"tokens": torch.from_numpy(toks).to(dev)}, self.sq)
            req.n_prefilled += n_valid
            req.n_cached = req.n_written = req.n_prefilled
            consumed += n_valid
            if req.n_prefilled >= req.prompt_len:
                logits = lg[:, -1, :]
        return logits, consumed

    def _prefill_paged(self, req: Request, budget: int):
        """Advance block-granular paged prefill by up to ``budget`` tokens.

        The context (prompt, or prompt + emitted tokens after preemption)
        replays as block-size chunks through the token-scope verify
        forward, attending and writing the pool itself; prefix-cache hit
        blocks acquired at admission are skipped.  Returns (last-position
        logits [1, V] | None, tokens consumed).
        """
        bs = self.pool.block_size
        dev = self.device
        ctx = req.resume_tokens()
        n_ctx = len(ctx)
        if req.n_prefilled == 0 and req.n_cache_hit:
            # hit blocks already hold exactly the bytes this prefill would
            # write (block content is a pure function of its token prefix)
            req.n_prefilled = req.n_cached = req.n_written = req.n_cache_hit
        consumed, logits = 0, None
        bt = self.state.block_tables([req], 1)
        active = torch.ones(1, dtype=torch.bool, device=dev)
        while req.n_prefilled < n_ctx and consumed < budget:
            n_valid = min(bs, n_ctx - req.n_prefilled)
            toks = np.zeros((1, bs), np.int64)
            toks[0, :n_valid] = ctx[req.n_prefilled:req.n_prefilled + n_valid]
            with torch.inference_mode():
                lg, _ = decoder.verify_step_paged(
                    self.pcfg, self.params, self.pool.data, bt,
                    torch.tensor([req.n_prefilled], dtype=torch.int32, device=dev),
                    active,
                    torch.tensor([n_valid - 1], dtype=torch.int32, device=dev),
                    {"tokens": torch.from_numpy(toks).to(dev)}, self.psq,
                    fused=self.fused)
            req.n_prefilled += n_valid
            req.n_cached = req.n_written = req.n_prefilled
            consumed += n_valid
            if req.n_prefilled >= n_ctx:
                logits = lg[:, n_valid - 1, :]
        return logits, consumed

    # -- preemption (on-demand paging) -------------------------------------

    def _preempt_one(self, victim: Request) -> None:
        """Evict one running request: release its state, count it, and
        re-queue it at the front (``preempt`` and ``requeue`` spans on the
        engine lane, ``queue`` re-opened on the request's)."""
        tr = self.obs.trace
        with tr.annotate("preempt", rid=victim.rid,
                         progress=len(victim.output)):
            if tr.enabled:
                tid = request_tid(victim.rid)
                tr.end("decode", tid)
                tr.begin("queue", tid)
            self.sched.preempt(victim)
        with tr.annotate("requeue", rid=victim.rid,
                         queue_depth=len(self.sched.waiting)):
            self.preempts += 1
            self._m_preempt.inc()
            self._m_requeue.inc()
            self._m_queue_depth.set(len(self.sched.waiting))

    def _ensure_decode_capacity(self, reqs: list[Request],
                                extra: int = 0) -> list[Request]:
        """On-demand mode: grow every running request's block table to
        cover its next KV write, evicting unreferenced cache blocks first
        and preempting the lowest-progress running request when the pool
        is full.  The requester can be its own victim, so one request
        always makes progress.  ``extra`` asks for room for that many more
        positions (the speculative draft depth), best effort: it never
        preempts.  Returns the requests still in the round.
        """
        if self.kv_alloc != "ondemand":
            return reqs
        live = list(reqs)
        for r in list(live):
            while r in live and not self.state.grow_to(r, r.n_cached + 1):
                victim = self.sched.preempt_victim()
                if victim is None:
                    raise RuntimeError("no preemption victim while growing")
                self._preempt_one(victim)
                if victim in live:
                    live.remove(victim)
        if extra:
            for r in live:
                self.state.grow_to(r, r.n_cached + 1 + extra)
        return live

    # -- decode ------------------------------------------------------------

    def _do_decode(self, finished: list[Request]) -> None:
        reqs = self.sched.running()
        if reqs:
            reqs = self._ensure_decode_capacity(reqs)
        if not reqs:
            return
        t0 = time.monotonic()
        ns = self.n_slots
        toks = np.zeros((ns, 1), np.int64)
        lens = np.zeros((ns,), np.int32)
        active = np.zeros((ns,), bool)
        temps = np.zeros((ns,), np.float32)
        topks = np.zeros((ns,), np.int64)
        seeds = np.zeros((ns,), np.int64)
        idxs = np.zeros((ns,), np.int64)
        for r in reqs:
            s = r.slot
            toks[s, 0] = r.next_input_token()
            lens[s] = r.n_cached
            active[s] = True
            temps[s] = r.sampling.temperature
            topks[s] = r.sampling.top_k
            seeds[s] = r.sampling.seed
            idxs[s] = len(r.output)
        with self.obs.trace.annotate("engine.decode_step",
                                     n_active=len(reqs)), \
                torch.inference_mode():
            logits = self.state.decode(reqs, toks, lens, active)
            sampled = sample_tokens_seeded(logits[:, 0, :], temps, topks,
                                           seeds, idxs).tolist()
        dt = time.monotonic() - t0
        self._note_decode_step(dt, len(reqs))
        self.decode_tokens += len(reqs)
        self._m_tok_decode.inc(len(reqs))
        self.token_lat_s.extend([dt] * len(reqs))
        for r in reqs:
            r.n_cached += 1
            r.n_written = max(r.n_written, r.n_cached)
            self._emit(r, int(sampled[r.slot]), finished)

    # -- shared ------------------------------------------------------------

    def _note_decode_step(self, dt: float, n_active: int) -> None:
        """Account one batched decode (or draft + verify) step's wall time
        and refresh the occupancy gauges; the speculative engine shares
        it."""
        self.decode_s += dt
        self.decode_step_s.append(dt)
        self.decode_steps += 1
        self._m_decode_step.observe(dt)
        if self.obs.metrics.enabled:
            self._m_active_slots.set(n_active)
            used, cap = self.state.occupancy()
            self._m_state_used.set(used)
            self._m_state_capacity.set(cap)
            if self.pool is not None:
                self._m_shared_blocks.set(self.pool.shared_blocks)
                self._m_cached_blocks.set(self.pool.cached_blocks)

    # -- the shadow teacher ------------------------------------------------

    def _live_acceptance(self):
        """Speculative acceptance so far, or None (plain engine, or no
        drafts yet).  The shadow plots it beside the live KL."""
        return None

    def _shadow_forward(self, batch, n_valid: int) -> dict:
        """Teacher (BF16) and student (the serving policy) forwards of one
        [1, bucket] context under numerics tapes: KL(teacher || student)
        and top-1 agreement at position ``n_valid - 1`` in f32, the
        per-layer hidden divergence over the valid positions, and the
        student's quantization probes."""
        t_qc = dataclasses.replace(BF16, numerics=True)
        s_qc = dataclasses.replace(self.sq, numerics=True)
        tape = obs_numerics.Tape()
        with obs_numerics.collecting(tape):
            t_logits = self.model.apply(self.cfg, self.shadow_teacher, batch,
                                        t_qc)
        h_t = tape.drain().pop("layers.hidden", None)
        tl = t_logits[0, n_valid - 1].to(torch.float32)
        del t_logits
        tape = obs_numerics.Tape()
        with obs_numerics.collecting(tape):
            s_logits = self.model.apply(self.cfg, self.params, batch, s_qc)
        s_aux = tape.drain()
        sl = s_logits[0, n_valid - 1].to(torch.float32)
        del s_logits, tape
        tlp = torch.log_softmax(tl, -1)
        slp = torch.log_softmax(sl, -1)
        out = {"shadow": {
            "kl": torch.sum(torch.exp(tlp) * (tlp - slp)),
            "top1_agree": (torch.argmax(tl) == torch.argmax(sl))
            .to(torch.float32)}}
        h_s = s_aux.pop("layers.hidden", None)
        if h_t is not None and h_s is not None:
            seq = batch["tokens"].shape[1]
            mask = (torch.arange(seq, device=self.device)[None, :]
                    < n_valid).to(torch.float32)
            out["layers.hidden"] = obs_numerics.hidden_divergence(
                h_t["h"], h_s["h"], mask)
        out.update(s_aux)
        return out

    def shadow_score(self, ctx_toks, extras=None) -> dict:
        """The shadow's record of one context (``ctx_toks``, host ints):
        ``_shadow_forward`` on it padded to its bucket, under the engine's
        tensor-parallel context (every rank gets the same record)."""
        n = len(ctx_toks)
        bucket = max(16, 1 << (n - 1).bit_length())
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = ctx_toks
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)[None]
        with torch.no_grad(), ctx.maybe_use(self.mesh):
            return self._shadow_forward(batch, n)

    def _run_shadow(self, reqs) -> None:
        """Score each request's whole context, teacher against student, one
        request a call (stateless: the pool, the slabs and the token
        streams are untouched).  Contexts pad to a power-of-two bucket of
        at least 16: a tensor-scope amax sees the padded positions, so the
        bucket is the reference's."""
        t0 = time.monotonic()
        self.shadow_steps += 1
        kls, agrees = [], []
        for r in reqs:
            aux = self.shadow_score(np.concatenate([
                np.asarray(r.prompt, np.int64),
                np.asarray(r.output, np.int64)]), r.extras)
            sh = aux.pop("shadow")
            kls.append(float(sh["kl"]))
            agrees.append(float(sh["top1_agree"]))
            self.numerics.record(aux)
            del aux
        step = self.decode_steps
        self.numerics.record({"shadow": {
            "kl": float(np.mean(kls)),
            "top1_agree": float(np.mean(agrees))}})
        self.numerics.series_point("qad_live_kl", step, float(np.mean(kls)))
        self.numerics.series_point("qad_top1_agree", step,
                                   float(np.mean(agrees)))
        self.numerics.series_point("spec_accept_rate", step,
                                   self._live_acceptance())
        self.shadow_s += time.monotonic() - t0

    def _sample_one(self, req: Request, logits: torch.Tensor) -> int:
        req.state = RUNNING
        tok = sample_tokens_seeded(
            logits, [req.sampling.temperature], [req.sampling.top_k],
            [req.sampling.seed], [len(req.output)])
        return int(tok[0])

    def _emit(self, req: Request, tok: int, finished: list[Request]) -> None:
        req.output.append(tok)
        self.tokens_generated += 1
        tr = self.obs.trace
        if not req.first_tok_t:
            req.first_tok_t = req.last_tok_t = time.monotonic()
            self._m_ttft.observe(req.ttft_s)
            if tr.enabled:
                tid = request_tid(req.rid)
                tr.instant("first_token", tid, token=tok,
                           ttft_s=req.ttft_s)
                tr.begin("decode", tid)
        elif self.obs.metrics.enabled:
            now = time.monotonic()
            self._m_itl.observe(now - req.last_tok_t)
            req.last_tok_t = now
        if self.eos_id is not None and tok == self.eos_id:
            reason = "eos"
        elif len(req.output) >= req.max_new_tokens:
            reason = "length"
        else:
            return
        self.sched.finish(req, reason, self.step_count)
        finished.append(req)
        self._m_req_finished[reason].inc()
        if tr.enabled:
            tid = request_tid(req.rid)
            tr.end("decode", tid)
            tr.end("request", tid, reason=reason, tokens=len(req.output))


def _check_tp(cfg, size: int) -> None:
    """Refuse, before any collective, a config whose dims do not split
    over the group as its family's tiles need, naming the dim: every
    family's query heads and ``d_ff`` (column-parallel, and a row site's
    input must then be feature-sharded); the decoder's KV heads (its paged
    pool splits by KV head) and an encoder-decoder's; an RG-LRU hybrid's
    KV heads unless there is one (MQA: replicated), and its ``d_rnn`` in
    whole 16-value blocks a rank (the row-parallel ``wo``); RWKV's heads.
    An MoE config's shared expert is a column site too, and under
    ``moe_shard="tp"`` its experts' FFN dim; expert stacks whose E (under
    "ep") and FFN dim both fail to divide stay whole on every rank."""
    why = ("head-local attention needs whole query and KV heads on every "
           "rank, and a row-parallel GEMM an input split over the ranks")
    if cfg.family == "rwkv6":
        dims = [("wr/wk/wv/wg (heads)", cfg.d_model // cfg.rwkv_head_dim)]
        why = ("the WKV state and its group norm are head-local, and a "
               "row-parallel GEMM needs an input split over the ranks")
    else:
        dims = [("wqkv (query heads)", cfg.n_heads)]
        if not (cfg.family == "rglru_hybrid" and cfg.n_kv_heads == 1):
            dims.append(("wqkv (KV heads)", cfg.n_kv_heads))
    if not cfg.n_experts or cfg.moe_dense_residual:
        dims.append(("the FFN (d_ff)", cfg.d_ff))
    if cfg.n_experts and cfg.shared_d_ff:
        dims.append(("sh_wg/sh_wu (shared_d_ff)", cfg.shared_d_ff))
    if cfg.n_experts and cfg.moe_shard == "tp":
        dims.append(("moe_wg/moe_wu (moe_d_ff)", cfg.moe_d_ff))
    for leaf, n in dims:
        if n % size:
            raise NotImplementedError(
                f"{cfg.name}: {leaf} = {n} does not split over {size} "
                f"ranks ({why})")
    if cfg.family == "rglru_hybrid" and cfg.d_rnn % (size * BLOCK):
        raise NotImplementedError(
            f"{cfg.name}: wx/wgate/wo (d_rnn) = {cfg.d_rnn} does not split "
            f"over {size} ranks in whole {BLOCK}-value blocks (the "
            "recurrence is channel-local, and its row-parallel wo needs "
            "whole NVFP4 blocks on every rank)")
