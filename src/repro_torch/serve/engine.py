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
tier off under a mesh and ``fused_kernels="on"`` with one raises.  MoE,
FP8-KV and slab-state configs under TP raise ``NotImplementedError``.

FP8 KV (the ``moe_hybrid`` recipe) serves on one device: the pool (or the
exact prefill's dense cache) holds E4M3 K and V with f32 scales, and K7
reads the FP8 pages.  ``_after_prefill`` and ``_do_decode`` are the hooks
the speculative engine (``repro_torch.spec.SpecEngine``) replaces.

Not ported yet, and refused with ``NotImplementedError``: ``obs`` and
``shadow_teacher`` (observability slice).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..distributed import ctx
from ..distributed import sharding
from ..launch import specs
from ..launch.serve import params_device, resolve_device
from ..models import common, decoder
from ..models.registry import get_model
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
    ``prefill_chunk``.
    """

    def __init__(self, cfg, params, qcfg=None, *, n_slots: int = 8,
                 block_size: int = 16, n_blocks: int = 48,
                 max_blocks_per_slot: int = 8, prefill_mode: str = "exact",
                 prefill_chunk: int = 8, prefill_budget: int | None = None,
                 eos_id: int | None = None, mesh=None, rules=None,
                 fused_kernels: str = "auto", prefix_cache: bool = False,
                 kv_alloc: str = "reserve", headroom: int = 2, obs=None,
                 shadow_teacher=None, device="cuda"):
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
        if obs is not None or shadow_teacher is not None:
            raise NotImplementedError("serving telemetry and the shadow "
                                      "teacher are part of the "
                                      "observability slice of the port")
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
        if mesh is not None:
            _check_tp(cfg, mesh.size)
            params = sharding.shard_params(
                params, self.model.param_specs(cfg), mesh, self.rules,
                heads=(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))
        self.mesh = mesh
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
        return req.rid

    def step(self) -> list[Request]:
        """One scheduling round: admit and prefill queued requests under
        ``prefill_budget`` tokens, then one batched decode step for all
        running slots.  Returns the requests that finished in it."""
        finished: list[Request] = []
        with ctx.maybe_use(self.mesh):
            self._do_prefills(finished)
            self._do_decode(finished)
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
        while budget > 0:
            req = self._in_flight_prefill()
            if req is None:
                req = self.sched.admit_next()
            if req is None:
                break
            resumed = bool(req.output)     # re-admitted after preemption
            if self.prefill_mode == "exact":
                if req.prompt_len > budget and budget < self.prefill_budget:
                    break                  # defer to next step; never livelock
                logits = self._prefill_exact(req)
                used = req.prompt_len
            elif self.prefill_mode == "chunked":
                logits, used = self._prefill_chunked(req, budget)
            else:
                logits, used = self._prefill_paged(req, budget)
            budget -= used
            self.prefill_tokens += used
            if logits is None:
                break                      # budget ran out mid-prompt
            if self.prefill_mode == "paged":
                # make this context's full blocks shareable (also re-hits
                # this request's own blocks after a future preemption)
                self.state.register_prefix(req, req.resume_tokens())
            self._after_prefill(req)
            if resumed:
                # the resume prefill only rebuilds KV over tokens already
                # emitted; its logits re-predict output[-1], which decode
                # re-feeds: emitting here would duplicate a token
                req.state = RUNNING
            else:
                self._emit(req, self._sample_one(req, logits), finished)
        self.prefill_s += time.monotonic() - t0

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
        re-queue it at the front."""
        self.sched.preempt(victim)
        self.preempts += 1

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
        with torch.inference_mode():
            logits = self.state.decode(reqs, toks, lens, active)
            sampled = sample_tokens_seeded(logits[:, 0, :], temps, topks,
                                           seeds, idxs).tolist()
        dt = time.monotonic() - t0
        self._note_decode_step(dt)
        self.decode_tokens += len(reqs)
        self.token_lat_s.extend([dt] * len(reqs))
        for r in reqs:
            r.n_cached += 1
            r.n_written = max(r.n_written, r.n_cached)
            self._emit(r, int(sampled[r.slot]), finished)

    # -- shared ------------------------------------------------------------

    def _note_decode_step(self, dt: float) -> None:
        """Account one batched decode (or draft + verify) step's wall
        time; the speculative engine shares it."""
        self.decode_s += dt
        self.decode_step_s.append(dt)
        self.decode_steps += 1

    def _sample_one(self, req: Request, logits: torch.Tensor) -> int:
        req.state = RUNNING
        tok = sample_tokens_seeded(
            logits, [req.sampling.temperature], [req.sampling.top_k],
            [req.sampling.seed], [len(req.output)])
        return int(tok[0])

    def _emit(self, req: Request, tok: int, finished: list[Request]) -> None:
        req.output.append(tok)
        self.tokens_generated += 1
        if not req.first_tok_t:
            req.first_tok_t = req.last_tok_t = time.monotonic()
        if self.eos_id is not None and tok == self.eos_id:
            reason = "eos"
        elif len(req.output) >= req.max_new_tokens:
            reason = "length"
        else:
            return
        self.sched.finish(req, reason, self.step_count)
        finished.append(req)


def _check_tp(cfg, size: int) -> None:
    """Refuse what this slice does not serve under tensor parallelism, and
    configs whose column-parallel dims do not divide the group (a row
    site's input must then be feature-sharded)."""
    if cfg.family != "decoder":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                  "under tensor parallelism is part of a "
                                  "later slice of the port")
    if decoder._kv_fp8(cfg):
        raise NotImplementedError(f"{cfg.name}: FP8 KV under tensor "
                                  "parallelism is part of a later slice of "
                                  "the port (what tensor parallelism left)")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE under tensor "
                                  "parallelism is part of a later slice of "
                                  "the port")
    for leaf, n in (("wqkv (query heads)", cfg.n_heads),
                    ("wqkv (KV heads)", cfg.n_kv_heads),
                    ("wg/wu (d_ff)", cfg.d_ff)):
        if n % size:
            raise NotImplementedError(
                f"{cfg.name}: {leaf} = {n} does not split over {size} "
                "ranks (head-local attention needs whole query and KV heads "
                "on every rank, and a row-parallel GEMM an input split "
                "over the ranks)")
