"""Per-layer serve-state protocol (port of ``repro.serve.state``): one
engine over the cache architectures a config's state plan
(``models.registry.serve_state_plan``) names.

  * ``PagedKVState``: plan ("paged_kv",), the block-granular KV pool:
    block-table decode, capacity-based admission in blocks, on-demand
    growth, copy-on-write, rollback by page truncation.  Its device state
    lives in the pool's tensors and is written in place.
  * ``SlabState``: every other supported plan, per-slot constant-size
    state slabs (recurrent state with a window ring or a dense KV, the
    encoder-decoder's dense self-KV and encoder output).  The slot index
    is the state address; decode is the model's batched
    ``decode_step_slots``.  The state tree is never written in place:
    every write makes new tensors, so a tree the backend handed out
    (``snapshot``) stays as it was, and ``restore_select`` is an exact
    gather from such trees.  Under tensor parallelism each rank holds
    its tile of every slab leaf (``distributed.sharding.local_specs``):
    split on "rnn" (the RG-LRU conv and ``h``), "heads" (RWKV's ``S``) or
    "kv" (a dense KV), whole otherwise (an MQA ring, the token-shift
    carries, ``enc_out``).

The backend answers the contract the engine and scheduler program
against: admission_check / can_reserve / reserve / release, write_prefill,
decode, rollback_to, stats / leaked.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import sharding
from ..models import common, decoder
from ..models.registry import get_model, serve_capabilities
from .paged_kv import PagedKVPool, PoolExhausted, PrefixCache


class UnsupportedStateError(ValueError):
    """A config's state plan needs a kind this engine doesn't implement."""


def check_supported(cfg) -> tuple:
    """Return the config's state plan or raise a one-line capability error."""
    caps = serve_capabilities(cfg)
    if not caps["supported"]:
        raise UnsupportedStateError(
            f"{cfg.name}: engine cannot serve state kind(s) "
            f"{', '.join(caps['missing'])} "
            f"(plan: {' + '.join(caps['plan'])})")
    return caps["plan"]


def make_state(engine, cfg, *, n_slots, block_size, n_blocks,
               max_blocks_per_slot, s_alloc, kv_alloc="reserve", headroom=2,
               prefix_cache=False):
    """The state backend for ``cfg``'s plan (or a capability error).
    ``engine`` supplies the parameters, the serving policy and the device;
    ``s_alloc`` bounds a slab plan's dense KV."""
    plan = check_supported(cfg)
    if plan == ("paged_kv",):
        return PagedKVState(engine, cfg, n_blocks=n_blocks,
                            block_size=block_size,
                            max_blocks_per_slot=max_blocks_per_slot,
                            kv_alloc=kv_alloc, headroom=headroom,
                            prefix_cache=prefix_cache)
    if kv_alloc != "reserve" or prefix_cache:
        raise UnsupportedStateError(
            f"{cfg.name}: on-demand paging / prefix caching needs the "
            f"paged_kv state plan (plan: {' + '.join(plan)})")
    return SlabState(engine, cfg, n_slots=n_slots, s_alloc=s_alloc, plan=plan)


# ---------------------------------------------------------------------------
# slab machinery (reference lines 87-130)
# ---------------------------------------------------------------------------


def slab_write(specs, data, cache, slot: int):
    """A batch-1 prefill cache written into slot ``slot`` of every slab
    leaf: each cache leaf right-padded with zeros up to the slab's size on
    every non-batch axis (a P-token prompt's KV into an S_alloc slab, the
    padding ``prefill(s_max=...)`` would apply), then placed at ``slot``
    along the spec's "batch" axis.  Returns a new tree: ``data`` is not
    written."""
    def one(spec, d, c):
        ax = spec.axes.index("batch")
        pads = []
        for i in reversed(range(d.ndim)):          # F.pad: last axis first
            pads += [0, 0 if i == ax else d.shape[i] - c.shape[i]]
        if any(pads):
            c = torch.nn.functional.pad(c, pads)
        out = d.clone()
        out.narrow(ax, slot, 1).copy_(c.to(d.dtype))
        return out
    return common.tree_map(one, specs, data, cache)


def slab_restore_select(specs, snaps: list, sel):
    """Per-slot restore from a chain of state trees: slot ``s`` takes its
    slab rows from ``snaps[sel[s]]``.  An exact gather (no arithmetic), so
    a restored slot is bit for bit the state its snapshot held."""
    sel = torch.as_tensor(np.asarray(sel), dtype=torch.long)

    def one(spec, *leaves):
        ax = spec.axes.index("batch")
        st = torch.stack(leaves)                   # [K, ...leaf]
        m = torch.movedim(st, ax + 1, 1)           # [K, n_slots, ...]
        rows = torch.arange(m.shape[1], device=m.device)
        out = m[sel.to(m.device), rows]            # [n_slots, ...]
        return torch.movedim(out, 0, ax)
    return common.tree_map(one, specs, *snaps)


def slab_specs(cfg, n_slots: int, s_alloc: int, mesh=None, rules=None):
    """The slot-state specs one device allocates: the model's whole
    ``slot_state_specs``, or with ``mesh`` (a ``distributed.ctx.TP``) each
    leaf at its tile on this rank under ``rules``."""
    specs = get_model(cfg).slot_state_specs(cfg, n_slots, s_alloc)
    if mesh is None:
        return specs
    return sharding.local_specs(specs, mesh.size,
                                rules or sharding.make_rules())


def slab_bytes_per_slot(specs, n_slots: int) -> int:
    """Constant per-request state footprint of a slab spec tree."""
    return common.spec_bytes(specs) // max(n_slots, 1)


def _tree_nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in common.tree_leaves(tree))


class PagedKVState:
    """Protocol adapter over the block-granular ``PagedKVPool``.

    Admission reasons in blocks (a worst-case reservation up front, or
    on-demand growth with preemption), decode runs
    ``decoder.decode_step_paged`` with per-slot block tables and writes
    the pool in place, and speculative rollback is positional: rejected
    KV stays dead behind the length mask, ``truncate_to`` releasing whole
    dead blocks.
    """

    def __init__(self, engine, cfg, *, n_blocks, block_size,
                 max_blocks_per_slot, kv_alloc="reserve", headroom=2,
                 prefix_cache=False):
        self.eng = engine
        self.cfg = cfg
        self.kinds = ("paged_kv",)
        self.max_blocks_per_slot = max_blocks_per_slot
        if kv_alloc not in ("reserve", "ondemand"):
            raise ValueError(f"unknown kv_alloc mode {kv_alloc!r}")
        self.kv_alloc = kv_alloc
        self.headroom = int(headroom)
        shards = engine.mesh.size if engine.mesh is not None else 1
        self.pool = PagedKVPool(
            decoder.init_paged_pool(cfg, n_blocks, block_size, engine.device,
                                    n_shards=shards),
            block_size, n_shards=shards)
        self.cache = (PrefixCache(self.pool, f"{cfg.name}|{engine.sq!r}")
                      if prefix_cache else None)

    # -- capacity ----------------------------------------------------------

    def admission_check(self, req) -> None:
        need = self.pool.blocks_for(req.max_cached)
        if need > self.max_blocks_per_slot or need > self.pool.n_blocks:
            raise ValueError(
                f"request needs {need} blocks > "
                f"max_blocks_per_slot={self.max_blocks_per_slot} or "
                f"pool capacity={self.pool.n_blocks} "
                f"(prompt {req.prompt_len} + gen {req.max_new_tokens}); "
                "it could never be admitted")

    def _hit_blocks(self, ctx) -> int:
        return self.cache.lookup(ctx) if self.cache is not None else 0

    def _admit_capacity(self, ctx) -> tuple[int, int]:
        """(cache hits for ``ctx``, blocks deliverable AFTER taking them).

        Acquiring a hit revives a CACHED block: it stops being evictable
        but consumes no free block.  Counting every hit as if it were
        cached keeps this estimate <= what ``reserve`` can deliver."""
        hits = self._hit_blocks(ctx)
        ev = self.cache.evictable if self.cache is not None else 0
        return hits, self.pool.free_blocks + max(ev - hits, 0)

    def can_reserve(self, req) -> bool:
        if self.kv_alloc == "reserve":
            need = self.pool.blocks_for(req.max_cached)
            if self.cache is None:
                return self.pool.can_alloc(need)
            hits, avail = self._admit_capacity(req.resume_tokens())
            return avail >= need - hits
        # on-demand: admit on the blocks the prefill needs NOW plus a
        # headroom watermark, waived when nothing is running (an empty pool
        # must always admit; admission_check bounded the worst case)
        ctx = req.resume_tokens()
        hits, avail = self._admit_capacity(ctx)
        need = self.pool.blocks_for(len(ctx)) - hits
        slack = self.headroom if self.pool.active_blocks > 0 else 0
        return avail >= need + slack

    def _ensure_free(self, n: int) -> bool:
        """Evict LRU unreferenced cache entries until ``n`` blocks are on
        the free list.  Returns False if the pool can't get there."""
        short = n - self.pool.free_blocks
        if short > 0 and self.cache is not None:
            self.eng._count_cache_evict(len(self.cache.evict(short)))
            short = n - self.pool.free_blocks
        return short <= 0

    def reserve(self, req) -> None:
        hits: list[int] = []
        if self.cache is not None:
            hits = self.cache.acquire(req.resume_tokens())
            req.n_cache_hit = len(hits) * self.pool.block_size
        if self.kv_alloc == "reserve":
            need = self.pool.blocks_for(req.max_cached) - len(hits)
        else:
            need = self.pool.blocks_for(len(req.resume_tokens())) - len(hits)
        need = max(need, 0 if hits else 1)
        if not self._ensure_free(need):
            # can_reserve said yes, so this only races with same-step churn
            self.pool.free(hits)
            req.n_cache_hit = 0
            raise PoolExhausted(
                f"need {need} blocks, {self.pool.free_blocks} free")
        req.block_ids = hits + self.pool.alloc(need)

    def grow_to(self, req, n_tokens: int) -> bool:
        """On-demand growth: extend the request's block table to cover
        ``n_tokens`` cached positions, evicting unreferenced cache entries
        as needed.  False when the pool is exhausted (the engine then
        preempts a running request and retries)."""
        target = min(self.pool.blocks_for(n_tokens), self.max_blocks_per_slot)
        while len(req.block_ids) < target:
            if not self._ensure_free(1):
                return False
            req.block_ids += self.pool.alloc(1)
        return True

    def register_prefix(self, req, ctx) -> int:
        """Register the full-block prefix of a freshly prefilled context so
        later requests (and this one after preemption) can share it."""
        if self.cache is None:
            return 0
        return self.cache.register(ctx, req.block_ids)

    def make_writable(self, req, i: int) -> int:
        """Copy-on-write guard for block ``i`` of the request's table.

        A block that other tables reference gets a fresh copy (the device
        page duplicated in place, the old reference dropped); a privately
        held registered block is just deregistered.  Paged prefill never
        needs the shared case (it writes only past the acquired prefix), so
        this is a defensive primitive, tested directly.
        """
        b = req.block_ids[i]
        if self.pool.refcount(b) > 1:
            if not self._ensure_free(1):
                raise PoolExhausted("no free block for copy-on-write split")
            [nb] = self.pool.alloc(1)
            for page in self.pool.data.values():
                page[:, nb] = page[:, b]
            self.pool.free([b])
            req.block_ids[i] = nb
            return nb
        if self.cache is not None:
            self.cache.drop_block(b)
        return b

    def rollback_to(self, req, n_tokens: int) -> int:
        req.block_ids, freed = self.pool.truncate_to(req.block_ids, n_tokens)
        req.n_written = min(req.n_written, n_tokens)
        return len(freed)

    def release(self, req) -> None:
        if req.block_ids:
            # two-stage release: the speculative tail first, then the live
            # prefix; both land on the free list the same step
            self.rollback_to(req, req.n_cached)
            self.pool.free(req.block_ids)
            req.block_ids = []

    # -- device state ------------------------------------------------------

    def block_tables(self, reqs, n_rows: int) -> torch.Tensor:
        """[n_rows, MB] int32 tables on the device: request r's blocks in
        row ``r.slot`` (or row 0 with ``n_rows == 1``), zeros elsewhere."""
        bt = np.zeros((n_rows, self.max_blocks_per_slot), np.int32)
        for r in reqs:
            bt[r.slot if n_rows > 1 else 0, : len(r.block_ids)] = r.block_ids
        return torch.from_numpy(bt).to(self.eng.device)

    def write_prefill(self, req, cache) -> None:
        ids = req.block_ids[: self.pool.blocks_for(req.prompt_len)]
        decoder.write_prompt_to_pool(self.pool.data, cache, ids)

    def decode(self, reqs, toks, lens, active):
        dev = self.eng.device
        logits, _ = decoder.decode_step_paged(
            self.cfg, self.eng.params, self.pool.data,
            self.block_tables(reqs, lens.shape[0]),
            torch.from_numpy(lens).to(dev), torch.from_numpy(active).to(dev),
            {"tokens": torch.from_numpy(toks).to(dev)}, self.eng.sq,
            fused=self.eng.fused)
        return logits

    # -- speculative -------------------------------------------------------

    def draft_cap(self, req) -> int:
        """Proposals may touch positions up to the block reservation - 1."""
        return len(req.block_ids) * self.pool.block_size - req.n_cached - 1

    # snapshot / restore is never needed here: rejected positions are dead
    # behind the length mask and the next round's writes overwrite them

    # -- telemetry ---------------------------------------------------------

    def leaked(self) -> bool:
        """Refcount-aware leak check: blocks still referenced by a block
        table after drain are leaks; cached-but-unreferenced blocks are the
        prefix cache working as intended."""
        if self.pool.active_blocks != 0:
            return True
        if self.pool.used_blocks != self.pool.cached_blocks:
            raise RuntimeError(
                f"pool blocks neither referenced, cached, nor free: "
                f"{self.pool.used_blocks} used, {self.pool.cached_blocks} "
                "cached")
        return False

    def occupancy(self) -> tuple[int, int]:
        """(used, capacity) in the backend's own allocation unit (blocks)."""
        return self.pool.occupancy()

    def stats(self) -> dict:
        out = dict(self.pool.stats(), state_backend="paged_kv",
                   state_kinds=list(self.kinds), kv_alloc=self.kv_alloc)
        if self.cache is not None:
            out["prefix_cache"] = self.cache.stats()
        return out


class SlabState:
    """Per-slot constant-size state slabs for non-paged state plans.

    The model declares its per-slot state (``slot_state_specs``, batch
    axis = slot) and steps it (``decode_step_slots``, per-slot positions
    and an active mask).  Capacity is one slab slot per engine slot; only
    a plan with a finite dense KV ("dense_kv") bounds a request's prompt
    and generation, by the slab's ``s_alloc`` positions.  ``snapshot`` is
    a reference to the state tree, which nothing writes in place;
    ``restore_select`` gathers each slot's state from a chain of them.
    Under a mesh ``specs`` are the whole state's and ``data`` holds this
    rank's tiles (``local``), which the rank's forwards read and write.
    """

    def __init__(self, engine, cfg, *, n_slots, s_alloc, plan):
        self.eng = engine
        self.cfg = cfg
        self.kinds = tuple(plan)
        self.model = get_model(cfg)
        self.n_slots = n_slots
        self.specs = self.model.slot_state_specs(cfg, n_slots, s_alloc)
        self.local = slab_specs(cfg, n_slots, s_alloc, engine.mesh,
                                engine.rules)
        self.data = common.zeros_from_specs(self.local, engine.device)
        # a finite dense KV bounds admission; recurrent slabs and window
        # rings are O(1) per slot whatever the sequence length
        self.dense_bound = s_alloc if "dense_kv" in self.kinds else None
        # an encoder-conditioned plan needs each request's encoder input
        self.required_extras = (("enc_frames",)
                                if "encoder_output" in self.kinds else ())
        self.in_use = [False] * n_slots
        self.peak_used = 0

    # -- capacity ----------------------------------------------------------

    def admission_check(self, req) -> None:
        for k in self.required_extras:
            if not req.extras or k not in req.extras:
                raise ValueError(
                    f"{self.cfg.name}: request needs extras[{k!r}] "
                    "(encoder-conditioned arch)")
        if self.dense_bound is not None and req.max_cached > self.dense_bound:
            raise ValueError(
                f"request needs {req.max_cached} cached positions > "
                f"state slab capacity={self.dense_bound} "
                f"(prompt {req.prompt_len} + gen {req.max_new_tokens}); "
                "it could never be admitted")

    def can_reserve(self, req) -> bool:
        return True          # one slab slot per engine slot, nothing else

    def reserve(self, req) -> None:
        self.in_use[req.slot] = True
        self.peak_used = max(self.peak_used, sum(self.in_use))

    def rollback_to(self, req, n_tokens: int) -> int:
        # no positional storage to truncate: device-state rollback is
        # snapshot / restore; only the host mark is clamped
        req.n_written = min(req.n_written, n_tokens)
        return 0

    def release(self, req) -> None:
        if req.slot is not None:
            self.in_use[req.slot] = False

    # -- device state ------------------------------------------------------

    def write_prefill(self, req, cache) -> None:
        self.data = slab_write(self.specs, self.data, cache, req.slot)

    def decode(self, reqs, toks, lens, active):
        del reqs                               # slot index == state address
        dev = self.eng.device
        logits, self.data = self.model.decode_step_slots(
            self.cfg, self.eng.params, self.data,
            {"tokens": torch.from_numpy(toks).to(dev)},
            torch.from_numpy(lens).to(dev), torch.from_numpy(active).to(dev),
            self.eng.sq)
        return logits

    # -- speculative -------------------------------------------------------

    def draft_cap(self, req) -> int:
        if self.dense_bound is not None:
            return self.dense_bound - req.n_cached - 1
        return 1 << 30       # recurrent / ring state: no positional bound

    def snapshot(self):
        """The state tree itself: nothing writes it in place."""
        return self.data

    def restore(self, snap) -> None:
        self.data = snap

    def restore_select(self, snaps, sel) -> None:
        """Set each slot's state to its rows in ``snaps[sel[slot]]``."""
        self.data = slab_restore_select(self.specs, list(snaps), sel)

    # -- telemetry ---------------------------------------------------------

    def leaked(self) -> bool:
        return any(self.in_use)

    def occupancy(self) -> tuple[int, int]:
        """(used, capacity) in the backend's own allocation unit (slots)."""
        return sum(self.in_use), self.n_slots

    def stats(self) -> dict:
        """Occupancy and bytes; ``pool_bytes`` and
        ``state_bytes_per_slot_total`` are the whole state's (one card's),
        ``pool_bytes_per_device`` and ``state_bytes_per_slot`` this rank's
        tiles."""
        used = sum(self.in_use)
        nbytes = _tree_nbytes(self.data)
        whole = common.spec_bytes(self.specs)
        return {
            "state_backend": "slab",
            "state_kinds": list(self.kinds),
            "n_slots": self.n_slots,
            "used_slots": used,
            "peak_used_slots": self.peak_used,
            "utilization": used / max(self.n_slots, 1),
            "peak_utilization": self.peak_used / max(self.n_slots, 1),
            "fp8": False,
            "pool_bytes": whole,
            "pool_bytes_per_device": nbytes,
            "state_bytes_per_slot": slab_bytes_per_slot(self.local,
                                                        self.n_slots),
            "state_bytes_per_slot_total": slab_bytes_per_slot(self.specs,
                                                              self.n_slots),
            "state_dense_bound": self.dense_bound,
        }
