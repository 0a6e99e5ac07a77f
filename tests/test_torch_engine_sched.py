"""The engine's host side in the PyTorch port, on the CPU: the pool's and the
prefix cache's bookkeeping against the reference's classes on the same
sequences of operations (**bitwise**: the same block ids, refcounts, free
counts, hits and evictions), copy-on-write, admission, retirement and
backfill, sampling, and the options the port refuses.

The reference's ``PagedKVPool`` and ``PrefixCache`` are host code: they run
here in-process on numpy placeholders of the pool's shape.  The engine
tests serve the port's own smoke model from a seed (no reference needed).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import paged_kv as jpaged
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import decoder
from repro_torch.serve import Engine, SamplingParams, UnsupportedStateError
from repro_torch.serve import paged_kv, sampling
from repro_torch.serve.scheduler import Request

ARCH = "qwen1.5-0.5b"
GEN = 5


@pytest.fixture(scope="module")
def loaded():
    cfg = configs.get_smoke(ARCH)
    return cfg, {fmt: serve.load_quantized(cfg, 0, fmt, "cpu")
                 for fmt in ("qdq", "packed")}


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _engine(cfg, params, qcfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_blocks_per_slot", 4)
    kw.setdefault("n_blocks", 16)
    return Engine(cfg, params, qcfg, device="cpu", **kw)


# ---------------------------------------------------------------------------
# bookkeeping against the reference, bitwise
# ---------------------------------------------------------------------------


def _pools(n_blocks=8, bs=4):
    """(reference pool, port pool) of the same geometry."""
    cfg = configs.get_smoke(ARCH)
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    jp = jpaged.PagedKVPool({"k": np.zeros(shape, np.float32),
                             "v": np.zeros(shape, np.float32)}, bs)
    pp = paged_kv.PagedKVPool(decoder.init_paged_pool(cfg, n_blocks, bs, "cpu"),
                              bs)
    return jp, pp


def _books(pool, cache=None):
    out = [pool.free_blocks, pool.used_blocks, pool.active_blocks,
           pool.cached_blocks, pool.shared_blocks, pool.peak_used,
           sorted(pool._refcnt.items()), list(pool._free),
           sorted(pool._cached)]
    if cache is not None:
        out += [cache.hits, cache.misses, cache.evictions, cache.evictable,
                sorted(cache._by_block)]
    return out


def _replay(script, n_blocks=8, bs=4, sig="sig"):
    """Run ``script(mods, pool, cache, log)`` on the reference and on the
    port; return both logs."""
    logs = []
    for mod, pool in zip((jpaged, paged_kv), _pools(n_blocks, bs)):
        cache = mod.PrefixCache(pool, sig) if sig else None
        log = []

        def rec(x=None):
            log.append([x, _books(pool, cache)])

        def catch(fn, *a):
            try:
                rec(fn(*a))
            except (ValueError, mod.PoolExhausted) as e:
                rec(type(e).__name__)
        script(mod, pool, cache, rec, catch)
        logs.append(log)
    return logs


def test_pool_alloc_free_matches_reference():
    """tests/test_engine.py:56 as an operation log: alloc, exhaustion,
    double free, free, peak, blocks_for."""
    def script(mod, pool, cache, rec, catch):
        a = pool.alloc(3)
        b = pool.alloc(5)
        rec([a, b, pool.can_alloc(1)])
        catch(pool.alloc, 1)
        pool.free(a)
        rec()
        catch(pool.free, a)
        pool.free(b)
        rec([pool.blocks_for(1), pool.blocks_for(9), pool.utilization()])
    ref, port = _replay(script, sig=None)
    assert port == ref
    assert ref[0][0][1] == [3, 4, 5, 6, 7] and ref[-1][1][0] == 8


def test_pool_refcounts_retain_truncate_match_reference():
    """tests/test_prefix_cache.py:76-125: shared refcounts, the retain hook
    parking and reclaiming, truncate never destroying a shared block."""
    def script(mod, pool, cache, rec, catch):
        [b] = pool.alloc(1)
        pool.incref([b])
        rec(pool.refcount(b))
        pool.free([b])
        pool.free([b])
        catch(pool.free, [b])
        catch(pool.incref, [b])
        parked = []
        pool._retain_hook = lambda x: parked.append(x) or True
        [c] = pool.alloc(1)
        pool.free([c])
        rec(parked)
        catch(pool.free, [c])
        pool.incref([c])
        pool.free([c])
        pool.reclaim([c])
        catch(pool.reclaim, [c])
        pool._retain_hook = None
        ids = pool.alloc(3)
        pool.incref([ids[0]])
        rec(pool.truncate_to(list(ids), 0))
        rec(pool.truncate_to(pool.alloc(3), 5))
    ref, port = _replay(script, sig=None)
    assert port == ref


def test_prefix_cache_matches_reference():
    """tests/test_prefix_cache.py:128-171: register / acquire round trip,
    chain verification, the last position never served, LRU eviction,
    drop_block; hits, misses and evictions counted alike."""
    def script(mod, pool, cache, rec, catch):
        toks = np.arange(11, dtype=np.int32)
        ids = pool.alloc(3)
        rec(cache.register(toks, ids))
        pool.free(ids)
        rec([cache.lookup(toks), cache.lookup(toks[:4])])
        got = cache.acquire(toks)
        rec(got)
        div = toks.copy()
        div[5] += 1
        pool.free(got)
        rec(cache.lookup(div))
        a = np.arange(200, 204, dtype=np.int32)
        b = np.arange(100, 104, dtype=np.int32)
        ia, ib = pool.alloc(1), pool.alloc(1)
        cache.register(a, ia)
        cache.register(b, ib)
        pool.free(ia)
        pool.free(ib)
        cache.acquire(np.concatenate([a, a[:1]]))
        pool.free(ia)
        rec(cache.evict(1))
        cache.drop_block(ia[0])
        rec(cache.evict(5))
        rec(cache.stats())
    ref, port = _replay(script)
    assert port == ref
    assert ref[-1][0]["evictions"] > 0 and ref[-1][0]["hits"] > 0


def test_prefix_cache_signature_separates_streams():
    pool = _pools(bs=4)[1]
    toks = np.arange(9, dtype=np.int32)
    ids = pool.alloc(2)
    c1 = paged_kv.PrefixCache(pool, "fp8-kv")
    c1.register(toks, ids)
    assert c1.lookup(toks) == 2
    assert paged_kv.PrefixCache(pool, "bf16-kv").lookup(toks) == 0


# ---------------------------------------------------------------------------
# copy-on-write
# ---------------------------------------------------------------------------


def test_cow_split_preserves_sibling_bytes(loaded):
    cfg, by_fmt = loaded
    eng = _engine(cfg, *by_fmt["packed"], prefill_mode="paged",
                  prefix_cache=True, kv_alloc="ondemand", n_blocks=8)
    st, pool = eng.state, eng.pool
    [b] = pool.alloc(1)
    pool.incref([b])
    for i, page in enumerate(pool.data.values()):
        page[:, b] = 1.0 + i
    before = {k: v[:, b].clone() for k, v in pool.data.items()}
    r1 = Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=1)
    r2 = Request(rid=1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=1)
    r1.block_ids, r2.block_ids = [b], [b]
    nb = st.make_writable(r1, 0)
    assert nb != b and r1.block_ids == [nb] and r2.block_ids == [b]
    assert pool.refcount(b) == 1 and pool.refcount(nb) == 1
    for k, v in pool.data.items():
        assert torch.equal(v[:, nb], before[k]) and torch.equal(v[:, b], before[k])
        v[:, nb] = -9.0                  # the writer's copy diverges...
        assert torch.equal(v[:, b], before[k])   # ...the sibling's does not


def test_cow_private_registered_block_deregisters(loaded):
    cfg, by_fmt = loaded
    eng = _engine(cfg, *by_fmt["packed"], prefill_mode="paged",
                  prefix_cache=True, kv_alloc="ondemand", n_blocks=8)
    st, pool = eng.state, eng.pool
    toks = np.arange(9, dtype=np.int32)
    ids = pool.alloc(1)
    st.cache.register(toks, ids)
    r = Request(rid=0, prompt=toks, max_new_tokens=1)
    r.block_ids = list(ids)
    assert st.make_writable(r, 0) == ids[0]
    pool.free(ids)
    assert pool.cached_blocks == 0 and st.cache.lookup(toks) == 0


# ---------------------------------------------------------------------------
# admission, retirement, backfill
# ---------------------------------------------------------------------------


def test_admission_refuses_when_pool_exhausted(loaded):
    cfg, by_fmt = loaded
    eng = _engine(cfg, *by_fmt["qdq"], n_blocks=3)
    rids = [eng.submit(p, GEN) for p in _prompts(cfg, [16, 16, 16], seed=7)]
    eng.step()
    assert len(eng.sched.in_flight()) == 1 and len(eng.sched.waiting) == 2
    assert eng.sched.admit_next() is None
    outputs = eng.drain(max_steps=500)
    assert sorted(outputs) == sorted(rids)
    assert eng.pool.used_blocks == 0 and eng.pool.peak_used == 3


def test_scheduler_rejects_never_admittable_requests(loaded):
    cfg, by_fmt = loaded
    eng = _engine(cfg, *by_fmt["qdq"])               # 4 blocks x 8 = 32
    with pytest.raises(ValueError, match="max_blocks_per_slot"):
        eng.submit(np.arange(4, 40, dtype=np.int32), 10)
    eng = _engine(cfg, *by_fmt["qdq"], n_blocks=3, max_blocks_per_slot=16,
                  n_slots=2)
    with pytest.raises(ValueError, match="pool capacity"):
        eng.submit(np.arange(4, 36, dtype=np.int32), 10)   # 6 > 3 blocks
    rid = eng.submit(np.arange(4, 24, dtype=np.int32), 5)  # exactly 3
    assert list(eng.drain(max_steps=200)) == [rid]
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros(0, np.int32), 4)


def test_head_of_line_blocks_small_requests(loaded):
    cfg, by_fmt = loaded
    eng = _engine(cfg, *by_fmt["qdq"], n_blocks=4, n_slots=2)
    running = eng.submit(_prompts(cfg, [16], seed=15)[0], GEN)
    eng.step()
    giant = eng.submit(_prompts(cfg, [16], seed=16)[0], GEN)
    small = eng.submit(_prompts(cfg, [4], seed=17)[0], 3)
    eng.step()
    in_flight = {r.rid for r in eng.sched.in_flight()}
    assert giant not in in_flight and small not in in_flight
    assert [r.rid for r in eng.sched.waiting] == [giant, small]
    assert sorted(eng.drain(max_steps=500)) == sorted([running, giant, small])
    assert eng.pool.used_blocks == 0


def test_eos_retires_and_backfills(loaded):
    cfg, by_fmt = loaded
    params, qcfg = by_fmt["qdq"]
    prompts = _prompts(cfg, [8, 8, 8], seed=9)
    ref, _ = serve.serve_batch(cfg, params, torch.from_numpy(prompts[0][None]).long(),
                               GEN, qcfg=qcfg)
    eos = int(ref[0, 0])
    eng = _engine(cfg, params, qcfg, n_slots=1, eos_id=eos)
    rids = [eng.submit(p, GEN) for p in prompts]
    outputs = eng.drain(max_steps=500)
    assert eng.sched.finished[rids[0]].finish_reason == "eos"
    assert outputs[rids[0]].tolist() == [eos]
    assert sorted(outputs) == sorted(rids)
    assert all(eng.sched.finished[r].finish_reason in ("eos", "length")
               for r in rids)
    assert eng.pool.used_blocks == 0


def test_ondemand_admits_more_concurrently_than_reserve(loaded):
    cfg, by_fmt = loaded
    rng = np.random.default_rng(7)
    head = rng.integers(4, cfg.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(4, cfg.vocab_size,
                                                  (2 + i % 5,))]).astype(np.int32)
               for i in range(8)]

    def peak_admitted(**kw):
        eng = _engine(cfg, *by_fmt["packed"], n_slots=4, n_blocks=6,
                      max_blocks_per_slot=3, prefill_mode="paged", **kw)
        for p in prompts:
            eng.submit(p, 10)
        peak = 0
        while eng.sched.has_work():
            eng.step()
            peak = max(peak, len(eng.sched.in_flight()))
        assert len(eng.sched.finished) == len(prompts)
        assert not eng.state.leaked()
        return peak

    assert peak_admitted(prefix_cache=True, kv_alloc="ondemand", headroom=0) \
        > peak_admitted(kv_alloc="reserve")


def test_engine_latency_stats(loaded):
    cfg, by_fmt = loaded
    eng = _engine(cfg, *by_fmt["qdq"])
    rids = [eng.submit(p, 4) for p in _prompts(cfg, [4, 9], seed=19)]
    eng.drain(max_steps=200)
    st = eng.stats()
    for key in ("ttft_p50_s", "ttft_p95_s", "decode_lat_p50_s",
                "decode_lat_p95_s"):
        assert st[key] > 0.0
    assert st["ttft_p50_s"] <= st["ttft_p95_s"]
    assert st["tokens_generated"] == 8 and st["requests_finished"] == 2
    for rid in rids:
        req = eng.sched.finished[rid]
        assert req.first_tok_t >= req.submit_t > 0 and req.ttft_s > 0


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_topk_ties_admit_exactly_k():
    """Ranking by (-logit, token id): exactly k survive, tied candidates
    win by lower token id."""
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    finite = lambda k: torch.isfinite(sampling.topk_mask(logits, [k]))[0]
    assert finite(1).tolist() == [False, True, False, False]
    assert finite(2).tolist() == [False, True, True, False]
    assert finite(3).tolist() == [False, True, True, True]
    assert torch.isfinite(sampling.topk_mask(torch.zeros(1, 4), [0])).all()
    toks = sampling.sample_tokens_seeded(logits.expand(5, 4), [1.3] * 5,
                                         [1] * 5, range(5), [0] * 5)
    assert toks.tolist() == [1] * 5


def test_sampling_greedy_topk_and_seeded_determinism():
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    zeros = np.zeros(4, np.float32)
    greedy = sampling.sample_tokens_seeded(logits, zeros, [0] * 4, range(4),
                                           [0] * 4)
    assert torch.equal(greedy, torch.argmax(logits, -1))
    tied = torch.zeros(2, 8)
    assert sampling.sample_tokens_seeded(tied, [0, 0], [0, 0], [0, 1],
                                         [0, 0]).tolist() == [0, 0]
    t1 = sampling.sample_tokens_seeded(logits, [1.7] * 4, [1] * 4, range(4),
                                       [0] * 4)
    assert torch.equal(t1, greedy)
    a = sampling.sample_tokens_seeded(logits, [0.9] * 4, [8] * 4, range(4),
                                      [3] * 4)
    b = sampling.sample_tokens_seeded(logits, [0.9] * 4, [8] * 4, range(4),
                                      [3] * 4)
    assert torch.equal(a, b)
    top8 = torch.argsort(logits, -1)[:, -8:]
    assert all(int(t) in top8[i].tolist() for i, t in enumerate(a))
    draws = {tuple(sampling.sample_tokens_seeded(logits, [5.0] * 4, [0] * 4,
                                                 range(4), [i] * 4).tolist())
             for i in range(8)}
    assert len(draws) > 1                    # the token index moves the stream
    assert sampling.request_seed(3, 1) != sampling.request_seed(1, 3)
    p = sampling.filtered_probs(logits, [0.9] * 4, [8] * 4)
    assert torch.allclose(p.sum(-1), torch.ones(4))
    assert int((p > 0).sum(-1).max()) == 8


def test_engine_sampled_requests_are_deterministic(loaded):
    cfg, by_fmt = loaded
    sp = SamplingParams(temperature=0.8, top_k=16, seed=123)

    def run(n_slots):
        eng = _engine(cfg, *by_fmt["qdq"], n_slots=n_slots)
        rids = [eng.submit(p, 4, sampling=sp)
                for p in _prompts(cfg, [5, 12], seed=11)]
        return [eng.drain(max_steps=200)[r].tolist() for r in rids]

    # per-request seeds: the same streams whatever the schedule
    assert run(2) == run(2) == run(1)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


def test_engine_raises_on_unported_plans_and_options(loaded):
    cfg, by_fmt = loaded
    params, qcfg = by_fmt["qdq"]
    with pytest.raises(UnsupportedStateError, match="vision_prefix"):
        Engine(configs.get_smoke("qwen2-vl-2b"), params={}, device="cpu")
    # rwkv6 serves on its slab plan; the paged pool's options it refuses
    with pytest.raises(ValueError, match="paged-KV state plan"):
        Engine(configs.get_smoke("rwkv6-3b"), params={}, prefill_mode="paged",
               prefix_cache=True, device="cpu")
    # FP8 KV, speculative decoding and the slab plans serve under tensor
    # parallelism; a slab config whose heads do not split over the group is
    # refused (the speculative engine's too), and a mesh that is not a TP
    # context
    from repro_torch.distributed.ctx import TP
    from repro_torch.serve import engine as engine_mod
    from repro_torch.spec import SpecEngine
    assert engine_mod._check_tp(configs.get_smoke("arctic-480b"), 2) is None
    assert engine_mod._check_tp(configs.get_smoke("rwkv6-3b"), 2) is None
    tp2 = TP(group=None, rank=0, size=2, device=torch.device("cpu"))
    tp4 = TP(group=None, rank=0, size=4, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="heads"):
        SpecEngine(configs.get_smoke("rwkv6-3b"), {"embed": torch.zeros(1)},
                   mesh=tp4, device="cpu")
    with pytest.raises(TypeError, match="TP"):
        SpecEngine(cfg, params, qcfg, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="TP"):
        _engine(cfg, params, qcfg, mesh=object())
    # telemetry serves; under tensor parallelism the shadow teacher is cut
    # as the student is, and a teacher held at neither its whole shape nor
    # its tile is refused
    from repro_torch.obs import Observability
    assert _engine(cfg, params, qcfg, obs=Observability()).obs.enabled
    bad = {**params, "embed": params["embed"][: cfg.vocab_size // 4]}
    with pytest.raises(ValueError, match="neither the whole"):
        _engine(cfg, params, qcfg, shadow_teacher=bad, shadow_rate=0.5,
                mesh=tp2)
    for mode in ("chunked", "paged"):          # paged-KV plans only
        with pytest.raises(ValueError, match="paged-KV"):
            Engine(configs.get_smoke("recurrentgemma-2b"), params,
                   prefill_mode=mode, device="cpu")
    with pytest.raises(ValueError):
        _engine(cfg, params, qcfg, fused_kernels="sometimes")
    for kw in (dict(prefix_cache=True), dict(kv_alloc="ondemand")):
        with pytest.raises(ValueError, match="paged"):
            _engine(cfg, params, qcfg, **kw)
    with pytest.raises(ValueError, match="kv_alloc"):
        _engine(cfg, params, qcfg, prefill_mode="paged", kv_alloc="lazy")


def test_engine_defaults_to_cuda_and_raises_without_it(loaded):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is usable")
    cfg, by_fmt = loaded
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, *by_fmt["qdq"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--engine"])


def test_fp8_pool_writes_raise():
    """An FP8 pool (the moe_hybrid recipe) takes E4M3 pages and f32 scales
    from ``_quant_kv``, written in place, inactive rows dropped; the write
    raises for an FP8 layer that lacks a scale plane."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), quant_recipe="moe_hybrid")
    pool = decoder.init_paged_pool(cfg, 4, 8, "cpu")
    assert pool["k"].dtype == torch.float8_e4m3fn
    assert pool["k_scale"].shape == pool["k"].shape[:-1]
    sl = {k: v[0] for k, v in pool.items()}
    kv = torch.randn(2, 1, cfg.n_kv_heads, cfg.head_dim).to(torch.bfloat16)
    attn.paged_update_layer(sl, kv, 2 * kv, torch.tensor([[1], [2]], dtype=torch.int32),
                            torch.tensor([3, 5], dtype=torch.int32),
                            torch.tensor([True, False]))
    kq, ks = attn._quant_kv(kv)
    assert torch.equal(sl["k"][1, 3].view(torch.uint8), kq[0, 0].view(torch.uint8))
    assert torch.equal(sl["k_scale"][1, 3], ks[0, 0])
    assert not sl["k"][2].view(torch.uint8).any() and not sl["v_scale"][2].any()
    bad = {k: v for k, v in sl.items() if k != "v_scale"}
    with pytest.raises(KeyError):
        attn.paged_update_layer(bad, kv, kv, torch.zeros(2, 1, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32),
                                torch.ones(2, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_engine_cli_cpu(capsys):
    """``--engine`` on the CPU: mixed lengths, staggered arrivals, parity
    with single-request serve_batch, the pool drained."""
    res = serve.main(["--device", "cpu", "--arch", "acereason-7b",
                      "--weight-format", "packed", "--engine", "--requests",
                      "6", "--gen", "4"])
    assert res["ok"] and res["tokens_match_serve_batch"] and res["pool_drained"]
    assert "parity=AGREE pool-drained=True" in capsys.readouterr().out


def test_engine_cli_prefix_cache_cpu(capsys):
    """``--prefix-cache on`` promotes paged prefill and on-demand paging
    and checks the tokens against a cache-off run."""
    res = serve.main(["--device", "cpu", "--arch", "qwen1.5-0.5b",
                      "--weight-format", "packed", "--engine", "--requests",
                      "6", "--gen", "4", "--prefix-cache", "on",
                      "--block-size", "4", "--fused-kernels", "off"])
    assert res["ok"] and res["tokens_match_cache_off"]
    assert res["tokens_match_serve_batch"] is None
    assert res["stats"]["kv_alloc"] == "ondemand"
    assert "cache-off-parity=AGREE" in capsys.readouterr().out


def test_engine_cli_flags():
    args = serve.build_parser().parse_args(
        ["--engine", "--slots", "8", "--block-size", "16", "--n-blocks", "272",
         "--prefill-mode", "paged", "--kv-alloc", "ondemand", "--prefix-cache",
         "on", "--fused-kernels", "off", "--requests", "16"])
    assert (args.engine, args.slots, args.n_blocks, args.prefill_mode,
            args.kv_alloc, args.prefix_cache, args.fused_kernels,
            args.device) == (True, 8, 272, "paged", "ondemand", "on", "off",
                             "cuda")
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--prefix-cache", "on"])
