"""Batched greedy serving over NVFP4 weights (port of
``repro.launch.serve``'s static-batch path).

Offline weight PTQ (fake-quantized BF16 or true-packed 4-bit) + prefill +
greedy decode.  With ``--weight-format packed`` every 2-D quantized GEMM
runs the ``nvfp4_matmul`` CUDA kernel and every GEMM input the
``nvfp4_qdq`` kernel; MoE expert stacks are dequantized and multiplied,
or, in the engine's fused tier, run the ``nvfp4_matmul_grouped`` kernel.  Full size on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
        --arch acereason-7b --weight-format packed

In packed mode the CLI also replays the batch over the QDQ weights made
from the same seed and reports whether the greedy tokens agree
(``--no-parity`` skips it).  ``--device cpu`` runs the plain versions of
the kernels, at smoke size.

``--engine`` serves through the continuous-batching engine
(``repro_torch.serve``) instead of the static [B, P] batch: requests of
mixed prompt lengths (``--min-prompt``..``--max-prompt``) arrive
staggered, half up front and one after each engine step, and are
scheduled into ``--slots`` decode slots over a paged KV pool
(``--block-size``, ``--n-blocks``), or for the slab families
(``--arch nemotron-nano-9b-sim``, ``recurrentgemma-2b``, ``rwkv6-3b``,
``whisper-tiny``) over per-slot state slabs; whisper's requests each get
their own seeded encoder frames.  ``--arch qwen2-vl-2b`` (M-RoPE) is
refused in one line: the engine serves no "vision_prefix".
``--prefill-mode chunked`` prefills paged-plan prompts in chunks of
``--prefill-chunk`` tokens (approximate: its parity check is off unless
``--parity`` asks for it).  Each request's greedy output is
checked against a single-request ``serve_batch`` (exact prefill): token for
token on the CPU, the first token on the card (see ``run_engine``).  With
``--prefix-cache on`` the whole workload again with the cache off must give
the same tokens bitwise.  The pool must drain with
nothing leaked.  The CLI exits 1 if any check fails:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen1.5-0.5b --weight-format packed --engine --requests 8 --gen 6

``--arch arctic-480b`` (the ``moe_hybrid`` recipe) serves from an FP8 KV
pool (E4M3 pages with f32 scales; ``kv=fp8`` on the engine line).
``--speculative K`` serves through ``repro_torch.spec.SpecEngine``: the
``--draft`` proposer (``self-qdq``, ``self-truncate`` at
``--draft-layers``, or ``two-model``: a fresh ``--draft-layers``-deep
model from seed 99, the stand-in for a small distilled student) drafts K
tokens a slot and one verify scores them; ``--adaptive-k`` picks each
slot's k from its measured acceptance.  Its greedy streams are checked
token for token against the plain engine's on the same workload, and a
``[engine] speculative: acceptance=...`` line follows:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen1.5-0.5b --weight-format packed --engine --speculative 3

``--tp N`` serves the engine tensor-parallel over N ranks, one process
each (``launch.mesh.spawn``, a gloo group), on ``--device``: every rank
cuts its tiles of the weights and of the KV pool or the state slabs,
the packed GEMMs run K4, and rank 0 prints.  Each rank checks its
outputs against the single-device ``serve_batch`` on the full weights
(with ``--speculative`` against the plain engine under the same
``--tp``).  MoE configs split
their experts (E, or each expert's FFN dim under ``moe_shard="tp"``),
an FP8 pool its pages and scales by KV head; the slab families
(``rwkv6-3b``, ``whisper-tiny`` with each request's frames,
``nemotron-nano-9b-sim``, ``recurrentgemma-2b``) their state slabs by
head or channel; ``--speculative``, ``--draft``, ``--adaptive-k`` and
``--shadow-rate`` compose with it:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen1.5-0.5b --weight-format packed --engine --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch arctic-480b --weight-format packed --engine --tp 2 \
        --speculative 2 --shadow-rate 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch rwkv6-3b --weight-format packed --engine --tp 2

Telemetry (engine mode): ``--obs metrics`` (counters, gauges, latency
histograms, dispatch counts) or ``--obs trace`` (also the request
lifecycle tracer); ``--metrics-out m.json`` writes the
``repro.obs.metrics/v1`` snapshot and ``m.prom``, ``--trace-out t.json``
the Chrome trace (each implies the mode it needs; under ``--tp`` rank 0
writes them).  ``--shadow-rate R`` re-scores the running requests'
contexts through the BF16 teacher (the seeded init the weights were
quantized from) on about R of the decode steps and prints a
``[numerics]`` line; ``--inject-quant-noise S`` scales every packed
tensor scale by 1 + S, the canary ``python -m repro_torch.obs.compare
--gate`` must catch.  Greedy tokens are bitwise the same in every mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen1.5-0.5b --weight-format packed --engine --obs trace \
        --shadow-rate 0.5 --metrics-out m.json --trace-out t.json
    PYTHONPATH=src python -m repro_torch.obs.validate --trace t.json \
        --metrics m.json --prom m.prom
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from .. import configs
from ..core import ptq
from ..core.nvfp4 import PackedNVFP4
from ..models import common, get_model
from . import specs


def params_device(params) -> torch.device:
    """The device a parameter tree lives on (its embedding's)."""
    return params["embed"].device


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _draw(cfg, seed: int, device, tp=None, leaf=lambda spec, w: w):
    """The seeded BF16 init of ``cfg``, each leaf replaced by
    ``leaf(spec, w)`` as soon as it is drawn and, with ``tp`` (a
    ``distributed.ctx.TP``), cut to this rank's tile under the rules of
    ``distributed.sharding``: one full leaf at most is alive at a time."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pspecs = get_model(cfg).param_specs(cfg)
    if tp is None:
        def one(path, spec, w):
            return leaf(spec, w)
    else:
        from ..distributed import sharding
        rules = sharding.make_rules()
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)

        def one(path, spec, w):
            return sharding.shard_leaf(spec, leaf(spec, w), tp.rank, tp.size,
                                       rules, path, heads)
    with torch.no_grad():
        return common.init_params(pspecs, gen, device, leaf_fn=one)


def load_quantized(cfg, seed: int = 0, weight_format: str = "qdq",
                   device="cuda", tp=None):
    """Deploy-time weights: random BF16 init from ``seed``, then one-shot
    PTQ of each leaf as it is drawn (``_draw``).  Returns (params, qcfg).
    With ``tp`` (a ``distributed.ctx.TP``) the rank keeps only its tiles
    of the same weights."""
    qcfg = dataclasses.replace(specs.recipe_qconfig(cfg),
                               weight_format=weight_format)
    return _draw(cfg, seed, device, tp,
                 lambda spec, w: ptq.quantize_leaf(spec, w, qcfg)), qcfg


def load_teacher(cfg, seed: int = 0, device="cuda", tp=None):
    """The BF16 teacher: the seeded init ``load_quantized`` quantizes,
    unquantized (the shadow teacher's parameters).  With ``tp`` only this
    rank's tiles, under the rules the student's tiles follow."""
    return _draw(cfg, seed, device, tp)


def inject_quant_noise(params, scale: float):
    """Perturb every PackedNVFP4 leaf's per-tensor scale by (1 + scale).

    The numerics-drift canary: a deliberate calibration error that the
    shadow teacher's probes must surface (live KL up, per-layer amax
    drifted) and the snapshot gate must trip on.  Greedy engine-vs-
    ``serve_batch`` parity still holds (both sides share the perturbed
    weights), so only the numerics plane sees the fault."""

    def bump(leaf):
        if isinstance(leaf, PackedNVFP4):
            return dataclasses.replace(
                leaf, tensor_scale=leaf.tensor_scale * (1.0 + scale))
        return leaf

    return common.tree_map(bump, params)


def serve_batch(cfg, params, prompts: torch.Tensor, n_gen: int, qcfg=None,
                extras=None):
    """Prefill + greedy decode ``n_gen`` tokens for a [B, P] prompt batch.

    ``qcfg`` overrides the recipe's serving config; serving never
    fake-quantizes weights at run time (they are quantized offline).
    ``extras`` adds batched non-token prefill inputs (``enc_frames``
    [B, enc_seq, d] for an encoder-decoder config).  Returns (tokens
    [B, n_gen], stats).
    """
    device = resolve_device(prompts.device)
    model = get_model(cfg)
    sq = (dataclasses.replace(qcfg, quantize_weights=False)
          if qcfg is not None else specs.serve_qconfig(cfg))
    s_max = prompts.shape[1] + n_gen
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        batch = {"tokens": prompts}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(v, device=device)
        logits, cache = model.prefill(cfg, params, batch, sq, s_max=s_max)
        out = [torch.argmax(logits[:, -1:], -1)]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_gen - 1):
            logits, cache = model.decode_step(cfg, params, cache,
                                              {"tokens": out[-1]}, sq)
            out.append(torch.argmax(logits[:, -1:], -1))
        _sync(device)
        t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, 1)
    # n_gen tokens come back; the first is taken from the prefill logits, so
    # decode_tok_s rates the n_gen - 1 decode steps alone
    b = prompts.shape[0]
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode,
                    "decode_steps": n_gen - 1, "n_tokens": b * n_gen,
                    "decode_tok_s": b * (n_gen - 1) / max(t_decode, 1e-9),
                    "e2e_tok_s": b * n_gen / max(t_prefill + t_decode, 1e-9)}


def weight_report(params) -> dict:
    """Deployed weight footprint; packed GEMM weights cost 0.5625 B/param."""
    st = common.weight_stats(params)
    st["q_bytes_per_param"] = (st["q_bytes"] / st["q_params"]
                               if st["q_params"] else 0.0)
    return st


def mixed_prompts(n: int, min_len: int, max_len: int, vocab: int,
                  seed: int = 1) -> list[np.ndarray]:
    """``n`` prompts with lengths spread evenly over min_len..max_len,
    tokens drawn from ``seed`` (int32 numpy, host side)."""
    gen = torch.Generator().manual_seed(seed)
    lens = np.linspace(min_len, max_len, n).round().astype(int)
    return [torch.randint(4, vocab, (int(l),), generator=gen).numpy()
            .astype(np.int32) for l in lens]


def obs_from_args(args):
    """Observability bundle from CLI args (None = fully disabled).

    ``--obs metrics|trace`` turns telemetry on explicitly; an output path
    implies the mode that produces it (``--trace-out`` needs the tracer,
    ``--metrics-out`` at least the registry)."""
    mode = getattr(args, "obs", "off") or "off"
    if getattr(args, "trace_out", None):
        mode = "trace"
    elif getattr(args, "metrics_out", None) and mode == "off":
        mode = "metrics"
    if mode == "off":
        return None
    from ..obs import Observability
    return Observability(metrics=True, trace=(mode == "trace"))


def build_engine(cfg, params, qcfg, args, mesh=None):
    """(Engine, n_blocks) from CLI-style ``args``: the pool holds
    ``--n-blocks`` blocks, or ``--slots`` worst-case requests; ``mesh``,
    this rank's ``TP``, serves tensor-parallel; ``--speculative K`` builds
    a ``SpecEngine``; ``--obs`` (and the output paths) telemetry,
    ``--shadow-rate`` the shadow teacher."""
    from ..serve import Engine

    bs = args.block_size
    mb = max(1, math.ceil((args.max_prompt + args.gen - 1) / bs))
    n_blocks = args.n_blocks or args.slots * mb
    prefix_cache = args.prefix_cache == "on"
    kv_alloc = args.kv_alloc or ("ondemand" if prefix_cache else "reserve")
    if (prefix_cache or kv_alloc == "ondemand") and args.prefill_mode != "paged":
        # sharing and preempt-resume are bitwise only under block-granular
        # paged prefill; promote, and record the effective mode
        args.prefill_mode = "paged"
    args.kv_alloc = kv_alloc
    kw = dict(n_slots=args.slots, block_size=bs, n_blocks=n_blocks,
              max_blocks_per_slot=mb, prefill_mode=args.prefill_mode,
              prefill_chunk=args.prefill_chunk,
              fused_kernels=args.fused_kernels, prefix_cache=prefix_cache,
              kv_alloc=kv_alloc, headroom=args.headroom,
              device=params_device(params), mesh=mesh,
              obs=obs_from_args(args))
    shadow_rate = getattr(args, "shadow_rate", 0.0) or 0.0
    if shadow_rate > 0.0:
        # the BF16 teacher: the seeded init the student was quantized from
        # (under TP this rank's tiles of it)
        kw.update(shadow_teacher=load_teacher(cfg, args.seed,
                                              params_device(params), mesh),
                  shadow_rate=shadow_rate)
    spec_k = getattr(args, "speculative", 0)
    if not spec_k:
        return Engine(cfg, params, qcfg, **kw), n_blocks
    from ..spec import SpecEngine

    draft_model = None
    if args.draft == "two-model":
        # the stand-in for a small distilled student: a fresh QDQ model at
        # --draft-layers depth from seed 99 (near-chance acceptance with
        # random weights; the output must still be the plain engine's)
        dl = args.draft_layers or max(1, cfg.n_layers // 2)
        dcfg = dataclasses.replace(cfg, n_layers=dl, name=f"{cfg.name}-2m")
        dparams, dqcfg = load_quantized(dcfg, 99, "qdq", params_device(params),
                                        tp=mesh)
        draft_model = (dcfg, dparams, dqcfg)
    eng = SpecEngine(cfg, params, qcfg, draft_k=spec_k, draft=args.draft,
                     draft_layers=args.draft_layers, draft_model=draft_model,
                     adaptive_k=args.adaptive_k, **kw)
    return eng, n_blocks


def tp_shard_report(eng) -> dict:
    """How the engine's packed weights and serve state sharded (the
    reference's keys, then the port's MoE, FP8 and slab ones).
    ``packed_total`` / ``packed_sharded`` count ``PackedNVFP4`` leaves and
    those cut into tiles (column- and row-parallel layers must not
    silently replicate), ``packed_rule_whole`` those the rules keep whole
    (no dim of theirs maps to the group: RWKV's ``dec_w1`` and
    ``ts_w1``); ``kv_sharded`` says the pool pages, or a slab leaf, split
    over the group.  ``experts_sharded``: every MoE expert stack is held
    as a tile (on E or on its FFN dim), ``expert_bytes_per_device`` their
    bytes on this rank; ``fp8_scales_sharded``: an FP8 pool's f32 scale
    planes split on the KV-head dim with its pages.  A slab engine adds
    ``state_sharded`` (its split leaves), ``state_leaves`` ({path:
    {"split", "bytes"}} on this rank) and ``state_bytes_per_slot``.  Byte
    counts are per device and over the whole group (a replicated leaf
    once)."""
    from ..distributed import sharding

    cfg = eng.cfg
    size = eng.mesh.size if eng.mesh else 1
    slab = eng.pool is None
    counts = sharding.shard_counts(
        eng.model.param_specs(cfg), eng.params, size, eng.rules,
        heads=(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        state=(eng.state.specs, eng.state.data) if slab else None)
    sst = eng.state.stats()
    out = {
        "packed_total": counts["packed_total"],
        "packed_sharded": counts["packed_sharded"],
        "packed_rule_whole": counts["packed_rule_whole"],
        "kv_sharded": (counts["state_sharded"] > 0 if slab
                       else eng.pool.n_shards > 1),
        "weight_bytes_per_device": sharding.device_bytes(eng.params),
        "weight_bytes_total": counts["weight_bytes_total"],
        "kv_pool_bytes_per_device": sst["pool_bytes_per_device"],
        "kv_pool_bytes_total": sst["pool_bytes"],
        "experts_sharded": (counts["expert_sharded"]
                            == counts["expert_total"] > 0),
        "expert_bytes_per_device": counts["expert_bytes"],
        "fp8_scales_sharded": (not slab and eng.pool.fp8 and size > 1 and all(
            eng.pool.data[k].shape[3] * size == cfg.n_kv_heads
            for k in ("k_scale", "v_scale"))),
    }
    if slab:
        out.update({k: counts[k] for k in ("state_sharded", "state_total",
                                            "state_leaves")})
        out.update({k: sst[k] for k in ("state_bytes_per_slot",
                                        "state_bytes_per_slot_total")})
    return out


def enc_frames(cfg, n: int, seed: int) -> list[np.ndarray]:
    """``n`` requests' encoder inputs [enc_seq, d] (f32, host side), each
    drawn from its own seed: the encoder-decoder's stub frames."""
    return [torch.randn((cfg.enc_seq, cfg.d_model), generator=torch.Generator()
                        .manual_seed(seed + 10_000 + i)).numpy()
            for i in range(n)]


def run_workload(eng, prompts, gen: int, extras=None):
    """Submit the staggered workload and drain it: half the requests up
    front, the rest one engine step apart (deterministic, so two engines
    fed the same prompts see the same arrivals); ``extras`` holds each
    request's extras (or None).  Returns (rids, outputs)."""
    extras = extras or [None] * len(prompts)
    half = len(prompts) // 2
    rids = [eng.submit(p, gen, extras=e)
            for p, e in zip(prompts[:half], extras[:half])]
    for p, e in zip(prompts[half:], extras[half:]):
        eng.step()
        rids.append(eng.submit(p, gen, extras=e))
    return rids, eng.drain(max_steps=10_000)


def _quiet(*args, **kwargs) -> None:
    """``print`` on every rank but 0."""


def _ms(v) -> str:
    """Seconds as ms; percentiles are None (= "n/a") with no data."""
    return f"{v * 1e3:.1f}ms" if v is not None else "n/a"


def run_engine(cfg, params, qcfg, args, mesh=None) -> dict:
    """Serve the mixed staggered workload through the engine and check it:
    every request finishes, the pool drains with nothing leaked, each
    request's greedy tokens equal a single-request ``serve_batch`` (exact
    prefill, unless ``--no-parity``), and with the prefix cache on the
    same workload with the cache off gives bitwise the same tokens.

    With ``mesh`` (this rank's ``TP``) the engine cuts its tiles from the
    full ``params`` and serves tensor-parallel; ``serve_batch`` runs on
    the full weights, one device, as the oracle.  Rank 0 prints."""
    say = print if mesh is None or mesh.rank == 0 else _quiet
    eng, n_blocks = build_engine(cfg, params, qcfg, args, mesh)
    tp_rep = None
    if mesh is not None:
        tp_rep = tp_shard_report(eng)
        say(f"[engine] tp={mesh.size}: "
            f"packed-sharded={tp_rep['packed_sharded']}/"
            f"{tp_rep['packed_total'] - tp_rep['packed_rule_whole']}"
            + (f" (+{tp_rep['packed_rule_whole']} whole by the rules)"
               if tp_rep["packed_rule_whole"] else "")
            + f" kv-sharded={tp_rep['kv_sharded']} "
            f"weights/device={tp_rep['weight_bytes_per_device']/2**20:.2f}"
            f"MiB (total {tp_rep['weight_bytes_total']/2**20:.2f}MiB) "
            f"kv-pool/device={tp_rep['kv_pool_bytes_per_device']/2**20:.2f}"
            f"MiB"
            + (f" state-sharded={tp_rep['state_sharded']}/"
               f"{tp_rep['state_total']} state/slot/device="
               f"{tp_rep['state_bytes_per_slot']/2**20:.3f}MiB (total "
               f"{tp_rep['state_bytes_per_slot_total']/2**20:.3f}MiB)"
               if eng.pool is None else "")
            + (f" experts-sharded={tp_rep['experts_sharded']} "
               f"experts/device={tp_rep['expert_bytes_per_device']/2**20:.2f}"
               f"MiB" if cfg.n_experts else "")
            + (f" fp8-scales-sharded={tp_rep['fp8_scales_sharded']}"
               if eng.pool is not None and eng.pool.fp8 else ""))
        tp_ok = tp_rep["packed_sharded"] == (tp_rep["packed_total"]
                                             - tp_rep["packed_rule_whole"])
        if not tp_ok:
            say("[engine] FAIL: packed leaves left replicated under TP")
    prompts = mixed_prompts(args.requests, args.min_prompt, args.max_prompt,
                            cfg.vocab_size, args.seed + 1)
    # an encoder-conditioned config takes each request's encoder input;
    # the same frames feed the engine and the parity replay
    extras = [None] * len(prompts)
    if "enc_frames" in getattr(eng.state, "required_extras", ()):
        extras = [{"enc_frames": f} for f in
                  enc_frames(cfg, len(prompts), args.seed)]
    rids, outputs = run_workload(eng, prompts, args.gen, extras)
    st = eng.stats()

    ok = len(outputs) == args.requests
    if not ok:
        say(f"[engine] FAIL: {len(outputs)}/{args.requests} completed")
    ok = ok and (mesh is None or tp_ok)
    leaked = eng.state.leaked()
    if leaked:
        ok = False
        say("[engine] FAIL: " + (f"{eng.pool.active_blocks} pool blocks"
                                  if eng.pool is not None else
                                  f"{st['used_slots']} state slots")
            + " leaked")

    # On the CPU the engine's paged attention and serve_batch's dense cache
    # attention are bitwise equal, so every token must agree.  On the card
    # the paged_attention kernel sums in another order than the dense path
    # (a stated tolerance), and NVFP4 activation rounding amplifies that
    # over a random-weight stack: the first token (the same prefill) must
    # agree, the rest is reported.
    check = (args.parity if args.parity is not None
             else args.prefill_mode == "exact")
    parity = None
    spec_k = getattr(args, "speculative", 0)
    if spec_k and args.parity is not False:
        # the speculative engine's oracle: the plain engine's greedy
        # streams on the same workload, token for token on every device
        plain_args = argparse.Namespace(**vars(args))
        plain_args.speculative = 0
        plain_eng, _ = build_engine(cfg, params, qcfg, plain_args, mesh)
        plain_rids, plain_out = run_workload(plain_eng, prompts, args.gen,
                                             extras)
        empty = np.empty(0, np.int32)
        agree = []
        for rid, prid in zip(rids, plain_rids):
            mine, ref = outputs.get(rid, empty), plain_out.get(prid, empty)
            agree.append(np.array_equal(mine, ref))
            if not agree[-1]:
                say(f"[engine] FAIL: request {rid} diverges from the plain "
                    f"engine: {mine[:8].tolist()} vs {ref[:8].tolist()}")
        parity = all(agree) and len(plain_out) == len(outputs)
        say(f"[engine] speculative streams equal to the plain engine's: "
            f"{sum(agree)}/{len(agree)} requests")
        ok = ok and parity
        check = False
    if check:
        dev = params_device(params)
        strict = dev.type == "cpu"
        agree = []
        # serve_batch on the engine's config (MoE archs: per-row dispatch)
        # and GEMM backend (the fused tier runs MoE expert stacks through
        # the grouped kernel)
        ref_q = dataclasses.replace(qcfg, packed_backend=eng.sq.packed_backend)
        for rid, prompt, ex in zip(rids, prompts, extras):
            ref, _ = serve_batch(eng.cfg, params, torch.from_numpy(
                prompt[None].astype(np.int64)).to(dev), args.gen, qcfg=ref_q,
                extras={k: v[None] for k, v in (ex or {}).items()})
            ref = ref[0].cpu().numpy()
            agree.append(float(np.mean(ref == outputs[rid])))
            if ref[0] != outputs[rid][0] or (strict and agree[-1] < 1.0):
                say(f"[engine] FAIL: request {rid} diverges from "
                    f"serve_batch: {outputs[rid][:8].tolist()} vs "
                    f"{ref[:8].tolist()}")
                parity = False
        parity = parity is None
        say(f"[engine] tokens equal to single-request serve_batch: "
            f"{float(np.mean(agree)):.3f} of positions "
            f"({'all tokens' if strict else 'first tokens'} gated)")
        ok = ok and parity

    cache_parity = None
    if args.prefix_cache == "on" and args.parity is not False:
        base_args = argparse.Namespace(**vars(args))
        base_args.prefix_cache = "off"
        base_eng, _ = build_engine(cfg, params, qcfg, base_args, mesh)
        base_rids, base_out = run_workload(base_eng, prompts, args.gen,
                                           extras)
        cache_parity = len(base_out) == len(outputs)
        empty = np.empty(0, np.int32)
        for rid, brid in zip(rids, base_rids):
            if not np.array_equal(outputs.get(rid, empty),
                                  base_out.get(brid, empty)):
                cache_parity = False
                say(f"[engine] FAIL: request {rid} cache-on diverges from "
                    f"cache-off: {outputs.get(rid, empty)[:8].tolist()} vs "
                    f"{base_out.get(brid, empty)[:8].tolist()}")
        if base_eng.state.leaked():
            cache_parity = False
            say("[engine] FAIL: cache-off baseline leaked pool blocks")
        ok = ok and cache_parity

    pool_desc = (f"pool={n_blocks}x{args.block_size}" if eng.pool is not None
                 else f"state-slabs={st['state_bytes_per_slot']}B/slot")
    say(f"[engine] arch={cfg.name} device={eng.device} "
        f"state-plan={'+'.join(eng.state_plan)} "
        f"requests={args.requests} "
        f"prompts={args.min_prompt}..{args.max_prompt} gen={args.gen} "
        f"slots={args.slots} {pool_desc} "
        f"prefill={args.prefill_mode} kv-alloc={args.kv_alloc} "
        f"fused-kernels={'on' if st['fused_kernels'] else 'off'}"
        + (" kv=fp8" if st.get("fp8") else "")
        + (f" moe-dispatch={st['moe_dispatch']}/{st['packed_backend']}"
           if st["moe_dispatch"] else "")
        + (f" speculative=k{spec_k}/{args.draft}" if spec_k else ""))
    say(f"[engine] decode={st['decode_tok_s']:.1f} tok/s "
        f"e2e={st['e2e_tok_s']:.1f} tok/s "
        f"peak-pool-util={st['peak_utilization']:.2f} "
        f"steps={st['steps']} decode-steps={st['decode_steps']} "
        f"ttft_p50={_ms(st['ttft_p50_s'])} "
        f"ttft_p95={_ms(st['ttft_p95_s'])} "
        f"tok_lat_p50={_ms(st['decode_lat_p50_s'])} "
        f"tok_lat_p95={_ms(st['decode_lat_p95_s'])} "
        f"parity={'AGREE' if parity else ('skipped' if parity is None else 'DISAGREE')} "
        f"{'pool' if eng.pool is not None else 'state'}-drained={not leaked}")
    if spec_k:
        adaptive = (f" chosen-k={st['chosen_k_hist']}"
                    if st.get("adaptive_k") else "")
        acc, aps = st["acceptance_rate"], st["accepted_per_step"]
        say(f"[engine] speculative: "
            f"acceptance={f'{acc:.3f}' if acc is not None else 'n/a'} "
            f"accepted/step={f'{aps:.2f}' if aps is not None else 'n/a'} "
            f"drafted={st['drafted_tokens']} "
            f"rolled-back={st['rolled_back_tokens']} "
            f"verify-steps={st['verify_steps']}{adaptive}")
    cache_st = None
    if args.prefix_cache == "on":
        cache_st = st.get("prefix_cache") or {}
        cp = ("AGREE" if cache_parity
              else ("skipped" if cache_parity is None else "DISAGREE"))
        say(f"[engine] prefix-cache: hits={cache_st.get('hits', 0)} "
            f"misses={cache_st.get('misses', 0)} "
            f"evictions={cache_st.get('evictions', 0)} "
            f"preempts={st['preempts']} cache-off-parity={cp}")
    report_obs(eng, args, say, write=mesh is None or mesh.rank == 0)
    return {"ok": ok, "outputs": outputs, "rids": rids, "prompts": prompts,
            "stats": st, "tokens_match_serve_batch": parity,
            "tokens_match_cache_off": cache_parity, "n_blocks": n_blocks,
            "pool_drained": not leaked, "prefix_cache": cache_st,
            "obs": eng.obs.enabled}


def report_obs(eng, args, say=print, write: bool = True) -> None:
    """The ``[numerics]`` line (shadow teacher on) and the ``[metrics]``
    lines (telemetry on); with ``write`` the ``--metrics-out`` and
    ``--trace-out`` files."""
    if eng.numerics is not None:
        ns = eng.numerics.summary()
        kl_pts = ns["series"].get("qad_live_kl", [])
        kl_s = f"{kl_pts[-1][1]:.4f}" if kl_pts else "n/a"
        sq = ns["sqnr_db_min"]
        sq_s = f"{sq:.1f}dB" if sq is not None else "n/a"
        say(f"[numerics] shadow-steps={eng.shadow_steps} "
            f"rate=1/{eng._shadow_every} "
            f"records={ns['sampled_records']} "
            f"live_kl={kl_s} sqnr_min={sq_s}")
    if not eng.obs.enabled:
        return
    from ..obs import export as obs_export
    qw = eng.obs.metrics.get("serve_queue_wait_seconds")
    gemms = eng.obs.metrics.get("qeinsum_dispatch_total")
    backends = ""
    if gemms is not None:
        backends = " qeinsum=" + ",".join(
            f"{e['labels']['backend']}:{int(e['value'])}"
            for e in gemms.snapshot().get("labels", []))
    say(f"[metrics] enabled "
        f"queue_wait_p50={_ms(qw.percentile(50) if qw else None)}"
        f"{backends} "
        f"trace_events={len(eng.obs.trace.events)}")
    if write and getattr(args, "metrics_out", None):
        obs_export.write_metrics(eng, args.metrics_out)
        say(f"[metrics] wrote {args.metrics_out} (+ .prom)")
    if write and getattr(args, "trace_out", None):
        obs_export.write_trace(eng, args.trace_out)
        say(f"[metrics] wrote {args.trace_out}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (--no-smoke = full size)")
    ap.add_argument("--weight-format", choices=("qdq", "packed"),
                    default="qdq")
    ap.add_argument("--parity", action=argparse.BooleanOptionalAction,
                    default=None, help="packed mode: also serve the QDQ "
                    "weights and compare greedy tokens (default: on)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--device", default="cuda")
    # --- continuous-batching engine ---
    ap.add_argument("--engine", action="store_true",
                    help="serve a mixed-length staggered workload through "
                    "the continuous-batching engine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="pool blocks (0 = slots * blocks-per-request)")
    ap.add_argument("--prefill-mode", choices=("exact", "chunked", "paged"),
                    default="exact",
                    help="exact = whole-prompt prefill (token parity with "
                    "serve_batch); chunked = fixed-size chunks of "
                    "--prefill-chunk tokens (approximate: chunk-granular "
                    "activation amaxes); paged = block-granular prefill "
                    "through the pool, whose blocks depend only on their "
                    "token prefix (what prefix caching and preemption need)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="chunk size of --prefill-mode chunked")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="off",
                    help="content-hashed prefix cache over the pool; forces "
                    "--prefill-mode paged and (unless --kv-alloc says "
                    "otherwise) on-demand allocation, and checks the "
                    "tokens against a cache-off run")
    ap.add_argument("--kv-alloc", choices=("reserve", "ondemand"),
                    default=None,
                    help="'reserve' books the worst-case blocks at "
                    "admission; 'ondemand' books the prompt's and grows, "
                    "evicting cache entries and then preempting the "
                    "lowest-progress request (default: ondemand with the "
                    "prefix cache, else reserve)")
    ap.add_argument("--headroom", type=int, default=2,
                    help="on-demand admission watermark in blocks")
    ap.add_argument("--fused-kernels", choices=("on", "off", "auto"),
                    default="auto",
                    help="paged attention through the paged_attention "
                    "kernel (on, or auto) or the gather-then-attend "
                    "two-step (off)")
    # --- speculative decoding (repro_torch.spec, engine mode only) ---
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="draft length k per verify step (0 = off); greedy "
                    "output must equal the plain engine's token for token")
    ap.add_argument("--draft", choices=("self-qdq", "self-truncate",
                                        "two-model"), default="self-qdq",
                    help="draft proposer: the target's own forward, its "
                    "first --draft-layers layers, or a separate small "
                    "model (seed 99)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="draft depth for self-truncate / two-model "
                    "(0 = half the target's layers)")
    ap.add_argument("--adaptive-k", action="store_true",
                    help="draft-cost-aware per-slot draft length: adapt k "
                    "from the measured acceptance rate and draft/verify "
                    "wall clock (requires --speculative)")
    # --- observability (repro_torch.obs, engine mode) ---
    ap.add_argument("--obs", choices=("off", "metrics", "trace"),
                    default="off",
                    help="serving telemetry: 'metrics' = counters/gauges/"
                    "latency histograms + dispatch counts; 'trace' adds the "
                    "request-lifecycle tracer (Chrome-trace export). "
                    "Greedy tokens are bitwise identical in every mode")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the repro.obs.metrics/v1 JSON snapshot here "
                    "(plus Prometheus text at the sibling .prom path); "
                    "implies at least --obs metrics")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Chrome-trace/Perfetto JSON here; "
                    "implies --obs trace")
    ap.add_argument("--shadow-rate", type=float, default=0.0, metavar="R",
                    help="shadow-teacher sampling rate: on about R of the "
                    "decode steps, re-forward each running request's "
                    "context through the BF16 teacher and the quantized "
                    "student and record live KL / top-1 agreement plus "
                    "per-layer divergence and quant-error stats (0 = off; "
                    "stateless, token streams are unchanged)")
    ap.add_argument("--inject-quant-noise", type=float, default=0.0,
                    metavar="SCALE",
                    help="canary: perturb every packed weight's per-tensor "
                    "scale by (1 + SCALE) so the numerics gate has a fault "
                    "to trip on (requires --weight-format packed)")
    # --- tensor parallelism (engine mode) ---
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel degree: N ranks, one process "
                    "each, in a gloo group on --device; packed GEMMs split "
                    "column- and row-parallel, the KV pool by KV heads")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if (args.prefix_cache == "on" or args.kv_alloc) and not args.engine:
        raise SystemExit("--prefix-cache/--kv-alloc require --engine (they "
                         "configure the paged serving pool)")
    if args.speculative and not args.engine:
        raise SystemExit("--speculative requires --engine (speculative "
                         "decoding is an engine path)")
    if args.adaptive_k and not args.speculative:
        raise SystemExit("--adaptive-k requires --speculative K (it adapts "
                         "the draft length)")
    if (args.obs != "off" or args.metrics_out or args.trace_out) \
            and not args.engine:
        raise SystemExit("--obs/--metrics-out/--trace-out require --engine "
                         "(telemetry instruments the serving engine)")
    if args.shadow_rate and not args.engine:
        raise SystemExit("--shadow-rate requires --engine (the shadow "
                         "teacher samples the engine's decode loop)")
    if args.inject_quant_noise and args.weight_format != "packed":
        raise SystemExit("--inject-quant-noise perturbs PackedNVFP4 "
                         "tensor scales; use --weight-format packed")
    device = resolve_device(args.device)
    if args.tp > 1:
        if not args.engine:
            raise SystemExit("--tp requires --engine (TP serving is an "
                             "engine path)")
        from .mesh import spawn
        print(f"[serve] tp={args.tp} mesh={{'data': 1, 'model': {args.tp}}} "
              f"(gloo, {args.tp} processes on {device})")
        res = spawn(_engine_rank, args.tp, args, device=device)
        if not all(r["ok"] for r in res):
            raise SystemExit(1)
        return res[0]
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    params, qcfg = load_quantized(cfg, args.seed, args.weight_format, device)
    if args.inject_quant_noise:
        params = inject_quant_noise(params, args.inject_quant_noise)
        print(f"[serve] CANARY: packed tensor scales perturbed by "
              f"{args.inject_quant_noise:+.0%}")
    wr = weight_report(params)
    if wr["q_params"]:
        print(f"[serve] weights: total={wr['total_bytes']/2**20:.2f}MiB  "
              f"quantized-gemm={wr['q_bytes']/2**20:.2f}MiB over "
              f"{wr['q_params']/1e6:.2f}M params "
              f"({wr['q_bytes_per_param']:.4f} B/param; bf16 would be 2.0)")
    else:
        print(f"[serve] weights: total={wr['total_bytes']/2**20:.2f}MiB, "
              f"all dense (qdq stores quantized values as BF16, 2 B/param)")

    if args.engine:
        from ..serve import UnsupportedStateError
        try:
            res = run_engine(cfg, params, qcfg, args)
        except UnsupportedStateError as e:
            # the capability check said no (M-RoPE's vision_prefix): one
            # line, no traceback
            raise SystemExit(f"[serve] unsupported: {e}") from None
        res["weights"] = wr
        if not res["ok"]:
            raise SystemExit(1)
        return res

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(4, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    toks, stats = serve_batch(cfg, params, prompts, args.gen)
    print(f"[serve] arch={cfg.name} device={device} batch={args.batch} "
          f"format={args.weight_format} "
          f"prefill={stats['prefill_s']*1e3:.1f}ms "
          f"decode={stats['decode_tok_s']:.1f} tok/s "
          f"e2e={stats['e2e_tok_s']:.1f} tok/s")
    print("[serve] sample:", toks[0, :12].tolist())

    result = {"tokens": toks, "stats": stats, "weights": wr}
    parity = (args.weight_format == "packed"
              if args.parity is None else args.parity)
    if parity and args.weight_format != "packed":
        print("[serve] --parity only applies to --weight-format packed; "
              "nothing to compare")
    elif parity:
        del params
        qdq_params, _ = load_quantized(cfg, args.seed, "qdq", device)
        ref_toks, _ = serve_batch(cfg, qdq_params, prompts, args.gen)
        match = bool(torch.equal(toks, ref_toks))
        print(f"[serve] packed-vs-qdq greedy tokens "
              f"{'AGREE' if match else 'DISAGREE'}")
        result["tokens_match_qdq"] = match
    return result


def _engine_rank(tp, args) -> dict:
    """One rank of ``--tp``: the full weights (the oracle's), the engine
    over this rank's tiles, the checks of ``run_engine``."""
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    params, qcfg = load_quantized(cfg, args.seed, args.weight_format, tp.device)
    if args.inject_quant_noise:
        params = inject_quant_noise(params, args.inject_quant_noise)
    return run_engine(cfg, params, qcfg, args, mesh=tp)


if __name__ == "__main__":
    main()
