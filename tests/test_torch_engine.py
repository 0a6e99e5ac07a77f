"""Engine slice of the PyTorch port against the JAX package, on the CPU.

The reference runs once per module in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false``, as in ``test_torch_serve.py``: with
XLA's default the compiled reference keeps some bf16 intermediates in f32,
and its own engine then parts from its own ``serve_batch`` on the qdq
smoke model (``tests/test_engine.py::
test_engine_mixed_workload_matches_serve_batch[qdq]``).  With it off, the
reference engine agrees with its ``serve_batch`` on both weight formats.

Parity levels, as each test names them:

  * **bitwise**, the paged-attention kernel's plain version (K7) against
    the reference's Pallas kernel (interpret mode) on the reference's own
    cases (``tests/test_fused_kernels.py``), and the port's two-step
    ``paged_attend`` against K7's plain version.  The stated tolerance was
    one bf16 ulp; on this CPU every case is bitwise, so the tests hold
    them to that;
  * **tolerance**, ``decode_step_paged`` / ``verify_step_paged`` logits
    against the jitted reference, rtol = atol = 1e-2 (the serving slice's
    logit tolerance);
  * **greedy tokens**, the engine on the reference's mixed workload
    against the reference's engine and the port's ``serve_batch``;
  * **bitwise**, the pool's bookkeeping step by step (block tables, free,
    used and cached counts, preemptions, prefix-cache hits, misses and
    evictions) under on-demand paging, prefix caching and preemption.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import ptq
from repro_torch.kernels import ops, ref as kref
from repro_torch.launch import serve, specs
from repro_torch.models import attention as attn
from repro_torch.models import decoder, get_model
from repro_torch.serve import Engine
from test_torch_serve import _flat, _unflat

ARCH = "qwen1.5-0.5b"
MIXED_LENS = [4, 6, 7, 9, 11, 13, 14, 16]
GEN = 5
BS = 8
LOGIT_TOL = 1e-2
# (name, (b, mb, bs, hkv, n_rep, hd), s_q, window, fp8): the cases of
# tests/test_fused_kernels.py, lines 68-115
K7_CASES = (
    [(f"decode{i}", shape, 1, 0, False) for i, shape in enumerate(
        [(3, 4, 16, 2, 4, 64), (2, 2, 8, 4, 1, 32), (1, 8, 16, 1, 2, 128),
         (4, 3, 16, 3, 2, 48)])]
    + [(f"verify{s}", (3, 4, 16, 2, 2, 64), s, 0, False) for s in (2, 4, 5)]
    + [(f"window{w}_s{s}", (2, 4, 16, 2, 2, 64), s, w, False)
       for w in (8, 16, 40) for s in (1, 3)]
    + [(f"fp8_s{s}", (3, 3, 16, 2, 3, 64), s, 0, True) for s in (1, 4)]
    + [("dead_tail", (2, 4, 8, 2, 2, 32), 1, 0, False)])
# step-logit archs: MHA (qwen) and GQA (acereason)
STEP_ARCHS = ["qwen1.5-0.5b", "acereason-7b"]


def _k7_inputs(i, b, mb, bs, hkv, n_rep, hd, s_q):
    """f32 q, k, v; block tables; per-query positions (numpy)."""
    rng = np.random.default_rng(100 + i)
    n_blocks = b * mb + 2
    k = rng.standard_normal((n_blocks, bs, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, hkv, hd)).astype(np.float32)
    bt = rng.permutation(n_blocks)[: b * mb].reshape(b, mb).astype(np.int32)
    base = rng.integers(s_q, mb * bs + 1, (b,))
    pos = (base if s_q == 1 else
           base[:, None] - s_q + 1 + np.arange(s_q)[None, :]).astype(np.int32)
    q = rng.standard_normal((b, s_q, hkv * n_rep, hd)).astype(np.float32)
    return q, k, v, bt, pos


def _mixed_prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in MIXED_LENS]


def _shared_prompts(vocab, n, seed=7):
    """Mixed-length prompts, most of them sharing a one-block head
    (``tests/test_prefix_cache.py::_shared_prompts``)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(4, vocab, (BS,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(4, vocab, (2 + i % 5,)).astype(np.int32)
        out.append(np.concatenate([head, tail]) if i % 5 else tail)
    return out


# engine settings of the bookkeeping runs: the pool too small for the
# workload (preemption), and roomy (no preemption); gen 12
PAGED_RUNS = {
    "tight": dict(prefix_cache=True, kv_alloc="ondemand", headroom=0,
                  n_slots=3, n_blocks=6, max_blocks_per_slot=4),
    "roomy": dict(prefix_cache=True, kv_alloc="ondemand", n_slots=3,
                  n_blocks=16, max_blocks_per_slot=4),
    "cache_off": dict(prefix_cache=False, kv_alloc="ondemand", n_slots=2,
                      n_blocks=8, max_blocks_per_slot=4),
}
PAGED_GEN = 12


def _staggered(eng, prompts, gen, trace=None):
    """Half the requests up front, the rest one step apart; ``trace``
    collects the pool's bookkeeping after every step."""
    def step():
        eng.step()
        if trace is not None:
            trace.append(_bookkeeping(eng))
    rids = [eng.submit(p, gen) for p in prompts[: len(prompts) // 2]]
    for p in prompts[len(prompts) // 2:]:
        step()
        rids.append(eng.submit(p, gen))
    while eng.sched.has_work():
        step()
    return rids, eng.outputs()


def _bookkeeping(eng):
    pool, cache = eng.pool, eng.state.cache
    tables = [list(r.block_ids) if r is not None else None
              for r in eng.sched.slots]
    c = (cache.hits, cache.misses, cache.evictions) if cache else ()
    return [pool.free_blocks, pool.used_blocks, pool.cached_blocks,
            pool.active_blocks, pool.shared_blocks, eng.preempts, tables,
            [r.rid for r in eng.sched.waiting], *c]


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import json

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import nvfp4 as jnvfp4
    from repro.kernels import ops as jops
    from repro.launch import serve as jserve
    from repro.models import decoder as jdecoder
    from repro.models import get_model as jget_model
    from repro.serve import Engine as JEngine

    res = {}
    bf16 = jnp.bfloat16
    for i, (name, (b, mb, bs, hkv, n_rep, hd), s_q, window, fp8) in \
            enumerate(K7_CASES):
        q, k, v, bt, pos = _k7_inputs(i, b, mb, bs, hkv, n_rep, hd, s_q)
        if name == "dead_tail":
            pos = np.minimum(pos, 9)
        if fp8:
            kq = jnvfp4.fp8_quantize(jnp.asarray(k), axis=-1)
            vq = jnvfp4.fp8_quantize(jnp.asarray(v), axis=-1)
            pool = {"k": kq.values, "v": vq.values,
                    "k_scale": kq.scale[..., 0], "v_scale": vq.scale[..., 0]}
        else:
            pool = {"k": jnp.asarray(k).astype(bf16),
                    "v": jnp.asarray(v).astype(bf16)}
        out = jops.paged_attention(jnp.asarray(q).astype(bf16), pool,
                                   jnp.asarray(bt), jnp.asarray(pos),
                                   window=window)
        for key, a in pool.items():
            res[f"k7/{name}/{key}"] = np.asarray(a.astype(jnp.float32))
        res[f"k7/{name}/pos"] = pos
        res[f"k7/{name}/out"] = np.asarray(out.astype(jnp.float32))

    for arch in dict.fromkeys(STEP_ARCHS + [ARCH]):
        cfg = jconfigs.get_smoke(arch)
        dense = jget_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
        for key, a in _flat(dense).items():
            res[f"{arch}/params/{key}"] = np.asarray(a.astype(jnp.float32))

    # paged decode and verify steps, fused (Pallas) and not
    for arch in STEP_ARCHS:
        cfg = jconfigs.get_smoke(arch)
        params, qcfg = jserve.load_quantized(cfg, jax.random.PRNGKey(0),
                                             "packed")
        sq = dataclasses.replace(qcfg, quantize_weights=False,
                                 act_scope="row")
        psq = dataclasses.replace(sq, act_scope="token")
        st = _step_inputs(cfg.vocab_size)
        for fused in (True, False):
            pool = jdecoder.init_paged_pool(cfg, 8, BS)
            for p, ids in zip(st["prompts"], st["prompt_blocks"]):
                _, cache = jdecoder.prefill(cfg, params,
                                            {"tokens": jnp.asarray(p[None])},
                                            sq, None)
                cache = {k: v for k, v in cache.items() if k != "pos"}
                pool = jdecoder.write_prompt_to_pool(pool, cache,
                                                     jnp.asarray(ids))
            dec = jax.jit(lambda pr, po, *a: jdecoder.decode_step_paged(
                cfg, pr, po, *a[:3], {"tokens": a[3]}, sq, fused=fused))
            lg, pool = dec(params, pool, jnp.asarray(st["bt"]),
                           jnp.asarray(st["lens"]), jnp.asarray(st["active"]),
                           jnp.asarray(st["dec_toks"]))
            res[f"steps/{arch}/{fused}/decode"] = np.asarray(lg.astype(jnp.float32))
            ver = jax.jit(lambda pr, po, *a: jdecoder.verify_step_paged(
                cfg, pr, po, *a[:4], {"tokens": a[4]}, psq, fused=fused))
            lg, pool = ver(params, pool, jnp.asarray(st["bt"]),
                           jnp.asarray(st["lens"] + 1),
                           jnp.asarray(st["active"]),
                           jnp.asarray(st["n_prop"]),
                           jnp.asarray(st["ver_toks"]))
            res[f"steps/{arch}/{fused}/verify"] = np.asarray(lg.astype(jnp.float32))

    # the engine on the mixed workload, and single-request serve_batch
    cfg = jconfigs.get_smoke(ARCH)
    prompts = _mixed_prompts(cfg.vocab_size)
    for fmt in ("qdq", "packed"):
        params, qcfg = jserve.load_quantized(cfg, jax.random.PRNGKey(0), fmt)
        eng = JEngine(cfg, params, qcfg, n_slots=4, block_size=BS,
                      max_blocks_per_slot=4, n_blocks=16)
        rids = [eng.submit(p, GEN) for p in prompts[:4]]
        eng.step()
        rids += [eng.submit(p, GEN) for p in prompts[4:]]
        outs = eng.drain(max_steps=500)
        res[f"engine/{fmt}"] = np.stack([outs[r] for r in rids])
        res[f"serve_batch/{fmt}"] = np.stack([np.asarray(jserve.serve_batch(
            cfg, params, jnp.asarray(p[None]), GEN, qcfg=qcfg)[0][0])
            for p in prompts])

    # bookkeeping of paged prefill, on-demand paging, the prefix cache and
    # preemption, step by step
    params, qcfg = jserve.load_quantized(cfg, jax.random.PRNGKey(0), "packed")
    prompts = _shared_prompts(cfg.vocab_size, 8)
    traces = {}
    for run, kw in PAGED_RUNS.items():
        eng = JEngine(cfg, params, qcfg, block_size=BS, prefill_mode="paged",
                      **kw)
        trace = []
        rids, outs = _staggered(eng, prompts, PAGED_GEN, trace)
        traces[run] = trace
        res[f"paged/{run}"] = np.stack([outs[r] for r in rids])
    res["paged/traces"] = np.frombuffer(json.dumps(traces).encode(), np.uint8)
    np.savez(out_path, **res)


def _step_inputs(vocab):
    """Two prompts written to the pool by exact prefill, then one decode
    step and one verify step over three slots (the third inactive)."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(4, vocab, (n,)).astype(np.int32) for n in (11, 5)]
    bt = np.zeros((3, 4), np.int32)
    bt[0, :2] = [3, 5]
    bt[1, :1] = [1]
    return {"prompts": prompts, "prompt_blocks": [[3, 5], [1]], "bt": bt,
            "lens": np.asarray([11, 5, 0], np.int32),
            "active": np.asarray([True, True, False]),
            "dec_toks": rng.integers(4, vocab, (3, 1)).astype(np.int32),
            "ver_toks": rng.integers(4, vocab, (3, 3)).astype(np.int32),
            "n_prop": np.asarray([2, 1, 0], np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_engine_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = ("import test_torch_engine as t; "
            f"t._reference({out!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _port(ref, arch, fmt):
    """(cfg, params, qcfg): the reference's init bridged, the port's PTQ."""
    cfg = configs.get_smoke(arch)
    dense = params_from_numpy(_unflat(ref, f"{arch}/params/"), "cpu")
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format=fmt)
    return cfg, ptq.quantize_weights(dense, get_model(cfg).param_specs(cfg), qc), qc


def _k7_port_inputs(ref, i):
    name, (b, mb, bs, hkv, n_rep, hd), s_q, window, fp8 = K7_CASES[i]
    q, _, _, bt, _ = _k7_inputs(i, b, mb, bs, hkv, n_rep, hd, s_q)
    dt = torch.float8_e4m3fn if fp8 else torch.bfloat16
    pool = {key: torch.from_numpy(ref[f"k7/{name}/{key}"]).to(
        dt if key in ("k", "v") else torch.float32)
        for key in (("k", "v", "k_scale", "v_scale") if fp8 else ("k", "v"))}
    return (torch.from_numpy(q).to(torch.bfloat16), pool,
            torch.from_numpy(bt), torch.from_numpy(ref[f"k7/{name}/pos"]),
            window)


@pytest.mark.parametrize("i", range(len(K7_CASES)),
                         ids=[c[0] for c in K7_CASES])
def test_k7_plain_matches_reference_kernel(ref, i):
    """Bitwise: K7's plain version against the reference's Pallas kernel
    (interpret mode) on the same pages, tables and positions; a window
    below the context must change the output."""
    q, pool, bt, pos, window = _k7_port_inputs(ref, i)
    got = kref.paged_attention_ref(q, pool, bt, pos, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref[f"k7/{K7_CASES[i][0]}/out"])
    if 0 < window < 40:
        assert not torch.equal(got, kref.paged_attention_ref(q, pool, bt, pos))


@pytest.mark.parametrize("i", range(len(K7_CASES)),
                         ids=[c[0] for c in K7_CASES])
def test_k7_plain_matches_two_step(ref, i):
    """Bitwise: the port's ``paged_attend`` two-step (gather, repeat_kv,
    ``torch.softmax``) against K7's plain version (grouped heads, explicit
    max / exp / sum / division); the op on CPU tensors is the plain
    version and launches nothing."""
    q, pool, bt, pos, window = _k7_port_inputs(ref, i)
    ops.reset_launches()
    want = attn.paged_attend_fused(q, pool, bt, pos, window=window)
    assert ops.launches["paged_attention"] == 0
    assert torch.equal(want, kref.paged_attention_ref(q, pool, bt, pos,
                                                      window=window))
    assert torch.equal(attn.paged_attend(q, pool, bt, pos, window=window), want)


def test_k7_plain_ignores_dead_table_tail(ref):
    """Bitwise: pages past every query's pos do not reach the output,
    whatever they hold."""
    i = [c[0] for c in K7_CASES].index("dead_tail")
    q, pool, bt, pos, _ = _k7_port_inputs(ref, i)
    want = kref.paged_attention_ref(q, pool, bt, pos)
    live = torch.zeros(pool["k"].shape[0], dtype=torch.bool)
    live[bt[:, :2].reshape(-1).long()] = True          # blocks of pos < 16
    noise = (1e3 * torch.randn(pool["k"].shape, generator=torch.Generator()
                               .manual_seed(6))).to(torch.bfloat16)
    dead = ~live[:, None, None, None]
    poisoned = {n: torch.where(dead, noise, a) for n, a in pool.items()}
    assert torch.equal(kref.paged_attention_ref(q, poisoned, bt, pos), want)


@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("fused", [True, False])
def test_paged_step_logits_match(ref, arch, fused):
    """Tolerance: ``decode_step_paged`` then ``verify_step_paged`` logits
    against the jitted reference over the same pool, rtol 1e-2 (the
    inactive slot and the verify padding tail carry no contract)."""
    cfg, params, qcfg = _port(ref, arch, "packed")
    sq = dataclasses.replace(qcfg, quantize_weights=False, act_scope="row")
    psq = dataclasses.replace(sq, act_scope="token")
    st = _step_inputs(cfg.vocab_size)
    t = torch.from_numpy
    pool = decoder.init_paged_pool(cfg, 8, BS, "cpu")
    with torch.inference_mode():
        for p, ids in zip(st["prompts"], st["prompt_blocks"]):
            _, cache = decoder.prefill(cfg, params,
                                       {"tokens": t(p[None]).long()}, sq, None)
            decoder.write_prompt_to_pool(pool, cache, ids)
        lg, pool = decoder.decode_step_paged(
            cfg, params, pool, t(st["bt"]), t(st["lens"]), t(st["active"]),
            {"tokens": t(st["dec_toks"]).long()}, sq, fused=fused)
        want = ref[f"steps/{arch}/{fused}/decode"]
        np.testing.assert_allclose(lg[:2].float().numpy(), want[:2],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        lg, pool = decoder.verify_step_paged(
            cfg, params, pool, t(st["bt"]), t(st["lens"] + 1), t(st["active"]),
            t(st["n_prop"]), {"tokens": t(st["ver_toks"]).long()}, psq,
            fused=fused)
    want = ref[f"steps/{arch}/{fused}/verify"]
    for row, n_prop in enumerate(st["n_prop"][:2]):
        np.testing.assert_allclose(lg[row, : n_prop + 1].float().numpy(),
                                   want[row, : n_prop + 1],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("fmt", ["qdq", "packed"])
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_engine_mixed_workload_tokens(ref, fmt, fused):
    """Greedy tokens: mixed prompt lengths (4x spread), staggered arrivals,
    exact prefill; every request equals the reference engine's output and
    the port's single-request ``serve_batch``; the pool drains."""
    cfg, params, qcfg = _port(ref, ARCH, fmt)
    prompts = _mixed_prompts(cfg.vocab_size)
    eng = Engine(cfg, params, qcfg, n_slots=4, block_size=BS,
                 max_blocks_per_slot=4, n_blocks=16, fused_kernels=fused,
                 device="cpu")
    assert eng.fused == (fused == "auto")
    rids = [eng.submit(p, GEN) for p in prompts[:4]]
    eng.step()
    rids += [eng.submit(p, GEN) for p in prompts[4:]]
    outs = eng.drain(max_steps=500)
    got = np.stack([outs[r] for r in rids])
    np.testing.assert_array_equal(got, ref[f"engine/{fmt}"])
    np.testing.assert_array_equal(got, ref[f"serve_batch/{fmt}"])
    for row, p in zip(got, prompts):
        toks, _ = serve.serve_batch(cfg, params, torch.from_numpy(p[None]).long(),
                                    GEN, qcfg=qcfg)
        np.testing.assert_array_equal(toks[0].numpy(), row)
    assert eng.pool.used_blocks == 0 and not eng.state.leaked()
    assert eng.stats()["decode_steps"] > 0


@pytest.fixture(scope="module")
def port_paged(ref):
    """The port's engine on each bookkeeping run: (trace, tokens, engine)."""
    cfg, params, qcfg = _port(ref, ARCH, "packed")
    prompts = _shared_prompts(cfg.vocab_size, 8)
    out = {}
    for run, kw in PAGED_RUNS.items():
        eng = Engine(cfg, params, qcfg, block_size=BS, prefill_mode="paged",
                     device="cpu", **kw)
        trace = []
        rids, outs = _staggered(eng, prompts, PAGED_GEN, trace)
        out[run] = (trace, np.stack([outs[r] for r in rids]), eng)
    return out


@pytest.mark.parametrize("run", list(PAGED_RUNS))
def test_paged_engine_bookkeeping_bitwise(ref, port_paged, run):
    """Bitwise: paged prefill, on-demand paging, the prefix cache and
    preemption keep the reference's books step by step (block tables,
    free / used / cached / active / shared counts, preemptions, the queue,
    cache hits, misses, evictions), and give its greedy tokens."""
    import json

    trace, toks, eng = port_paged[run]
    want = json.loads(ref["paged/traces"].tobytes().decode())[run]
    assert trace == want
    np.testing.assert_array_equal(toks, ref[f"paged/{run}"])
    assert not eng.state.leaked()
    if run == "tight":
        assert eng.preempts > 0
    else:
        assert eng.preempts == 0
    if eng.state.cache is not None:
        assert eng.state.cache.hits > 0


def test_preemption_and_cache_leave_tokens_unchanged(port_paged):
    """Greedy tokens, bitwise: the run that preempts gives every request
    the tokens of the roomy run, and the cache-on runs those of the
    cache-off run."""
    tight, roomy, off = (port_paged[r][1] for r in ("tight", "roomy",
                                                     "cache_off"))
    np.testing.assert_array_equal(tight, roomy)
    np.testing.assert_array_equal(roomy, off)
