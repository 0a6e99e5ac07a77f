"""Chunked prefill (``decoder.prefill_chunk_paged`` and the engine's
``prefill_mode="chunked"``) and the windowed blockwise attention it runs,
in the PyTorch port against the JAX package, on the CPU.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (see ``test_torch_serve.py``) on
numpy-seeded inputs and its own ``init_params``, bridged to the port.

Parity levels, as each test names them:

  * **tolerance**: ``blockwise_attention`` with a window, a query offset
    and a valid-key count against the reference's, within one bf16 ulp
    (the f32 sums run in another order);
  * **tolerance**: ``prefill_chunk_paged``'s last-position logits at
    chunks of 4, 8 and 16 over a 16-token prompt against the jitted
    reference, rtol = atol = 1e-2 (the serving slice's logit tolerance),
    and the pool's KV after the last chunk within one bf16 ulp;
  * **bitwise**: a chunk that is the whole prompt gives exact prefill's
    logits (the same activation amaxes, the masked scratch tail adding
    exactly nothing), as ``tests/test_engine.py`` asserts for the
    reference;
  * **greedy tokens**: the engine in chunked mode on a mixed workload
    against the reference's engine in chunked mode; the scheduler's
    invariants under a budget smaller than a chunk.
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
from repro_torch.launch import specs
from repro_torch.models import attention as attn
from repro_torch.models import common, decoder, get_model
from repro_torch.serve import Engine
from test_torch_serve import _flat, _unflat

ARCHS = ["qwen1.5-0.5b", "acereason-7b"]      # MHA and GQA
# (arch, weight format): acereason in the serving format only
CASES = [("qwen1.5-0.5b", "qdq"), ("qwen1.5-0.5b", "packed"),
         ("acereason-7b", "packed")]
P_LEN, BS, S_ALLOC = 16, 8, 32
CHUNKS = (4, 8, 16)
TOL = 1e-2
# the engine's mixed workload: (prompt lengths, chunk, budget)
MIXED = ([4, 9, 16, 13, 7, 20], 8, None)
TIGHT = ([4, 9, 16, 13], 4, 6)
GEN = 5
# blockwise attention cases: (name, sq, sk, window, q_offset, kv_valid)
ATT_CASES = [("plain", 12, 12, 0, 0, None), ("window", 12, 12, 5, 0, None),
             ("offset", 6, 20, 0, 9, 15), ("offset_window", 6, 20, 4, 9, 15)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _att_inputs(i, sq, sk):
    rng = np.random.default_rng(60 + i)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    return q, k, v


def _prompt(vocab):
    return np.random.default_rng(23).integers(4, vocab, (P_LEN,)).astype(np.int32)


def _workload(vocab, lens, seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in lens]


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import attention as jattn
    from repro.models import common as jcommon
    from repro.models import decoder as jdecoder
    from repro.serve import Engine as JEngine

    def f32(a):
        return np.asarray(a).astype(np.float32)

    def port_ptq(arch, dense, fmt):
        """The port's PTQ of ``dense`` as the reference's tree (bitwise the
        reference's PTQ, ``test_torch_nvfp4.py``; quicker than its eager
        JAX) and the recipe policy in that format."""
        from repro.core.nvfp4 import PackedNVFP4 as JPacked
        from repro.launch import specs as jspecs
        from repro_torch.bridge import to_numpy
        tcfg = configs.get_smoke(arch)
        tp = ptq.quantize_weights(
            params_from_numpy(jax.tree.map(f32, dense), "cpu"),
            get_model(tcfg).param_specs(tcfg), dataclasses.replace(
                specs.recipe_qconfig(tcfg), weight_format=fmt))

        def one(t):
            if isinstance(t, dict) and "codes" in t:
                return JPacked(jnp.asarray(t["codes"]),
                               jnp.asarray(t["scales"]).astype(jnp.float8_e4m3fn),
                               jnp.asarray(t["tensor_scale"]), t["orig_k"])
            if isinstance(t, dict):
                return {k: one(v) for k, v in t.items()}
            return jnp.asarray(t).astype(bf)
        qc = dataclasses.replace(jspecs.recipe_qconfig(jconfigs.get_smoke(arch)),
                                 weight_format=fmt)
        return one(to_numpy(tp)), qc

    res, denses = {}, {}
    bf = jnp.bfloat16
    for i, (name, sq, sk, window, off, valid) in enumerate(ATT_CASES):
        q, k, v = (jnp.asarray(a, bf) for a in _att_inputs(i, sq, sk))
        res[f"att/{name}"] = f32(jax.jit(lambda q, k, v: jattn.blockwise_attention(
            q, k, v, causal=True, window=window, q_offset=off, kv_valid=valid,
            q_chunk=4, kv_chunk=8))(q, k, v))

    for arch in ARCHS:
        cfg = jconfigs.get_smoke(arch)
        dense = denses[arch] = jax.jit(lambda r: jdecoder.init_params(cfg, r))(
            jax.random.PRNGKey(0))
        for key, a in _flat(dense).items():
            res[f"{arch}/params/{key}"] = f32(a)
    for arch, fmt in CASES:
        cfg = jconfigs.get_smoke(arch)
        prompt = _prompt(cfg.vocab_size)
        params, qcfg = port_ptq(arch, denses[arch], fmt)
        # packed GEMMs in the dense form (cheaper to compile than the
        # Pallas kernel in interpret mode)
        sq = dataclasses.replace(qcfg, quantize_weights=False,
                                 act_scope="row", packed_backend="dequant")
        lg, _ = jax.jit(lambda p, t: jdecoder.prefill(
            cfg, p, {"tokens": t}, sq, s_max=None))(
            params, jnp.asarray(prompt[None]))
        res[f"{arch}/{fmt}/exact"] = f32(lg[0, -1])
        step = jax.jit(lambda p, s, po, bt, st, nv, t:
                       jdecoder.prefill_chunk_paged(cfg, p, s, po, bt, st,
                                                    nv, {"tokens": t}, sq))
        for chunk in CHUNKS:
            pool = jdecoder.init_paged_pool(cfg, 8, BS)
            scratch = jcommon.zeros_from_specs(
                jdecoder.prefill_scratch_specs(cfg, S_ALLOC))
            bt = jnp.asarray(np.arange(4, dtype=np.int32))
            start = 0
            while start < P_LEN:
                n_valid = min(chunk, P_LEN - start)
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :n_valid] = prompt[start:start + n_valid]
                lg, scratch, pool = step(params, scratch, pool, bt,
                                         jnp.asarray(start, jnp.int32),
                                         jnp.asarray(n_valid, jnp.int32),
                                         jnp.asarray(toks))
                start += n_valid
            res[f"{arch}/{fmt}/chunk{chunk}"] = f32(lg[0, -1])
            res[f"{arch}/{fmt}/chunk{chunk}/pool_k"] = f32(pool["k"][:, :2])

    # the engine in chunked mode, and with a budget below a chunk
    cfg = jconfigs.get_smoke(ARCHS[0])
    params, qcfg = port_ptq(ARCHS[0], denses[ARCHS[0]], "packed")
    qcfg = dataclasses.replace(qcfg, packed_backend="dequant")
    for name, (lens, chunk, budget) in (("mixed", MIXED), ("tight", TIGHT)):
        eng = JEngine(cfg, params, qcfg, n_slots=3, block_size=BS,
                      max_blocks_per_slot=4, n_blocks=12,
                      prefill_mode="chunked", prefill_chunk=chunk,
                      prefill_budget=budget)
        prompts = _workload(cfg.vocab_size, lens)
        rids = [eng.submit(p, GEN) for p in prompts]
        outs = eng.drain(max_steps=500)
        res[f"engine/{name}"] = np.stack([outs[r] for r in rids])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_chunked_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = f"import test_torch_chunked_prefill as t; t._reference({out!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _port(ref, arch, fmt):
    """(cfg, params, recipe qcfg, serving qcfg): the reference's init
    bridged, the port's PTQ."""
    cfg = configs.get_smoke(arch)
    dense = params_from_numpy(_unflat(ref, f"{arch}/params/"), "cpu")
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format=fmt)
    params = ptq.quantize_weights(dense, get_model(cfg).param_specs(cfg), qc)
    return cfg, params, qc, dataclasses.replace(qc, quantize_weights=False,
                                                act_scope="row")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _within_ulp(got: np.ndarray, want: np.ndarray):
    lim = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


def _chunked(cfg, params, sq, prompt, chunk):
    """The prompt through ``prefill_chunk_paged`` chunk by chunk: (last
    logits [V], pool)."""
    pool = decoder.init_paged_pool(cfg, 8, BS, "cpu")
    scratch = common.zeros_from_specs(
        decoder.prefill_scratch_specs(cfg, S_ALLOC), "cpu")
    bt = torch.arange(4, dtype=torch.int32)
    start, lg = 0, None
    with torch.inference_mode():
        while start < len(prompt):
            n_valid = min(chunk, len(prompt) - start)
            toks = np.zeros((1, chunk), np.int64)
            toks[0, :n_valid] = prompt[start:start + n_valid]
            lg = decoder.prefill_chunk_paged(cfg, params, scratch, pool, bt,
                                             start, n_valid,
                                             {"tokens": torch.from_numpy(toks)},
                                             sq)
            start += n_valid
    assert lg.shape == (1, 1, cfg.vocab_size)
    return lg[0, -1], pool


@pytest.mark.parametrize("i", range(len(ATT_CASES)),
                         ids=[c[0] for c in ATT_CASES])
def test_blockwise_attention_window_offset_match(ref, i):
    """Tolerance (one bf16 ulp): windowed, offset and right-padded
    blockwise attention over several q and kv chunks; a window below
    the context changes the output."""
    name, sq, sk, window, off, valid = ATT_CASES[i]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _att_inputs(i, sq, sk))
    kw = dict(causal=True, q_offset=off, kv_valid=valid, q_chunk=4, kv_chunk=8)
    got = attn.blockwise_attention(q, k, v, window=window, **kw)
    _within_ulp(got.float().numpy(), ref[f"att/{name}"])
    if window:
        assert not torch.equal(got, attn.blockwise_attention(q, k, v, **kw))


@pytest.mark.parametrize("arch,fmt", CASES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_logits_and_pool_match(ref, arch, fmt, chunk):
    """Tolerance: the last chunk's logits (rtol = atol = 1e-2) and the
    pool's first two blocks of KV (one bf16 ulp) against the reference
    chunk by chunk."""
    cfg, params, _, sq = _port(ref, arch, fmt)
    lg, pool = _chunked(cfg, params, sq, _prompt(cfg.vocab_size), chunk)
    np.testing.assert_allclose(lg.float().numpy(),
                               ref[f"{arch}/{fmt}/chunk{chunk}"],
                               rtol=TOL, atol=TOL)
    _within_ulp(pool["k"][:, :2].float().numpy(),
                ref[f"{arch}/{fmt}/chunk{chunk}/pool_k"])


@pytest.mark.parametrize("arch,fmt", CASES)
def test_one_chunk_equals_exact_prefill(ref, arch, fmt):
    """Bitwise: a chunk that is the whole prompt gives exact prefill's
    logits, and the pool holds exact prefill's KV; both within the
    serving tolerance of the reference's exact prefill."""
    cfg, params, _, sq = _port(ref, arch, fmt)
    prompt = _prompt(cfg.vocab_size)
    lg, pool = _chunked(cfg, params, sq, prompt, P_LEN)
    with torch.inference_mode():
        want, cache = decoder.prefill(cfg, params, {"tokens": torch.from_numpy(
            prompt[None]).long()}, sq, None)
    assert torch.equal(lg, want[0, -1])
    assert torch.equal(pool["k"][:, :2].reshape(cache["k"].shape), cache["k"])
    np.testing.assert_allclose(lg.float().numpy(), ref[f"{arch}/{fmt}/exact"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["mixed", "tight"])
def test_chunked_engine_matches_reference_engine(ref, name):
    """Greedy tokens: the engine in chunked mode equals the reference's
    engine in chunked mode on the same workload (prompts over several
    chunks, and a prefill budget below a chunk that spreads prompts over
    steps); every request finishes and the pool drains."""
    lens, chunk, budget = {"mixed": MIXED, "tight": TIGHT}[name]
    cfg, params, qc, _ = _port(ref, ARCHS[0], "packed")
    eng = Engine(cfg, params, qc, n_slots=3, block_size=BS,
                 max_blocks_per_slot=4, n_blocks=12, prefill_mode="chunked",
                 prefill_chunk=chunk, prefill_budget=budget, device="cpu")
    assert eng.prefill_budget == (budget or S_ALLOC)
    prompts = _workload(cfg.vocab_size, lens)
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.drain(max_steps=500)
    np.testing.assert_array_equal(np.stack([outs[r] for r in rids]),
                                  ref[f"engine/{name}"])
    assert eng.pool.used_blocks == 0 and not eng.state.leaked()
    assert eng.stats()["prefill_tokens"] == sum(lens)
