"""FP8 KV (the ``moe_hybrid`` recipe) in the PyTorch port against the JAX
package, on the CPU.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (``test_torch_rwkv6.run_reference``);
the inputs are made here from numpy seeds.  The reference's KV writes run
jitted, where XLA turns the scale's ``amax / 448`` into a product with the
f32 reciprocal of 448 (the values' division by the scale stays a division):
the port follows that form.

Parity levels, as each test names them:

  * **bitwise**: ``core.nvfp4.fp8_quantize`` / ``attention._quant_kv``
    against the jitted reference, on random rows, an all-zero row and rows
    whose values sit on E4M3 rounding ties of the division (where a
    product with the reciprocal would round the other way);
  * **bitwise**: the FP8 pages and scales that ``cache_update_layer``,
    ``cache_update_slots`` and ``paged_update_layer`` write, inactive rows
    dropped, against the reference's jitted writes;
  * **tolerance**: ``decode_step_paged`` logits over an FP8 pool filled by
    exact prefill (arctic-480b smoke, MoE), rtol = atol = 1e-2
    (``test_torch_engine.py``'s level);
  * **greedy tokens**: the arctic-480b smoke engine (2 slots, prompts of
    4, 9 and 16 tokens, 4 generated) against the reference's engine and
    the port's ``serve_batch`` (the reference's
    ``tests/test_engine.py::test_engine_fp8_kv_moe_matches_serve_batch``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import nvfp4
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import decoder
from repro_torch.serve import Engine
from test_torch_engine import BS, LOGIT_TOL, _port, _step_inputs
from test_torch_rwkv6 import run_reference
from test_torch_serve import _flat

ARCH = "arctic-480b"
ENGINE = dict(n_slots=2, block_size=8, max_blocks_per_slot=4, n_blocks=16)
LENS, GEN = (4, 9, 16), 4
# dense cache [B, S_max, Hkv, hd], pool [n_blocks, bs, Hkv, hd]
CACHE, POOL = (3, 8, 2, 16), (6, 4, 2, 16)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tie_rows(n_amax: int = 200) -> np.ndarray:
    """[n, 2] f32 rows (amax, x) of bf16 values on which x / scale and
    x * (1 / scale) round to different E4M3 values (scale = amax * f32(1 /
    448)): the division's rounding ties and near-ties."""
    import ml_dtypes
    allb = np.arange(0, 0x7F80, dtype=np.uint16).view(
        ml_dtypes.bfloat16).astype(np.float32)
    pos = allb[allb > 1e-3]
    inv = np.float32(1.0) / np.float32(448.0)
    rows = []
    for a in np.random.default_rng(2).choice(pos, n_amax):
        s = np.float32(a) * inv
        xs = allb[allb <= a]
        d = (xs / s).astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
        r = (xs * (np.float32(1) / s)).astype(ml_dtypes.float8_e4m3fn
                                              ).view(np.uint8)
        rows += [(a, x) for x in xs[d != r][:3]]
    return np.asarray(rows, np.float32)


def _quant_inputs() -> np.ndarray:
    """Rows of 32 bf16-representable values: random magnitudes from 2^-30
    to 2^30, one all-zero row, signs mixed."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 3, 32))
         * np.exp2(rng.integers(-30, 30, (64, 3, 1)))).astype(np.float32)
    x[5, 1] = 0.0
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _write_inputs():
    """New kv rows, positions and active masks for the three writes."""
    rng = np.random.default_rng(1)
    b, s_max, hkv, hd = CACHE
    n_blocks, bs = POOL[:2]
    kv = lambda *shape: (rng.standard_normal(shape) * 4).astype(np.float32)
    return {
        "layer_k": kv(b, 3, hkv, hd), "layer_v": kv(b, 3, hkv, hd),
        "slots_k": kv(b, 1, hkv, hd), "slots_v": kv(b, 1, hkv, hd),
        "slots_pos": np.asarray([1, 7, 4], np.int32),
        "slots_active": np.asarray([True, False, True]),
        "paged_k": kv(3, 3, hkv, hd), "paged_v": kv(3, 3, hkv, hd),
        "paged_bt": np.asarray([[2, 4], [1, 5], [3, 0]], np.int32),
        "paged_pos": np.asarray([[1, 2, 3], [3, 4, 5], [6, 7, 8]], np.int32),
        "paged_active": np.asarray([[True, True, False], [True, True, True],
                                    [False, False, False]]),
    }


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in LENS]


def _fp8_bytes(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import serve as jserve
    from repro.models import attention as jattn
    from repro.models import decoder as jdecoder
    from repro.models import get_model as jget_model
    from repro.serve import Engine as JEngine

    res = {}
    quant = jax.jit(jattn._quant_kv)
    for name, x in (("random", _quant_inputs()),
                    ("ties", tie_rows()[:, None, :])):
        vals, scale = quant(jnp.asarray(x, jnp.bfloat16))
        res[f"quant/{name}/values"] = _fp8_bytes(vals)
        res[f"quant/{name}/scale"] = np.asarray(scale)

    w = _write_inputs()
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    zeros = lambda shape, dt: jnp.zeros(shape, dt)
    cache = {"k": zeros(CACHE, jnp.float8_e4m3fn),
             "v": zeros(CACHE, jnp.float8_e4m3fn),
             "k_scale": zeros(CACHE[:-1], jnp.float32),
             "v_scale": zeros(CACHE[:-1], jnp.float32)}
    out = jax.jit(lambda c, k, v: jattn.cache_update_layer(c, k, v, 2))(
        cache, bf(w["layer_k"]), bf(w["layer_v"]))
    out = jax.jit(jattn.cache_update_slots)(
        out, bf(w["slots_k"]), bf(w["slots_v"]), jnp.asarray(w["slots_pos"]),
        jnp.asarray(w["slots_active"]))
    for key, a in out.items():
        res[f"dense/{key}"] = (_fp8_bytes(a) if key in ("k", "v")
                               else np.asarray(a))
    pool = {"k": zeros(POOL, jnp.float8_e4m3fn),
            "v": zeros(POOL, jnp.float8_e4m3fn),
            "k_scale": zeros(POOL[:-1], jnp.float32),
            "v_scale": zeros(POOL[:-1], jnp.float32)}
    out = jax.jit(jattn.paged_update_layer)(
        pool, bf(w["paged_k"]), bf(w["paged_v"]), jnp.asarray(w["paged_bt"]),
        jnp.asarray(w["paged_pos"]), jnp.asarray(w["paged_active"]))
    for key, a in out.items():
        res[f"paged/{key}"] = (_fp8_bytes(a) if key in ("k", "v")
                               else np.asarray(a))

    # the arctic smoke model: its init, a decode step over an FP8 pool,
    # the engine and serve_batch
    cfg = jconfigs.get_smoke(ARCH)
    dense = jget_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    for key, a in _flat(dense).items():
        res[f"{ARCH}/params/{key}"] = np.asarray(a.astype(jnp.float32))
    params, qcfg = jserve.load_quantized(cfg, jax.random.PRNGKey(0), "qdq")
    lcfg = dataclasses.replace(cfg, moe_dispatch="local")
    sq = dataclasses.replace(qcfg, quantize_weights=False, act_scope="row")
    st = _step_inputs(cfg.vocab_size)
    pool = jdecoder.init_paged_pool(lcfg, 8, BS)
    for p, ids in zip(st["prompts"], st["prompt_blocks"]):
        _, cache = jax.jit(lambda pr, t: jdecoder.prefill(
            lcfg, pr, {"tokens": t}, sq, None))(params, jnp.asarray(p[None]))
        cache = {k: v for k, v in cache.items() if k != "pos"}
        pool = jdecoder.write_prompt_to_pool(pool, cache, jnp.asarray(ids))
    lg, pool = jax.jit(lambda pr, po, *a: jdecoder.decode_step_paged(
        lcfg, pr, po, *a[:3], {"tokens": a[3]}, sq))(
        params, pool, jnp.asarray(st["bt"]), jnp.asarray(st["lens"]),
        jnp.asarray(st["active"]), jnp.asarray(st["dec_toks"]))
    res["decode"] = np.asarray(lg.astype(jnp.float32))

    eng = JEngine(cfg, params, qcfg, **ENGINE)
    prompts = _prompts(cfg.vocab_size)
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.drain(max_steps=200)
    res["engine"] = np.stack([outs[r] for r in rids])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_fp8_kv_ref") / "ref.npz")
    return run_reference("test_torch_fp8_kv", out)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("name", ["random", "ties"])
def test_quant_kv_is_bitwise_the_jitted_reference(ref, name):
    """Bitwise: E4M3 values and f32 scales of ``_quant_kv`` (and so of
    ``fp8_quantize``), an all-zero row (scale 1e-30 / 448, values 0) and
    division ties included; no value saturates."""
    x = _bf(_quant_inputs() if name == "random" else tie_rows()[:, None, :])
    vals, scale = attn._quant_kv(x)
    np.testing.assert_array_equal(_bytes(vals), ref[f"quant/{name}/values"])
    np.testing.assert_array_equal(scale.numpy(), ref[f"quant/{name}/scale"])
    assert torch.isfinite(vals.float()).all()
    t = nvfp4.fp8_quantize(x)
    assert torch.equal(t.values.view(torch.uint8), vals.view(torch.uint8))
    if name == "ties":
        # the reciprocal form would round every one of these rows otherwise
        s = scale[..., None]
        other = (x.float() * (1.0 / s)).to(torch.float8_e4m3fn)
        assert bool((other.view(torch.uint8)[..., 1]
                     != vals.view(torch.uint8)[..., 1]).all())


def test_fp8_cache_writes_are_bitwise_the_references(ref):
    """Bitwise: ``cache_update_layer`` (3 positions from 2) then
    ``cache_update_slots`` (the middle row inactive: dropped) on an FP8
    dense cache, and ``paged_update_layer`` on an FP8 pool (inactive
    entries and a wholly inactive row dropped): pages and scales."""
    w = _write_inputs()
    z8 = lambda shape: torch.zeros(shape, dtype=torch.float8_e4m3fn)
    cache = {"k": z8(CACHE), "v": z8(CACHE),
             "k_scale": torch.zeros(CACHE[:-1]),
             "v_scale": torch.zeros(CACHE[:-1])}
    attn.cache_update_layer(cache, _bf(w["layer_k"]), _bf(w["layer_v"]), 2)
    cache = attn.cache_update_slots(
        cache, _bf(w["slots_k"]), _bf(w["slots_v"]),
        torch.from_numpy(w["slots_pos"]).long(),
        torch.from_numpy(w["slots_active"]))
    pool = {"k": z8(POOL), "v": z8(POOL), "k_scale": torch.zeros(POOL[:-1]),
            "v_scale": torch.zeros(POOL[:-1])}
    attn.paged_update_layer(pool, _bf(w["paged_k"]), _bf(w["paged_v"]),
                            torch.from_numpy(w["paged_bt"]),
                            torch.from_numpy(w["paged_pos"]),
                            torch.from_numpy(w["paged_active"]))
    for prefix, tree in (("dense", cache), ("paged", pool)):
        for key, a in tree.items():
            got = _bytes(a) if key in ("k", "v") else a.numpy()
            np.testing.assert_array_equal(got, ref[f"{prefix}/{key}"],
                                          err_msg=f"{prefix}/{key}")
    assert pool["k"].dtype == torch.float8_e4m3fn
    assert not pool["k_scale"][0].any()             # block 0: row 2 inactive


def test_decode_step_paged_logits_on_fp8_pool(ref):
    """Tolerance: two prompts written by exact prefill (the FP8 dense
    cache, copied into the pool), then one decode step over three slots
    (the third inactive), against the jitted reference."""
    cfg, params, qcfg = _port(ref, ARCH, "qdq")
    cfg = dataclasses.replace(cfg, moe_dispatch="local")
    sq = dataclasses.replace(qcfg, quantize_weights=False, act_scope="row")
    st = _step_inputs(cfg.vocab_size)
    pool = decoder.init_paged_pool(cfg, 8, BS, "cpu")
    assert pool["k"].dtype == torch.float8_e4m3fn and "v_scale" in pool
    with torch.inference_mode():
        for p, ids in zip(st["prompts"], st["prompt_blocks"]):
            _, cache = decoder.prefill(cfg, params, {"tokens": torch.from_numpy(
                p[None].astype(np.int64))}, sq, None)
            assert cache["k"].dtype == torch.float8_e4m3fn
            cache = {k: v for k, v in cache.items() if k != "pos"}
            decoder.write_prompt_to_pool(pool, cache, ids)
        lg, _ = decoder.decode_step_paged(
            cfg, params, pool, torch.from_numpy(st["bt"]),
            torch.from_numpy(st["lens"]), torch.from_numpy(st["active"]),
            {"tokens": torch.from_numpy(st["dec_toks"].astype(np.int64))}, sq)
    np.testing.assert_allclose(lg[:2].float().numpy(), ref["decode"][:2],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_fp8_moe_engine_matches_reference_and_serve_batch(ref):
    """Greedy tokens: the arctic smoke engine (FP8 pool, MoE, 2 slots)
    against the reference's engine and the port's single-request
    ``serve_batch`` (whose dense cache is FP8 too); the pool drains and
    reports its FP8 pages' bytes."""
    cfg, params, qcfg = _port(ref, ARCH, "qdq")
    eng = Engine(cfg, params, qcfg, device="cpu", **ENGINE)
    assert eng.pool.fp8
    prompts = _prompts(cfg.vocab_size)
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.drain(max_steps=200)
    got = np.stack([outs[r] for r in rids])
    np.testing.assert_array_equal(got, ref["engine"])
    for row, p in zip(got, prompts):
        want, _ = serve.serve_batch(eng.cfg, params, torch.from_numpy(
            p[None].astype(np.int64)), GEN, qcfg=qcfg)
        np.testing.assert_array_equal(row, want[0].numpy())
    st = eng.stats()
    assert not eng.state.leaked() and st["fp8"]
    l, n, bs, hkv, hd = eng.pool.data["k"].shape
    assert st["pool_bytes"] == 2 * l * n * bs * hkv * (hd + 4)
