"""MoE slice of the PyTorch port against the JAX package, on the CPU.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (see ``test_torch_serve.py``), on
``qwen2-moe-a2.7b-smoke`` (2 layers, d_model 64, 6 experts top-2, expert
d_ff 48, a shared expert of d_ff 96) with numpy-seeded inputs and the
reference's own ``init_params`` bridged to the port.

Parity levels, as each test names them:

  * **bitwise**, the grouped NVFP4 GEMM's plain version (K3) against the
    reference's Pallas K3 in interpret mode (a shared and a per-group
    tensor scale, K padded under ``orig_k``, M not a tile multiple); the
    port's packing of 3-D expert stacks against the reference's; and
    ``qeinsum`` through "grouped" against "dequant";
  * **tolerance**, ``moe_ffn`` outputs under the three dispatch scopes and
    the model's logits, rtol = atol = 1e-2 (the serving slice's logit
    tolerance: the router's bf16 GEMM and the expert GEMMs sum in other
    orders than XLA's, which NVFP4 rounding amplifies), the dropped
    fraction equal and the router entropy within rtol 1e-5 of the
    reference's ``aux``;
  * **greedy tokens**, ``serve_batch`` (packed and QDQ) and the engine
    (packed, fused on and off, exact prefill) against the reference's;
  * **bitwise**, the engine's pool and scheduler books step by step under
    paged prefill with the prefix cache.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy, to_numpy
from repro_torch.core import nvfp4, ptq, qconfig
from repro_torch.kernels import ops, ref as kref
from repro_torch.launch import serve, specs
from repro_torch.models import common, get_model, layers
from repro_torch.serve import Engine
from test_torch_engine import _bookkeeping, _staggered
from test_torch_serve import _flat, _unflat

ARCH = "qwen2-moe-a2.7b"
RTOL = ATOL = 1e-2
N_DECODE = 3
GEN = 4
BS = 8
MIXED_LENS = [5, 14, 9, 14, 5, 9]
# (name, groups, m, k, n, tensor scale, orig_k): K3's cases
K3_CASES = [("shared", 4, 5, 64, 40, "shared", 0),
            ("per_group_m42", 3, 42, 96, 24, "group", 0),
            ("padded_k", 3, 1, 40, 32, "group", 1)]
# (name, dispatch, act_scope, router): moe_ffn's cases; "tied" gives three
# experts the same large router column, so most tokens pick between tied
# gates and their capacity overflows
MOE_CASES = [("global", "global", "tensor", "plain"),
             ("local", "local", "row", "plain"),
             ("token", "token", "token", "plain"),
             ("local_tied", "local", "row", "tied"),
             ("global_tied", "global", "tensor", "tied")]
# the engine's paged-prefill run: prefix cache, on-demand paging
PAGED_RUN = dict(prefix_cache=True, kv_alloc="ondemand", n_slots=3,
                 n_blocks=16, max_blocks_per_slot=4)
PAGED_GEN = 6


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_values(a):
    """f32 numpy values that bf16 holds exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _k3_inputs(i):
    name, g, m, k, n, mode, padded = K3_CASES[i]
    r = _rng(40 + i)
    x = _bf16_values(r.standard_normal((g, m, k)).astype(np.float32))
    # a per-group scale needs groups of different amax
    w = (r.standard_normal((g, k, n)) * (1.0 + np.arange(g))[:, None, None]
         ).astype(np.float32)
    return x, w


def _moe_x(cfg):
    return _bf16_values(_rng(5).standard_normal((2, 8, cfg.d_model))
                        .astype(np.float32))


def _tied_router(router):
    """Router columns 2, 3, 4 made equal and large."""
    r = router.copy()
    r[:, 2:5] = 4.0 * r[:, 2:3]
    return r


def _mixed_prompts(vocab):
    r = _rng(3)
    return [r.integers(4, vocab, (n,)).astype(np.int32) for n in MIXED_LENS]


def _shared_prompts(vocab, n=6):
    r = _rng(7)
    head = r.integers(4, vocab, (BS + 3,)).astype(np.int32)
    return [np.concatenate([head, r.integers(4, vocab, (1 + i % 4,))
                            .astype(np.int32)]) if i % 3 else
            r.integers(4, vocab, (5,)).astype(np.int32) for i in range(n)]


def _packed_numpy(p):
    return {"codes": np.asarray(p.codes),
            "scales": np.asarray(p.scales.astype("float32")),
            "tensor_scale": np.asarray(p.tensor_scale.astype("float32")),
            "orig_k": np.asarray(p.orig_k)}


def _to_jax(tree):
    """A numpy tree of ``bridge.to_numpy``'s form as the reference's:
    float leaves bf16, packed dicts ``PackedNVFP4``."""
    import jax.numpy as jnp

    from repro.core.nvfp4 import PackedNVFP4 as JPacked

    if isinstance(tree, dict) and "codes" in tree:
        return JPacked(jnp.asarray(tree["codes"]),
                       jnp.asarray(tree["scales"]).astype(jnp.float8_e4m3fn),
                       jnp.asarray(tree["tensor_scale"]), int(tree["orig_k"]))
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree).astype(jnp.bfloat16)


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import nvfp4 as jnvfp4
    from repro.core import ptq as jptq
    from repro.core import qconfig as jq
    from repro.kernels import ops as jops
    from repro.launch import serve as jserve
    from repro.launch import specs as jspecs
    from repro.models import get_model as jget_model
    from repro.models import layers as jlayers
    from repro.serve import Engine as JEngine

    res = {}
    for i, (name, g, m, k, n, mode, padded) in enumerate(K3_CASES):
        x, w = _k3_inputs(i)
        if padded:
            p = jptq._pack_along(jnp.asarray(w), 1, n_lead=1)
        else:
            p = jnvfp4.pack(jnp.asarray(np.swapaxes(w, 1, 2)),
                            n_lead=1 if mode == "group" else 0)
        for key, a in _packed_numpy(p).items():
            res[f"k3/{name}/{key}"] = a
        res[f"k3/{name}/f32"] = np.asarray(jops.nvfp4_matmul_grouped(
            jnp.asarray(x), p, out_dtype=jnp.float32, interpret=True))
        res[f"k3/{name}/bf16"] = np.asarray(jops.nvfp4_matmul_grouped(
            jnp.asarray(x).astype(jnp.bfloat16), p,
            interpret=True).astype(jnp.float32))

    cfg = jconfigs.get_smoke(ARCH)
    model = jget_model(cfg)
    dense = jax.jit(lambda key: model.init_params(cfg, key))(
        jax.random.PRNGKey(0))
    for key, a in _flat(dense).items():
        res[f"params/{key}"] = np.asarray(a.astype(jnp.float32))
    # the reference's PTQ of the expert stacks, eager as load_quantized runs
    # it; the forwards below take the port's PTQ of every leaf, bitwise
    # equal to the reference's (``test_expert_stack_ptq_matches_reference``
    # here, ``test_torch_nvfp4.py`` for the other leaves)
    pspecs = model.param_specs(cfg)["layers"]
    for name in ("moe_wg", "moe_wu", "moe_wd"):
        p = jptq._pack_along(dense["layers"][name],
                             pspecs[name].contract_axis, n_lead=1)
        for key, a in _packed_numpy(p).items():
            res[f"ptq/{name}/{key}"] = a
    quant = {}
    for fmt in ("qdq", "packed"):
        _, tp, qcfg = _port(res, fmt)
        quant[fmt] = (_to_jax(to_numpy(tp)), dataclasses.replace(
            jspecs.recipe_qconfig(cfg), weight_format=fmt))

    # moe_ffn on layer 0's packed experts
    params, qcfg = quant["packed"]
    l0 = jax.tree.map(lambda a: a[0], params["layers"])
    x = jnp.asarray(_moe_x(cfg)).astype(jnp.bfloat16)
    for name, dispatch, scope, router in MOE_CASES:
        c = dataclasses.replace(cfg, moe_dispatch=dispatch)
        sq = dataclasses.replace(qcfg, quantize_weights=False, act_scope=scope,
                                 packed_backend="dequant")
        rw = l0["router"]
        if router == "tied":
            rw = jnp.asarray(_tied_router(np.asarray(rw.astype(jnp.float32))
                                          )).astype(rw.dtype)
        out, aux = jax.jit(lambda xx, r: jlayers.moe_ffn(
            sq, c, xx, r, l0["moe_wg"], l0["moe_wu"], l0["moe_wd"]))(x, rw)
        res[f"moe/{name}/out"] = np.asarray(out.astype(jnp.float32))
        for key, a in aux.items():
            res[f"moe/{name}/{key}"] = np.asarray(a)

    # the model: teacher-forcing logits, prefill + decode, serve_batch
    toks = jnp.asarray(_rng(1).integers(4, cfg.vocab_size, (2, 16))
                       .astype(np.int32))
    for name, qc in (("bf16", jq.BF16), ("nvfp4", jq.NVFP4_ALL)):
        res[f"apply/{name}"] = np.asarray(jax.jit(
            lambda p, t: model.apply(cfg, p, {"tokens": t}, qc))(
                dense, toks).astype(jnp.float32))
    prompts = jnp.asarray(_rng(2).integers(4, cfg.vocab_size, (2, 8))
                          .astype(np.int32))
    for fmt in ("qdq", "packed"):
        params, qcfg = quant[fmt]
        sq = jspecs.serve_qconfig(cfg)
        logits, cache = jax.jit(lambda p, b: model.prefill(
            cfg, p, b, sq, s_max=12))(params, {"tokens": prompts})
        step = jax.jit(lambda p, c, b: model.decode_step(cfg, p, c, b, sq))
        steps = [logits]
        for _ in range(N_DECODE):
            nxt = jnp.argmax(steps[-1][:, -1:], -1).astype(jnp.int32)
            logits, cache = step(params, cache, {"tokens": nxt})
            steps.append(logits)
        res[f"steps/{fmt}"] = np.stack(
            [np.asarray(s.astype(jnp.float32)) for s in steps])
        res[f"tokens/{fmt}"] = np.asarray(jserve.serve_batch(
            cfg, params, prompts, GEN, qcfg=sq)[0])

    # the engine on packed weights, fused (the grouped and paged-attention
    # Pallas kernels, interpret mode), exact prefill, staggered arrivals
    params, qcfg = quant["packed"]
    eng = JEngine(cfg, params, qcfg, n_slots=3, block_size=BS,
                  max_blocks_per_slot=4, n_blocks=12)
    rids, outs = _staggered(eng, _mixed_prompts(cfg.vocab_size), GEN)
    res["engine/tokens"] = np.stack([outs[r] for r in rids])

    # paged prefill with the prefix cache: books step by step
    eng = JEngine(cfg, params, qcfg, block_size=BS, prefill_mode="paged",
                  **PAGED_RUN)
    trace = []
    rids, outs = _staggered(eng, _shared_prompts(cfg.vocab_size), PAGED_GEN,
                            trace)
    res["paged/tokens"] = np.stack([outs[r] for r in rids])
    res["paged/trace"] = np.frombuffer(json.dumps(trace).encode(), np.uint8)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_moe_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = f"import test_torch_moe as t; t._reference({out!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _port(ref, fmt=None):
    """(cfg, params, qcfg): the reference's init bridged, the port's PTQ."""
    cfg = configs.get_smoke(ARCH)
    dense = params_from_numpy(_unflat(ref, "params/"), "cpu")
    if fmt is None:
        return cfg, dense, None
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format=fmt)
    return cfg, ptq.quantize_weights(dense, get_model(cfg).param_specs(cfg),
                                     qc), qc


def _close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=ATOL)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# K3 and packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(K3_CASES)), ids=[c[0] for c in K3_CASES])
def test_k3_plain_matches_reference_kernel(ref, i):
    """Bitwise: K3's plain version against the reference's Pallas K3
    (interpret mode), f32 and bf16 in and out; the port packs the stack
    to the reference's codes, scales and tensor scales bitwise."""
    name, g, m, k, n, mode, padded = K3_CASES[i]
    x, w = _k3_inputs(i)
    if padded:
        tp = ptq._pack_along(torch.from_numpy(w), 1, n_lead=1)
    else:
        tp = nvfp4.pack(torch.from_numpy(np.swapaxes(w, 1, 2)).contiguous(),
                        n_lead=1 if mode == "group" else 0)
    want = params_from_numpy({key: ref[f"k3/{name}/{key}"] for key in
                              ("codes", "scales", "tensor_scale", "orig_k")},
                             "cpu")
    assert tp.orig_k == want.orig_k == k
    assert torch.equal(tp.codes, want.codes)
    assert torch.equal(tp.scales.view(torch.uint8), want.scales.view(torch.uint8))
    assert torch.equal(tp.tensor_scale.reshape(-1), want.tensor_scale.reshape(-1))
    assert tp.tensor_scale.numel() == (g if mode == "group" else 1)
    ops.reset_launches()
    got = ops.nvfp4_matmul_grouped(torch.from_numpy(x), tp, torch.float32)
    assert got.shape == (g, m, n) and ops.launches["nvfp4_matmul_grouped"] == 0
    np.testing.assert_array_equal(_bits(got), ref[f"k3/{name}/f32"].view(np.uint32))
    got = kref.nvfp4_matmul_grouped_ref(torch.from_numpy(x).to(torch.bfloat16), tp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), ref[f"k3/{name}/bf16"].view(np.uint32))


def test_k3_plain_per_group_is_k2_plain():
    """Bitwise: group g of K3's plain version is K2's plain version on
    group g's slices, shared scale broadcast to every group."""
    x, w = _k3_inputs(0)
    tp = nvfp4.pack(torch.from_numpy(np.swapaxes(w, 1, 2)).contiguous())
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = kref.nvfp4_matmul_grouped_ref(xt, tp)
    for g in range(x.shape[0]):
        sl = nvfp4.PackedNVFP4(tp.codes[g], tp.scales[g], tp.tensor_scale,
                               tp.orig_k)
        assert torch.equal(got[g], kref.nvfp4_matmul_ref(xt[g], sl))


def test_expert_stack_ptq_matches_reference(ref):
    """Bitwise: PTQ packs the [L, E, d, ffe] expert stacks along d into
    codes [L, E, ffe, d/2] with one tensor scale per layer (shared by the
    layer's experts), equal to the reference's ``load_quantized``; a layer
    slice keeps its scale as [1, 1, 1]."""
    cfg, params, _ = _port(ref, "packed")
    e, ffe, d = cfg.n_experts, cfg.moe_d_ff, cfg.d_model
    for name in ("moe_wg", "moe_wu", "moe_wd"):
        got = params["layers"][name]
        want = params_from_numpy({key: ref[f"ptq/{name}/{key}"] for key in
                                  ("codes", "scales", "tensor_scale",
                                   "orig_k")}, "cpu")
        n_out, k_in = (ffe, d) if name != "moe_wd" else (d, ffe)
        assert tuple(got.codes.shape) == (cfg.n_layers, e, n_out, k_in // 2)
        assert tuple(got.tensor_scale.shape) == (cfg.n_layers, 1, 1, 1)
        assert got.orig_k == want.orig_k == k_in
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.scales.view(torch.uint8),
                           want.scales.view(torch.uint8))
        assert torch.equal(got.tensor_scale, want.tensor_scale)
        sl = common.layer_slice(params["layers"], 1)[name]
        assert tuple(sl.tensor_scale.shape) == (1, 1, 1)
        assert torch.equal(sl.codes, got.codes[1])


@pytest.mark.parametrize("lead", [(2,), ()], ids=["batched", "flat"])
def test_qeinsum_grouped_matches_dequant(ref, lead):
    """Bitwise: the MoE einsum through "grouped" (K3's plain version) and
    through "dequant" (dequantize the stack, then multiply), as the
    reference's ``tests/test_fused_kernels.py`` holds its kernel; the
    dequantized stack is the QDQ weight's layout."""
    cfg, params, _ = _port(ref, "packed")
    w = common.layer_slice(params["layers"], 0)["moe_wg"]
    x = torch.from_numpy(_bf16_values(_rng(9).standard_normal(
        (*lead, cfg.n_experts, 3, cfg.d_model)).astype(np.float32))
        ).to(torch.bfloat16)
    sq = specs.serve_qconfig(cfg)
    got = {b: layers.qdense(dataclasses.replace(sq, packed_backend=b), "mlp",
                            x, w, contract_axis=1)
           for b in ("grouped", "dequant")}
    assert got["grouped"].shape == (*lead, cfg.n_experts, 3, cfg.moe_d_ff)
    assert torch.equal(got["grouped"], got["dequant"])
    wd = ops.dequant_weight(w, 1)
    assert tuple(wd.shape) == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert torch.equal(layers.qdense(sq, "mlp", x, wd, contract_axis=1),
                       got["dequant"])


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_matches_reference(ref, i):
    """Tolerance: ``moe_ffn`` on layer 0's packed experts against the
    jitted reference, outputs rtol 1e-2, the dropped fraction equal and
    the router entropy within rtol 1e-5; "grouped" and "dequant" agree
    bitwise.  The tied cases drop tokens at capacity."""
    name, dispatch, scope, router = MOE_CASES[i]
    cfg, params, qcfg = _port(ref, "packed")
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    l0 = common.layer_slice(params["layers"], 0)
    rw = l0["router"]
    if router == "tied":
        rw = torch.from_numpy(_tied_router(rw.float().numpy())).to(rw.dtype)
    x = torch.from_numpy(_moe_x(cfg)).to(torch.bfloat16)
    outs = {}
    for backend in ("grouped", "dequant"):
        sq = dataclasses.replace(qcfg, quantize_weights=False, act_scope=scope,
                                 packed_backend=backend)
        outs[backend] = layers.moe_ffn(sq, cfg, x, rw, l0["moe_wg"],
                                       l0["moe_wu"], l0["moe_wd"])
    out, aux = outs["grouped"]
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(out, outs["dequant"][0])
    _close(out, ref[f"moe/{name}/out"])
    assert float(aux["moe_dropped_frac"]) == float(ref[f"moe/{name}/moe_dropped_frac"])
    np.testing.assert_allclose(float(aux["moe_router_entropy"]),
                               float(ref[f"moe/{name}/moe_router_entropy"]),
                               rtol=1e-5)
    if router == "tied":
        assert float(aux["moe_dropped_frac"]) > 0


def test_top_k_breaks_ties_to_the_lower_index():
    """``jax.lax.top_k``'s order: values descending, ties to the lower
    index, exactly k."""
    g = torch.tensor([[0.1, 0.3, 0.3, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2, 0.2]])
    vals, idx = layers._top_k(g, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, torch.gather(g, -1, idx))


def test_moe_capacity_and_empty_slots():
    """The capacity is the reference's ``int(max(1, (s*k*cf)//e))``;
    empty slots gather token 0 with weight 0 and leave every output as
    the kept choices make it."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), moe_dispatch="local")
    d, e = cfg.d_model, cfg.n_experts
    x = torch.from_numpy(_bf16_values(_rng(11).standard_normal((1, 3, d))
                                      .astype(np.float32))).to(torch.bfloat16)
    rw = torch.from_numpy(_rng(12).standard_normal((d, e)).astype(np.float32)
                          ).to(torch.bfloat16)
    buf_tok, (dst, keep, w), cap, aux = layers._route(qconfig.BF16, cfg, x, rw)
    assert cap == int(max(1, (3 * cfg.experts_per_tok * cfg.capacity_factor) // e))
    assert buf_tok.shape == (1, e * cap)
    used = set(dst[keep].tolist())
    assert all(int(buf_tok[0, j]) == 0 for j in range(e * cap) if j not in used)
    assert float(aux["moe_dropped_frac"]) == 1.0 - float(keep.float().mean())
    # every kept choice lands in a slot holding its own token
    tok = torch.arange(3)[None, :, None].expand_as(dst)
    assert torch.equal(buf_tok[0][dst[keep]], tok[keep])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bf16", "nvfp4"])
def test_apply_logits_match(ref, name):
    """Tolerance: teacher-forcing logits of the BF16 teacher and the NVFP4
    student (weights and activations fake-quantized at run time): the
    forward QAD would run on an MoE student."""
    cfg, dense, _ = _port(ref)
    qc = {"bf16": qconfig.BF16, "nvfp4": qconfig.NVFP4_ALL}[name]
    toks = torch.from_numpy(_rng(1).integers(4, cfg.vocab_size, (2, 16))
                            .astype(np.int64))
    with torch.no_grad():
        got = get_model(cfg).apply(cfg, dense, {"tokens": toks}, qc)
    assert got.dtype == torch.bfloat16
    _close(got, ref[f"apply/{name}"])


@pytest.mark.parametrize("fmt", ["qdq", "packed"])
def test_prefill_decode_logits_match(ref, fmt):
    """Tolerance: prefill + decode_step logits, fed the reference's greedy
    tokens."""
    cfg, params, _ = _port(ref, fmt)
    model = get_model(cfg)
    sq = specs.serve_qconfig(cfg)
    want = ref[f"steps/{fmt}"]
    prompts = torch.from_numpy(_rng(2).integers(4, cfg.vocab_size, (2, 8))
                               .astype(np.int64))
    with torch.inference_mode():
        logits, cache = model.prefill(cfg, params, {"tokens": prompts}, sq,
                                      s_max=12)
        _close(logits, want[0])
        for i in range(N_DECODE):
            nxt = torch.from_numpy(want[i][:, -1:].argmax(-1)).long()
            logits, cache = model.decode_step(cfg, params, cache,
                                              {"tokens": nxt}, sq)
            _close(logits, want[i + 1])


@pytest.mark.parametrize("fmt", ["qdq", "packed"])
def test_serve_batch_tokens_equal(ref, fmt):
    """Greedy tokens of ``serve_batch`` equal to the reference's; packed
    expert stacks count as quantized GEMM weights at 0.5625 B/param."""
    cfg, params, _ = _port(ref, fmt)
    prompts = torch.from_numpy(_rng(2).integers(4, cfg.vocab_size, (2, 8))
                               .astype(np.int64))
    toks, _ = serve.serve_batch(cfg, params, prompts, GEN)
    np.testing.assert_array_equal(toks.numpy(), ref[f"tokens/{fmt}"])
    wr = serve.weight_report(params)
    if fmt == "packed":
        e, d, ffe = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        assert wr["q_params"] >= cfg.n_layers * 3 * e * d * ffe
        assert abs(wr["q_bytes_per_param"] - nvfp4.BYTES_PER_ELEM) < 0.02
    else:
        assert wr["q_params"] == 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", ["on", "off"])
def test_engine_tokens_match_reference(ref, fused):
    """Greedy tokens: the engine on packed weights, exact prefill,
    staggered mixed lengths, fused (K3 and K7's plain versions) and not,
    against the reference's fused engine; dispatch forced to "local"; the
    pool drains."""
    cfg, params, qcfg = _port(ref, "packed")
    eng = Engine(cfg, params, qcfg, n_slots=3, block_size=BS,
                 max_blocks_per_slot=4, n_blocks=12, fused_kernels=fused,
                 device="cpu")
    st = eng.stats()
    assert st["moe_dispatch"] == "local" and eng.cfg.moe_dispatch == "local"
    assert st["packed_backend"] == ("grouped" if fused == "on" else "auto")
    rids, outs = _staggered(eng, _mixed_prompts(cfg.vocab_size), GEN)
    np.testing.assert_array_equal(np.stack([outs[r] for r in rids]),
                                  ref["engine/tokens"])
    assert eng.pool.used_blocks == 0 and not eng.state.leaked()


def test_paged_prefill_prefix_cache_books_bitwise(ref):
    """Bitwise: paged prefill (token dispatch, K3 at one row per token)
    with the prefix cache keeps the reference's books step by step and
    gives its greedy tokens; the cache hits."""
    cfg, params, qcfg = _port(ref, "packed")
    eng = Engine(cfg, params, qcfg, block_size=BS, prefill_mode="paged",
                 device="cpu", **PAGED_RUN)
    assert eng.pcfg.moe_dispatch == "token"
    trace = []
    rids, outs = _staggered(eng, _shared_prompts(cfg.vocab_size), PAGED_GEN,
                            trace)
    assert trace == json.loads(ref["paged/trace"].tobytes().decode())
    np.testing.assert_array_equal(np.stack([outs[r] for r in rids]),
                                  ref["paged/tokens"])
    assert eng.state.cache.hits > 0 and not eng.state.leaked()
