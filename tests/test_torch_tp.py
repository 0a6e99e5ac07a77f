"""Tensor-parallel slice of the PyTorch port against the JAX package, on
the CPU.

The reference runs once per module in a subprocess with two emulated host
devices (``--xla_force_host_platform_device_count=2``, as
``tests/test_tp.py`` runs it) and ``--xla_allow_excess_precision=false``
(see ``test_torch_serve.py``); it writes every output this file compares
to one ``.npz``.  The port's ranks are processes of a gloo group on the
CPU (``launch.mesh.spawn``).  Parity levels, as each test names them:

  * **bitwise**: ``tp_shard_mode`` on the cases of ``tests/test_tp.py``,
    and every packed tile ``shard_params`` cuts from the qwen1.5-0.5b
    smoke weights against the data of the reference's device shards
    (``wqkv`` after undoing the port's head regrouping);
  * **bitwise / tolerance**: K4 (``ops.nvfp4_matmul_tp``, its plain
    version here) against the reference's ``ops.nvfp4_matmul_tp``
    (Pallas in interpret mode under ``shard_map``) at M = 5 and M = 1:
    column bitwise; row within the reference's own rtol = atol = 2e-5,
    and bitwise equal to the sum of the port's two f32 partials;
  * **greedy tokens**: the tp = 2 engine on ``tests/test_tp.py``'s
    workload against the reference's tp = 2 engine and the port's
    single-device engine; tp = 4, where wd (K = 96, 6 blocks) cannot
    split in whole blocks and runs the replicated dequant fallback,
    against the single-device engine.
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import nvfp4, ptq
from repro_torch.distributed import sharding
from repro_torch.distributed.ctx import TP
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tp_mesh
from repro_torch.launch import serve, specs
from repro_torch.models import get_model
from repro_torch.serve import Engine

ARCH = "qwen1.5-0.5b"
GEN = 6
# tests/test_tp.py's engine: 3 slots over 12 blocks of 8
ENGINE = dict(n_slots=3, block_size=8, n_blocks=12, max_blocks_per_slot=4)
K4_RTOL = K4_ATOL = 2e-5
K4_MS = (5, 1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess, 2 devices)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.nvfp4 import PackedNVFP4 as JPacked
    from repro.distributed import sharding as jshd
    from repro.kernels import ops as jops
    from repro.launch import serve as jserve
    from repro.launch.mesh import make_host_mesh
    from repro.models import get_model as jget_model
    from repro.serve import Engine as JEngine

    res = {}
    mesh = make_host_mesh(model_parallel=2)
    rules = jshd.make_rules(mesh, "tp_only")

    # K4 (tests/test_tp.py::test_packed_gemm_shard_map_parity)
    rng = jax.random.PRNGKey(0)
    w = jax.random.normal(jax.random.fold_in(rng, 1), (64, 96), jnp.float32)
    packed = jops.pack_weight(w)
    res["k4/codes"] = np.asarray(packed.codes)
    res["k4/scales"] = np.asarray(packed.scales.astype(jnp.float32))
    res["k4/tensor_scale"] = np.asarray(packed.tensor_scale)
    for m in K4_MS:
        x = jax.random.normal(rng, (m, 64), jnp.bfloat16)
        res[f"k4/{m}/x"] = np.asarray(x.astype(jnp.float32))
        for mode in ("column", "row"):
            res[f"k4/{m}/{mode}"] = np.asarray(jops.nvfp4_matmul_tp(
                x, packed, mesh, mode, out_dtype=jnp.float32))

    # the smoke weights: dense init (bridged to the port) and the packed
    # tree's device shards
    cfg = jconfigs.get_smoke(ARCH)
    model = jget_model(cfg)
    dense = model.init_params(cfg, jax.random.PRNGKey(0))
    for key, a in _flat(dense).items():
        res[f"params/{key}"] = np.asarray(a.astype(jnp.float32))
    params, qcfg = jserve.load_quantized(cfg, jax.random.PRNGKey(0), "packed")
    sharded = jshd.shard_params(params, model.param_specs(cfg), mesh, rules)
    for name, leaf in sharded["layers"].items():
        if not isinstance(leaf, JPacked):
            continue
        for part in ("codes", "scales"):
            arr = getattr(leaf, part)
            shards = sorted(arr.addressable_shards,
                            key=lambda s: tuple(i.start or 0 for i in s.index))
            for i, sh in enumerate(shards):
                res[f"tiles/{name}/{part}/{i}"] = np.asarray(
                    sh.data.astype(jnp.float32))

    # the engine at tp = 2 and on one device (tests/test_tp.py's workload)
    prompts = jserve.mixed_prompts(jax.random.PRNGKey(1), 4, 4, 12,
                                   cfg.vocab_size)
    for i, p in enumerate(prompts):
        res[f"prompts/{i}"] = np.asarray(p, np.int32)
    for tag, m, r in (("tp2", mesh, rules), ("single", None, None)):
        eng = JEngine(cfg, params, qcfg, mesh=m, rules=r, **ENGINE)
        rids = [eng.submit(np.asarray(p), GEN) for p in prompts]
        outs = eng.drain(max_steps=500)
        res[f"engine/{tag}"] = np.stack([outs[i] for i in rids])
        if m is not None:
            rep = jserve.tp_shard_report(eng)
            for k, v in rep.items():
                res[f"report/{k}"] = np.asarray(v)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_tp_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=2"
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]))
    code = f"import test_torch_tp as t; t._reference({out!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _params(flat: dict):
    """The port's packed smoke weights: the reference's init bridged, the
    port's PTQ (bitwise the reference's, ``test_torch_nvfp4.py``)."""
    cfg = configs.get_smoke(ARCH)
    dense = params_from_numpy(_unflat(flat, "params/"), "cpu")
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format="packed")
    return cfg, ptq.quantize_weights(dense, get_model(cfg).param_specs(cfg), qc), qc


def _prompts(ref):
    n = sum(k.startswith("prompts/") for k in ref)
    return [ref[f"prompts/{i}"] for i in range(n)]


def _serve(eng, prompts):
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.drain(max_steps=500)
    return np.stack([outs[r] for r in rids])


def _cpu_tp(rank: int, size: int) -> TP:
    """A rank's context with no group: enough for sharding and for the
    engine's refusals, which come before any collective."""
    return TP(group=None, rank=rank, size=size, device=torch.device("cpu"))


# ---------------------------------------------------------------- ranks


def _k4_rank(tp, ref_k4: dict) -> dict:
    """K4 on this rank's tiles of the reference's packed weight."""
    p = params_from_numpy({"w": {
        "codes": ref_k4["k4/codes"], "scales": ref_k4["k4/scales"],
        "tensor_scale": ref_k4["k4/tensor_scale"], "orig_k": 64}}, "cpu")["w"]
    out = {}
    ops.reset_launches()
    for m in K4_MS:
        x = torch.from_numpy(ref_k4[f"k4/{m}/x"]).to(torch.bfloat16)
        for mode in ("column", "row"):
            tile = nvfp4.tp_tile(p, mode, tp.rank, tp.size)
            xl = x if mode == "column" else x.chunk(tp.size, -1)[tp.rank]
            out[f"{m}/{mode}"] = ops.nvfp4_matmul_tp(
                xl, tile, tp, mode, out_dtype=torch.float32).numpy()
            if mode == "row":
                out[f"{m}/part"] = ops.nvfp4_matmul(
                    xl, tile, out_dtype=torch.float32).numpy()
    out["launches"] = dict(ops.launches)
    return out


def _engine_rank(tp, flat: dict, prompts: list) -> dict:
    """The TP engine on the workload; its report, pool and launches; the
    fallback warnings of building it twice."""
    cfg, params, qcfg = _params(flat)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        Engine(cfg, params, qcfg, device="cpu", mesh=tp, **ENGINE)
        eng = Engine(cfg, params, qcfg, device="cpu", mesh=tp, **ENGINE)
    ops.reset_launches()
    toks = _serve(eng, prompts)
    return {"tokens": toks, "report": serve.tp_shard_report(eng),
            "leaked": eng.state.leaked(), "used": eng.pool.used_blocks,
            "fused": eng.fused, "launches": dict(ops.launches),
            "warnings": [str(w.message) for w in rec
                         if "sharding fallback" in str(w.message)]}


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("n_shards,parallelism", [
    (2, "column"), (2, "row"), (8, "row"), (64, "column"), (1, "column"),
    (2, None)])
def test_tp_shard_mode_bitwise(n_shards, parallelism):
    """Bitwise: the port's rule gives the reference's answer on the cases
    of ``tests/test_tp.py::test_tp_shard_mode_mirrors_resolve``."""
    from repro.core import nvfp4 as jnvfp4
    w = np.random.RandomState(0).randn(64, 96).astype(np.float32)
    want = jnvfp4.tp_shard_mode(jnvfp4.pack(np.ascontiguousarray(w.T)),
                                n_shards, parallelism)
    got = nvfp4.tp_shard_mode(nvfp4.pack(torch.from_numpy(w.T.copy())),
                              n_shards, parallelism)
    assert got == want


def test_shard_params_tiles_bitwise(ref):
    """Bitwise: every packed tile of ``shard_params`` at tp = 2 equals the
    data of the reference's device shard; ``wqkv``'s tiles, joined and put
    back in the reference's row order, equal its shards joined."""
    cfg, params, _ = _params(ref)
    pspecs = get_model(cfg).param_specs(cfg)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    rules = sharding.make_rules()
    tiles = [sharding.shard_params(params, pspecs, _cpu_tp(r, 2), rules,
                                    heads)
             for r in range(2)]
    names = sorted({k.split("/")[1] for k in ref if k.startswith("tiles/")})
    assert names == ["wd", "wg", "wo", "wqkv", "wu"]
    rows = sharding._qkv_rows(*heads, 2, "wqkv")
    for name in names:
        for part in ("codes", "scales"):
            got = [getattr(t["layers"][name], part).to(torch.float32).numpy()
                   for t in tiles]
            want = [ref[f"tiles/{name}/{part}/{i}"] for i in range(2)]
            if name == "wqkv":
                joined = np.concatenate(got, axis=-2)
                back = np.empty_like(joined)
                back[..., rows.numpy(), :] = joined
                np.testing.assert_array_equal(back, np.concatenate(want, -2))
            else:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
        full = params["layers"][name]
        for t in tiles:     # the global tensor scale, and a second cut is a no-op
            tile = t["layers"][name]
            # contiguous rows of whole 8-byte words: K2 reads codes so
            assert tile.codes.is_contiguous() and tile.codes.shape[-1] % 8 == 0
            assert torch.equal(tile.tensor_scale, full.tensor_scale)
            again = sharding.shard_params(t, pspecs, _cpu_tp(0, 2), rules,
                                           heads)
            assert again["layers"][name] is t["layers"][name]


def test_shard_cut_and_count_refuse_a_wrongly_cut_leaf():
    """A leaf held at neither its whole shape nor its tile's raises, in
    the cut and in the count; the count reads the shapes a rank holds, so
    the whole tree held by a rank counts nothing sharded."""
    cfg = configs.get_smoke(ARCH)
    params, _ = serve.load_quantized(cfg, 0, "packed", "cpu")
    pspecs = get_model(cfg).param_specs(cfg)
    rules = sharding.make_rules()
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    tiles = sharding.shard_params(params, pspecs, _cpu_tp(0, 2), rules, heads)
    got = sharding.shard_counts(pspecs, tiles, 2, rules)
    assert got["packed_sharded"] == got["packed_total"] == 5
    assert sharding.shard_counts(pspecs, params, 2, rules)["packed_sharded"] == 0
    bad_wo = nvfp4.tp_tile(params["layers"]["wo"], "row", 0, 4)
    with pytest.raises(ValueError, match="neither the whole"):
        sharding.shard_leaf(pspecs["layers"]["wo"], bad_wo, 0, 2, rules,
                            "layers.wo", heads)
    with pytest.raises(ValueError, match="layers.wo"):
        sharding.shard_counts(
            pspecs, {**tiles, "layers": {**tiles["layers"], "wo": bad_wo}},
            2, rules)
    bad_embed = params["embed"][: cfg.vocab_size // 4]
    with pytest.raises(ValueError, match="embed"):
        sharding.shard_leaf(pspecs["embed"], bad_embed, 0, 2, rules, "embed")


def test_k4_matches_reference(ref):
    """K4 on two gloo ranks against the reference's ``nvfp4_matmul_tp``:
    column bitwise; row within rtol = atol = 2e-5 and bitwise the sum of
    the two f32 partials; M = 5 and M = 1.  The CPU path runs the plain
    version and counts no launch."""
    k4 = {k: v for k, v in ref.items() if k.startswith("k4/")}
    ranks = tp_mesh.spawn(_k4_rank, 2, k4, device="cpu", timeout=300)
    for m in K4_MS:
        col = np.concatenate([r[f"{m}/column"] for r in ranks], -1)
        np.testing.assert_array_equal(col, ref[f"k4/{m}/column"])
        for r in ranks:
            np.testing.assert_allclose(r[f"{m}/row"], ref[f"k4/{m}/row"],
                                       rtol=K4_RTOL, atol=K4_ATOL)
            np.testing.assert_array_equal(
                r[f"{m}/row"], ranks[0][f"{m}/part"] + ranks[1][f"{m}/part"])
    assert all(r["launches"]["nvfp4_matmul_tp"] == 0 for r in ranks)


def test_engine_tp2_tokens_match_reference_and_single_device(ref):
    """Greedy tokens: the port's tp = 2 engine equals the reference's tp = 2
    engine and the port's single-device engine; every rank agrees and its
    pool drains; the shard report holds the reference's (and no MoE or
    FP8 leaf to split)."""
    cfg, params, qcfg = _params(ref)
    prompts = _prompts(ref)
    single = _serve(Engine(cfg, params, qcfg, device="cpu", **ENGINE), prompts)
    np.testing.assert_array_equal(single, ref["engine/single"])
    flat = {k: v for k, v in ref.items() if k.startswith("params/")}
    ranks = tp_mesh.spawn(_engine_rank, 2, flat, prompts, device="cpu",
                          timeout=600)
    want_rep = {k.split("/", 1)[1]: v.item() for k, v in ref.items()
                if k.startswith("report/")}
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], ref["engine/tp2"])
        np.testing.assert_array_equal(r["tokens"], single)
        assert not r["leaked"] and r["used"] == 0 and not r["fused"]
        # the reference's keys; the port's MoE and FP8 keys come after
        assert {k: r["report"][k] for k in want_rep} == want_rep
        assert not (r["report"]["experts_sharded"]
                    or r["report"]["fp8_scales_sharded"])
        assert r["warnings"] == []
    assert want_rep["packed_sharded"] == want_rep["packed_total"] == 5
    assert want_rep["kv_pool_bytes_per_device"] * 2 == want_rep["kv_pool_bytes_total"]


def test_engine_tp4_replicated_fallback_tokens(ref):
    """Greedy tokens at tp = 4: wd's K = 96 holds 6 blocks, which 4 does
    not divide, so wd stays replicated (warned once, naming it), its input
    is all-gathered and it runs dequantized; tokens equal the
    single-device engine's; the report counts wd unsharded."""
    cfg, params, qcfg = _params(ref)
    prompts = _prompts(ref)
    flat = {k: v for k, v in ref.items() if k.startswith("params/")}
    ranks = tp_mesh.spawn(_engine_rank, 4, flat, prompts, device="cpu",
                          timeout=600)
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], ref["engine/single"])
        assert not r["leaked"] and r["used"] == 0
        assert len(r["warnings"]) == 1 and "'layers.wd'" in r["warnings"][0]
        assert "packed K" in r["warnings"][0]
        rep = r["report"]
        assert (rep["packed_total"], rep["packed_sharded"]) == (5, 4)
        assert rep["kv_sharded"]
        assert rep["kv_pool_bytes_per_device"] * 4 == rep["kv_pool_bytes_total"]


def test_tp_refusals():
    """What TP does not serve raises before any collective: the fused
    tier forced on, KV heads that do not divide the group, an MoE
    config's shared expert or (under ``moe_shard="tp"``) expert FFN dim
    that does not divide it, a slab family's heads that do not divide it
    (rwkv6 smoke's 2 at tp = 4), rules without a mesh.  MoE and FP8-KV
    configs that divide are served (``test_torch_tp_serve.py``), and so
    are the slab families (``test_torch_tp_slab_*.py``)."""
    cfg = configs.get_smoke(ARCH)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    with pytest.raises(ValueError, match="single-device"):
        Engine(cfg, params, qcfg, device="cpu", mesh=_cpu_tp(0, 2),
               fused_kernels="on", **ENGINE)
    with pytest.raises(ValueError, match="mesh"):
        Engine(cfg, params, qcfg, device="cpu",
               rules=sharding.make_rules(), **ENGINE)
    acfg = configs.get_smoke("acereason-7b")          # 2 KV heads
    aparams, aq = serve.load_quantized(acfg, 0, "packed", "cpu")
    with pytest.raises(NotImplementedError, match="KV heads"):
        Engine(acfg, aparams, aq, device="cpu", mesh=_cpu_tp(0, 4), **ENGINE)
    mcfg = dataclasses.replace(configs.get_smoke("qwen2-moe-a2.7b"),
                               shared_d_ff=90)
    mparams, mq = serve.load_quantized(mcfg, 0, "packed", "cpu")
    with pytest.raises(NotImplementedError, match="shared_d_ff"):
        Engine(mcfg, mparams, mq, device="cpu", mesh=_cpu_tp(0, 4), **ENGINE)
    acfg = dataclasses.replace(configs.get_smoke("arctic-480b"),
                               moe_shard="tp", moe_d_ff=49)
    with pytest.raises(NotImplementedError, match="moe_d_ff"):
        Engine(acfg, {"embed": torch.zeros(1)}, device="cpu",
               mesh=_cpu_tp(0, 2), **ENGINE)
    with pytest.raises(NotImplementedError, match="rwkv6.*heads"):
        Engine(configs.get_smoke("rwkv6-3b"), {"embed": torch.zeros(1)},
               device="cpu", mesh=_cpu_tp(0, 4), **ENGINE)
    # a single-device engine is untouched by the TP code: fused on
    assert Engine(cfg, params, qcfg, device="cpu", **ENGINE).fused
