"""The decoder's remaining serving paths under tensor parallelism in the
PyTorch port (MoE with its experts split on E or on their FFN dim, FP8 KV
pages split by KV head, speculative decoding, the shadow teacher), on the
CPU, against the JAX package and the port's single-device engine.

The reference runs once, in a subprocess with two emulated host devices
(``--xla_force_host_platform_device_count=2``) and
``--xla_allow_excess_precision=false``, while the port's ranks run: it
places the port's weights and an FP8 pool with its own ``shard_params``
(which computes nothing, so it runs under jax 0.9.0) and serves arctic-480b
smoke on one device.  Its tensor-parallel MoE engine is not an oracle: its
f32-accumulating products under a mesh do not execute on XLA's CPU
runtime (``tests/test_tp.py::test_engine_tp_token_parity_moe_fp8``), and
that test asserts TP tokens equal single-device tokens, which is what the
port is held to here.  The port's ranks are processes of one gloo group
on the CPU (``launch.mesh.spawn``): every tp = 2 check runs in one spawn,
the tp = 4 one in another.  Parity levels, as each test names them:

  * **bitwise**: every expert-stack and router tile ``shard_params`` cuts
    (arctic-480b smoke with its experts split on E, packed and QDQ, and
    with ``moe_shard="tp"``, packed), and every FP8 pool tile (E4M3 pages,
    f32 scale planes), against the data of the reference's device shards;
  * **greedy tokens**: the tp = 2 engine on arctic-480b smoke (MoE, the
    FP8 pool, the dense residual; ``tests/test_tp.py``'s MoE workload)
    against the reference's single-device engine and the port's; arctic
    smoke under ``moe_shard="tp"`` at ``moe_d_ff`` 48 (blocks cross the
    cut: the hidden is gathered; packed, the down stack stays whole) and
    64 (two blocks a rank), and qwen2-moe smoke (shared expert, sigmoid
    gate), against the port's single-device engine; ``SpecEngine`` at
    tp = 2 with self-qdq (acceptance above 0.9), self-truncate, two-model
    drafts and adaptive k (``tests/test_tp.py``'s speculative workload)
    against the single-device plain engine; qwen2-moe smoke at tp = 4,
    where 6 experts do not divide 4, against the single-device engine;
  * **tolerance**: the shadow teacher at tp = 2 against the port's
    single-device shadow on the same contexts (``SHADOW_TOL``: SQNR 0.5
    dB, amax and hidden MSE rel 1e-2, live KL rel 5e-2), the same record
    on both ranks, tokens with the shadow on equal to those with it off;
  * the refusals that stay: a slab config whose heads do not divide the
    group (the plain and the speculative engine), ``fused_kernels="on"``
    with a mesh.
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
from repro_torch.bridge import to_numpy
from repro_torch.core import nvfp4
from repro_torch.distributed import sharding
from repro_torch.distributed.ctx import TP
from repro_torch.launch import mesh as tp_mesh
from repro_torch.launch import serve
from repro_torch.models import decoder, get_model
from repro_torch.models.common import tree_leaves
from repro_torch.obs import numerics as obs_numerics
from repro_torch.serve import Engine
from repro_torch.spec import SpecEngine
from test_torch_serve import _flat, _unflat

# tests/test_tp.py's MoE workload: 3 prompts of 4..10 tokens, 5 generated,
# 2 slots over 10 blocks of 8
MOE_ENGINE = dict(n_slots=2, block_size=8, n_blocks=10, max_blocks_per_slot=4)
MOE_LENS, MOE_GEN = (4, 7, 10), 5
# tests/test_tp.py's speculative workload: qwen1.5-0.5b smoke, packed, 3
# prompts, 6 generated, 2 slots over 12 blocks of 8
SPEC_ARCH = "qwen1.5-0.5b"
SPEC_ENGINE = dict(n_slots=2, block_size=8, n_blocks=12, max_blocks_per_slot=4)
SPEC_LENS, SPEC_GEN = (5, 8, 10), 6
# name -> (arch, moe_shard, moe_d_ff or None, weight format) of the MoE
# token runs at tp = 2
MOE_RUNS = {
    "arctic-ep": ("arctic-480b", "ep", None, "qdq"),
    "arctic-tp48": ("arctic-480b", "tp", 48, "packed"),
    "arctic-tp48-qdq": ("arctic-480b", "tp", 48, "qdq"),
    "arctic-tp64": ("arctic-480b", "tp", 64, "packed"),
    "qwen2-moe": ("qwen2-moe-a2.7b", "ep", None, "packed"),
}
# name -> (SpecEngine keywords) of the speculative runs at tp = 2
SPEC_RUNS = {
    "self-qdq": dict(draft_k=3, draft="self-qdq"),
    "self-truncate": dict(draft_k=3, draft="self-truncate", draft_layers=1),
    "two-model": dict(draft_k=2),
    "adaptive": dict(draft_k=3, draft="self-qdq", adaptive_k=True),
}
# name -> (moe_shard, weight format) of the tile checks (arctic smoke)
TILE_CASES = {"ep-packed": ("ep", "packed"), "ep-qdq": ("ep", "qdq"),
              "tp-packed": ("tp", "packed")}
TILE_LEAVES = ("router", "moe_wg", "moe_wu", "moe_wd")
# name -> (config, a self-qdq draft of it) of the "qdq" weight tile checks
QDQ_TILE_CASES = {
    "acereason": (lambda: configs.get_smoke("acereason-7b"), False),
    "acereason-self-qdq": (lambda: configs.get_smoke("acereason-7b"), True),
    "arctic-ep": (lambda: _moe_cfg("arctic-ep")[0], False),
    "arctic-tp48": (lambda: _moe_cfg("arctic-tp48-qdq")[0], False),
}
# an FP8 pool (arctic smoke: 2 KV heads of 16) of 6 blocks of 8
POOL_BLOCKS, POOL_BS = 6, 8
# the shadow's contexts and its tolerances (test_torch_obs.py's)
SHADOW_LENS = (5, 12, 17)
SHADOW_TOL = {"sqnr_db": ("abs", 0.5), "amax": ("rel", 1e-2),
              "hidden_mse": ("rel", 1e-2), "hidden_cos": ("abs", 1e-3),
              "kl": ("rel", 5e-2), "clip_frac": ("abs", 1e-2),
              "scale_util": ("abs", 1e-2), "top1_agree": ("abs", 0.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in lens]


def _moe_cfg(name):
    arch, shard, ffe, fmt = MOE_RUNS[name]
    cfg = dataclasses.replace(configs.get_smoke(arch), moe_shard=shard)
    if ffe:
        cfg = dataclasses.replace(cfg, moe_d_ff=ffe)
    return cfg, fmt


def _serve(eng, prompts, gen):
    rids = [eng.submit(p, gen) for p in prompts]
    outs = eng.drain(max_steps=500)
    return np.stack([outs[r] for r in rids])


def _cpu_tp(rank: int, size: int) -> TP:
    """A rank's context with no group: enough for sharding and for the
    engine's refusals, which come before any collective."""
    return TP(group=None, rank=rank, size=size, device=torch.device("cpu"))


def _pool(cfg):
    """A seeded FP8 pool (E4M3 bytes, f32 scales) of arctic smoke."""
    rng = np.random.default_rng(11)
    specs = decoder.paged_pool_specs(cfg, POOL_BLOCKS, POOL_BS)
    out = {}
    for name, spec in specs.items():
        if spec.dtype == torch.float8_e4m3fn:
            x = rng.standard_normal(spec.shape).astype(np.float32) * 8
            out[name] = torch.from_numpy(x).to(torch.float8_e4m3fn)
        else:
            out[name] = torch.from_numpy(
                rng.random(spec.shape).astype(np.float32))
    return out


def _tile_tree(case):
    """(cfg, the port's weights of arctic smoke under ``case``)."""
    shard, fmt = TILE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke("arctic-480b"),
                              moe_shard=shard)
    params, _ = serve.load_quantized(cfg, 0, fmt, "cpu")
    return cfg, params


# ---------------------------------------------------------------- reference


def _jtree(t):
    """A numpy tree (``bridge.to_numpy``'s, flattened and back) as the
    reference's: packed dicts as ``PackedNVFP4``, floats as bf16."""
    import jax.numpy as jnp

    from repro.core.nvfp4 import PackedNVFP4 as JPacked
    if isinstance(t, dict) and "codes" in t:
        return JPacked(jnp.asarray(t["codes"]),
                       jnp.asarray(t["scales"]).astype(jnp.float8_e4m3fn),
                       jnp.asarray(t["tensor_scale"]), int(t["orig_k"]))
    if isinstance(t, dict):
        return {k: _jtree(v) for k, v in t.items()}
    return jnp.asarray(t).astype(jnp.bfloat16)


def _shards(arr, raw: bool = False):
    """A placed array's device shards in mesh order, as numpy: floats as
    f32 (exact for bf16 and E4M3), or with ``raw`` E4M3 as its bytes."""
    import jax.numpy as jnp
    parts = sorted(arr.addressable_shards,
                   key=lambda s: tuple(i.start or 0 for i in s.index))
    out = []
    for sh in parts:
        d = sh.data
        if raw and d.dtype == jnp.float8_e4m3fn:
            out.append(np.asarray(d).view(np.uint8))
        elif d.dtype in (jnp.float8_e4m3fn, jnp.bfloat16):
            out.append(np.asarray(d.astype(jnp.float32)))
        else:
            out.append(np.asarray(d))
    return out


def _reference(in_path: str, out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess, 2 devices)."""
    import jax.numpy as jnp
    import ml_dtypes

    from repro import configs as jconfigs
    from repro.core.nvfp4 import PackedNVFP4 as JPacked
    from repro.distributed import sharding as jshd
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_host_mesh
    from repro.models import decoder as jdecoder
    from repro.models import get_model as jget_model
    from repro.serve import Engine as JEngine

    with np.load(in_path) as f:
        inp = dict(f)
    res = {}
    mesh = make_host_mesh(model_parallel=2)
    rules = jshd.make_rules(mesh, "tp_only")
    for case, (shard, _) in TILE_CASES.items():
        cfg = dataclasses.replace(jconfigs.get_smoke("arctic-480b"),
                                  moe_shard=shard)
        lspecs = jget_model(cfg).param_specs(cfg)["layers"]
        tree = _jtree(_unflat(inp, f"tiles/{case}/"))
        placed = jshd.shard_params(
            tree, {"layers": {k: lspecs[k] for k in TILE_LEAVES}}, mesh,
            rules)
        for name, leaf in placed["layers"].items():
            parts = (("codes", leaf.codes), ("scales", leaf.scales)) \
                if isinstance(leaf, JPacked) else (("data", leaf),)
            for part, arr in parts:
                for i, a in enumerate(_shards(arr)):
                    res[f"tiles/{case}/{name}/{part}/{i}"] = a
    cfg = jconfigs.get_smoke("arctic-480b")
    pool = {k: (jnp.asarray(inp[f"pool/{k}"].view(ml_dtypes.float8_e4m3fn))
                if k in ("k", "v") else jnp.asarray(inp[f"pool/{k}"]))
            for k in ("k", "v", "k_scale", "v_scale")}
    placed = jshd.shard_params(
        pool, jdecoder.paged_pool_specs(cfg, POOL_BLOCKS, POOL_BS), mesh,
        rules)
    for k, arr in placed.items():
        for i, a in enumerate(_shards(arr, raw=True)):
            res[f"pool/{k}/{i}"] = a
    # arctic smoke on one device, the port's QDQ weights
    params = _jtree(_unflat(inp, "engine/params/"))
    qcfg = dataclasses.replace(jspecs.recipe_qconfig(cfg), weight_format="qdq")
    eng = JEngine(cfg, params, qcfg, **MOE_ENGINE)
    prompts = [inp[f"engine/prompts/{i}"] for i in range(len(MOE_LENS))]
    rids = [eng.submit(p, MOE_GEN) for p in prompts]
    outs = eng.drain(max_steps=500)
    res["engine/tokens"] = np.stack([outs[r] for r in rids])
    np.savez(out_path, **res)


def _start_reference(tmp):
    """Write the reference's inputs and start its subprocess."""
    inp = {}
    for case in TILE_CASES:
        cfg, params = _tile_tree(case)
        sub = {k: params["layers"][k] for k in TILE_LEAVES}
        inp.update(_flat(to_numpy(sub), f"tiles/{case}/layers/"))
    cfg = configs.get_smoke("arctic-480b")
    for k, t in _pool(cfg).items():
        inp[f"pool/{k}"] = (t.view(torch.uint8).numpy()
                            if t.dtype == torch.float8_e4m3fn else t.numpy())
    acfg, _ = _moe_cfg("arctic-ep")
    params, _ = serve.load_quantized(acfg, 0, "qdq", "cpu")
    inp.update(_flat(to_numpy(params), "engine/params/"))
    for i, p in enumerate(_prompts(acfg.vocab_size, MOE_LENS, 1)):
        inp[f"engine/prompts/{i}"] = p
    in_path, out_path = str(tmp / "in.npz"), str(tmp / "ref.npz")
    np.savez(in_path, **inp)
    here = os.path.dirname(os.path.abspath(__file__))
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=2"
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]))
    code = (f"import test_torch_tp_serve as t; "
            f"t._reference({in_path!r}, {out_path!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out_path


def _finish_reference(proc, out_path):
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    with np.load(out_path) as data:
        return dict(data)


# ---------------------------------------------------------------- ranks


def _shadow_host(aux) -> dict:
    """A shadow record as {site/stat: f64 array} on the host."""
    return {f"{site}/{stat}": v.detach().to("cpu", torch.float64).numpy()
            for site, stats in aux.items() for stat, v in stats.items()}


def _shadow_contexts(vocab):
    return [np.asarray(p, np.int64) for p in _prompts(vocab, SHADOW_LENS, 9)]


def _shadow_engine(mesh=None, tp_loader=None, rate=0.5):
    """qwen1.5-0.5b smoke, packed, with the BF16 teacher (under TP the
    tile-by-tile loader's teacher when ``tp_loader`` is given)."""
    cfg = configs.get_smoke(SPEC_ARCH)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    teacher = serve.load_teacher(cfg, 0, "cpu", tp=tp_loader)
    return cfg, params, qcfg, Engine(
        cfg, params, qcfg, device="cpu", mesh=mesh, shadow_teacher=teacher,
        shadow_rate=rate, **SPEC_ENGINE)


def _probe_inputs():
    """An activation [3, 5, 64] (split on its features over the ranks)
    with its row amax, and a packed weight [48, 64] (tiles of 24 rows)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)
                         * 3).to(torch.bfloat16)
    amax = torch.amax(torch.abs(x.float()), dim=(1, 2), keepdim=True)
    w = nvfp4.pack(torch.from_numpy(rng.standard_normal((48, 64)).astype(
        np.float32)))
    return x, amax, w


def _rank_probes(tp) -> dict:
    """The probes of this rank's slices, reduced over the group."""
    x, amax, w = _probe_inputs()
    act = obs_numerics.quant_error_stats(x.chunk(tp.size, -1)[tp.rank],
                                         amax, tp)
    wst = obs_numerics.packed_weight_stats(
        nvfp4.tp_tile(w, "column", tp.rank, tp.size), tp)
    return {f"{site}/{k}": float(v) for site, st in (("act", act),
                                                     ("w", wst))
            for k, v in st.items()}


def _qdq_tiles(tp, cfg, draft: bool) -> dict:
    """A rank's ``"qdq"`` weights loaded tile by tile (``load_quantized(...,
    tp=)``; with ``draft``, a self-qdq draft of them) against its slices
    of the one-device ``"qdq"`` weights: the dense quantized leaves, those
    split over the group, and whether every leaf is bitwise its slice."""
    from repro_torch.spec import proposer
    tiles, qcfg = serve.load_quantized(cfg, 0, "qdq", "cpu", tp=tp)
    if draft:
        _, tiles = proposer.self_draft_model(cfg, tiles, "qdq")
    whole, _ = serve.load_quantized(cfg, 0, "qdq", "cpu")
    specs = get_model(cfg).param_specs(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cut = sharding.shard_params(whole, specs, tp, sharding.make_rules(),
                                    (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))
    out = {"quantized": 0, "split": 0, "equal": True}
    for sp, t, c, w in zip(*(tree_leaves(x) for x in (specs, tiles, cut,
                                                       whole))):
        if qcfg.quantizes(sp.kind):
            out["quantized"] += 1
            out["split"] += tuple(t.shape) != tuple(w.shape)
        out["equal"] &= torch.equal(t, c)
    return out


def _rank2(tp) -> dict:
    """Every tp = 2 check of a rank: the probe reductions, the "qdq" weight
    tiles, the MoE runs, the speculative runs, the shadow."""
    out = {"moe": {}, "spec": {}, "probes": _rank_probes(tp),
           "qdq_tiles": {name: _qdq_tiles(tp, make(), draft)
                         for name, (make, draft) in QDQ_TILE_CASES.items()}}
    for name in MOE_RUNS:
        cfg, fmt = _moe_cfg(name)
        # the tile-by-tile loader on one run, the engine's own cut on the rest
        params, qcfg = serve.load_quantized(
            cfg, 0, fmt, "cpu", tp=tp if name == "qwen2-moe" else None)
        eng = Engine(cfg, params, qcfg, device="cpu", mesh=tp, **MOE_ENGINE)
        toks = _serve(eng, _prompts(cfg.vocab_size, MOE_LENS, 1), MOE_GEN)
        out["moe"][name] = dict(
            tokens=toks, report=serve.tp_shard_report(eng),
            leaked=eng.state.leaked(), used=eng.pool.used_blocks,
            fused=eng.fused, stats=eng.stats(),
            k_scale=tuple(eng.pool.data.get("k_scale",
                                            torch.empty(0)).shape))
    cfg = configs.get_smoke(SPEC_ARCH)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    prompts = _prompts(cfg.vocab_size, SPEC_LENS, 2)
    for name, kw in SPEC_RUNS.items():
        kw = dict(kw)
        if name == "two-model":
            dcfg = dataclasses.replace(cfg, n_layers=1, name=f"{cfg.name}-2m")
            dparams, dq = serve.load_quantized(dcfg, 99, "qdq", "cpu", tp=tp)
            kw["draft_model"] = (dcfg, dparams, dq)
        eng = SpecEngine(cfg, params, qcfg, device="cpu", mesh=tp,
                         **SPEC_ENGINE, **kw)
        toks = _serve(eng, prompts, SPEC_GEN)
        out["spec"][name] = dict(
            tokens=toks, stats=eng.stats(), used=eng.pool.used_blocks,
            draft_heads=eng.proposer.data["k"].shape[3])
    _, _, _, eng = _shadow_engine(mesh=tp, tp_loader=tp)
    out["shadow"] = [_shadow_host(eng.shadow_score(c))
                     for c in _shadow_contexts(cfg.vocab_size)]
    out["shadow_tokens"] = _serve(eng, prompts, SPEC_GEN)
    out["shadow_steps"] = eng.shadow_steps
    plain = Engine(cfg, params, qcfg, device="cpu", mesh=tp, **SPEC_ENGINE)
    out["plain_tokens"] = _serve(plain, prompts, SPEC_GEN)
    return out


def _rank4(tp) -> dict:
    """qwen2-moe smoke at tp = 4 (the engine built twice: each fallback
    warns once)."""
    cfg = configs.get_smoke("qwen2-moe-a2.7b")
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        Engine(cfg, params, qcfg, device="cpu", mesh=tp, **MOE_ENGINE)
        eng = Engine(cfg, params, qcfg, device="cpu", mesh=tp, **MOE_ENGINE)
    toks = _serve(eng, _prompts(cfg.vocab_size, MOE_LENS, 1), MOE_GEN)
    return dict(tokens=toks, report=serve.tp_shard_report(eng),
                leaked=eng.state.leaked(),
                warnings=[str(w.message) for w in rec
                          if "sharding fallback" in str(w.message)])


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (a subprocess, started first), the port's two
    spawns and its single-device oracles, each computed once."""
    proc, out_path = _start_reference(tmp_path_factory.mktemp("jax_tp_serve"))
    try:
        ranks2 = tp_mesh.spawn(_rank2, 2, device="cpu", timeout=600)
        ranks4 = tp_mesh.spawn(_rank4, 4, device="cpu", timeout=600)
        single = {}
        for name in MOE_RUNS:
            cfg, fmt = _moe_cfg(name)
            params, qcfg = serve.load_quantized(cfg, 0, fmt, "cpu")
            single[name] = _serve(
                Engine(cfg, params, qcfg, device="cpu", **MOE_ENGINE),
                _prompts(cfg.vocab_size, MOE_LENS, 1), MOE_GEN)
        cfg = configs.get_smoke(SPEC_ARCH)
        params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
        single["spec-plain"] = _serve(
            Engine(cfg, params, qcfg, device="cpu", **SPEC_ENGINE),
            _prompts(cfg.vocab_size, SPEC_LENS, 2), SPEC_GEN)
        _, _, _, eng = _shadow_engine()
        single["shadow"] = [_shadow_host(eng.shadow_score(c))
                            for c in _shadow_contexts(cfg.vocab_size)]
    except BaseException:
        proc.kill()
        raise
    ref = _finish_reference(proc, out_path)
    return dict(ref=ref, tp2=ranks2, tp4=ranks4, single=single)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("case", sorted(QDQ_TILE_CASES))
def test_qdq_weight_tiles_are_slices_of_one_device_qdq(runs, case):
    """Bitwise (ROADMAP C.9): each rank's fake-quantized tile of every
    dense quantized weight (acereason smoke's "qdq" load, a self-qdq draft
    of it, arctic smoke's expert stacks on E and on their FFN dim) equals
    its slice of the one-device fake-quantized weight: the loader
    quantizes each whole leaf, with the whole weight's amax, before it
    cuts the rank's tile, and serving fake-quantizes no weight at run
    time."""
    for r in runs["tp2"]:
        got = r["qdq_tiles"][case]
        assert got["equal"], (case, got)
        assert got["quantized"] > 0 and got["split"] > 0, (case, got)


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_moe_tiles_bitwise(runs, case):
    """Bitwise: each rank's tile of the router and the expert stacks
    (arctic smoke, ``case``) equals the data of the reference's device
    shard; a stack the rules leave whole (the packed down stack at
    ``moe_d_ff`` 48 under ``moe_shard="tp"``: 3 blocks) is whole on both
    ranks and in both packages, and a second cut is a no-op."""
    ref = runs["ref"]
    cfg, params = _tile_tree(case)
    specs = get_model(cfg).param_specs(cfg)
    rules = sharding.make_rules()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tiles = [sharding.shard_params(params, specs, _cpu_tp(r, 2), rules,
                                        (cfg.n_heads, cfg.n_kv_heads,
                                         cfg.head_dim)) for r in range(2)]
    for name in TILE_LEAVES:
        leaf = params["layers"][name]
        parts = ("codes", "scales") if hasattr(leaf, "codes") else ("data",)
        for part in parts:
            for r, t in enumerate(tiles):
                got = t["layers"][name]
                got = getattr(got, part) if part != "data" else got
                np.testing.assert_array_equal(
                    got.to(torch.float32).numpy(),
                    ref[f"tiles/{case}/{name}/{part}/{r}"],
                    err_msg=f"{case} {name} {part} rank {r}")
        for t in tiles:
            got = t["layers"][name]
            if hasattr(leaf, "codes"):
                assert torch.equal(got.tensor_scale, leaf.tensor_scale)
            again = sharding.shard_params(t, specs, _cpu_tp(0, 2), rules,
                                          (cfg.n_heads, cfg.n_kv_heads,
                                           cfg.head_dim))
            assert again["layers"][name] is got
    whole = []
    for name in TILE_LEAVES:
        leaf = params["layers"][name]
        held = leaf.codes if hasattr(leaf, "codes") else leaf
        part = "codes" if hasattr(leaf, "codes") else "data"
        if ref[f"tiles/{case}/{name}/{part}/0"].shape == tuple(held.shape):
            whole.append(name)
    assert whole == (["moe_wd"] if case == "tp-packed" else [])


def test_fp8_pool_tiles_bitwise(runs):
    """Bitwise: the tiles of an FP8 pool (E4M3 pages and f32 scale planes
    of arctic smoke's 2 KV heads) equal the reference's device shards: one
    KV head and its scales a rank."""
    ref = runs["ref"]
    cfg = configs.get_smoke("arctic-480b")
    pool = _pool(cfg)
    specs = decoder.paged_pool_specs(cfg, POOL_BLOCKS, POOL_BS)
    for r in range(2):
        tile = sharding.shard_params(pool, specs, _cpu_tp(r, 2),
                                     sharding.make_rules())
        for k, t in tile.items():
            got = (t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn
                   else t.numpy())
            np.testing.assert_array_equal(got, ref[f"pool/{k}/{r}"])
            assert t.shape[3] == cfg.n_kv_heads // 2


def test_moe_fp8_engine_tp2_matches_reference_and_single_device(runs):
    """Greedy tokens: arctic-480b smoke (MoE with its experts split on E,
    the FP8 pool split by KV head with its scales, the dense residual) at
    tp = 2 equals the reference's single-device engine and the port's,
    on both ranks; the pools drain; the report says what is split."""
    want = runs["ref"]["engine/tokens"]
    np.testing.assert_array_equal(runs["single"]["arctic-ep"], want)
    cfg, _ = _moe_cfg("arctic-ep")
    for r in runs["tp2"]:
        got = r["moe"]["arctic-ep"]
        np.testing.assert_array_equal(got["tokens"], want)
        assert not got["leaked"] and got["used"] == 0 and not got["fused"]
        rep = got["report"]
        assert rep["experts_sharded"] and rep["fp8_scales_sharded"]
        assert rep["kv_sharded"] and got["stats"]["fp8"]
        assert rep["kv_pool_bytes_per_device"] * 2 == rep["kv_pool_bytes_total"]
        assert got["k_scale"][3] == cfg.n_kv_heads // 2


@pytest.mark.parametrize("name", ["arctic-tp48", "arctic-tp48-qdq",
                                  "arctic-tp64", "qwen2-moe"])
def test_moe_engine_tp2_matches_single_device(runs, name):
    """Greedy tokens: the tp = 2 engine equals the port's single-device
    engine on both ranks (``moe_shard="tp"`` at ``moe_d_ff`` 48: 24
    features a rank cross a 16-element block, so the hidden is gathered,
    and packed the down stack stays whole; at 64 two whole blocks a rank
    and a row-parallel down stack; qwen2-moe smoke: 3 experts a rank, the
    shared expert and its gate, loaded tile by tile); pools drain."""
    for r in runs["tp2"]:
        got = r["moe"][name]
        np.testing.assert_array_equal(got["tokens"], runs["single"][name])
        assert not got["leaked"] and got["used"] == 0
        rep = got["report"]
        assert rep["experts_sharded"] == (name != "arctic-tp48")
        if name in ("arctic-tp64", "qwen2-moe"):
            assert rep["packed_sharded"] == rep["packed_total"] > 0


@pytest.mark.parametrize("name", sorted(SPEC_RUNS))
def test_spec_engine_tp2_matches_single_device_plain(runs, name):
    """Greedy tokens: ``SpecEngine`` at tp = 2 (``name``'s draft) equals
    the single-device plain engine on both ranks (and the tp = 2 plain
    engine); drafted = accepted + rolled back; the draft pool holds the
    local KV heads; self-qdq accepts above 0.9; adaptive k picks the same
    lengths on both ranks."""
    want = runs["single"]["spec-plain"]
    cfg = configs.get_smoke(SPEC_ARCH)
    stats = []
    for r in runs["tp2"]:
        got = r["spec"][name]
        np.testing.assert_array_equal(got["tokens"], want)
        np.testing.assert_array_equal(r["plain_tokens"], want)
        st = got["stats"]
        assert st["drafted_tokens"] == (st["accepted_tokens"]
                                        + st["rolled_back_tokens"])
        assert got["used"] == 0
        assert got["draft_heads"] == cfg.n_kv_heads // 2
        stats.append(st)
    if name in ("self-qdq", "adaptive"):
        assert stats[0]["acceptance_rate"] > 0.9
    assert stats[0]["chosen_k_hist"] == stats[1]["chosen_k_hist"]
    assert stats[0]["accepted_tokens"] == stats[1]["accepted_tokens"]
    if name == "adaptive":
        assert stats[0]["chosen_k_hist"]


def _close(stat, got, want):
    kind, tol = SHADOW_TOL[stat]
    if kind == "abs":
        return np.all(np.abs(got - want) <= tol)
    return np.all(np.abs(got - want) <= tol * np.maximum(np.abs(want), 1e-12))


def test_shadow_tp2_matches_single_device(runs):
    """Tolerance (``SHADOW_TOL``): the shadow at tp = 2 (the teacher drawn
    tile by tile) records the sites and stats of the single-device shadow
    on the same contexts, within tolerance, the same record on both ranks
    bitwise; the engine's tokens with the shadow on equal those with it
    off."""
    single = runs["single"]["shadow"]
    r0, r1 = runs["tp2"]
    for mine, other, want in zip(r0["shadow"], r1["shadow"], single):
        assert sorted(mine) == sorted(want)
        for key in mine:
            np.testing.assert_array_equal(mine[key], other[key])
            stat = key.rsplit("/", 1)[1]
            assert _close(stat, mine[key], want[key]), (key, mine[key],
                                                        want[key])
    for r in (r0, r1):
        np.testing.assert_array_equal(r["shadow_tokens"], r["plain_tokens"])
        assert r["shadow_steps"] > 0


def test_probe_reductions_equal_the_whole_tensors(runs):
    """Tolerance (f32 sum order, rel 1e-6): a row site's activation probe
    over two ranks' feature slices (signal, noise, clip and scale sums
    added, amax the max) and a packed tile's weight probe (amax the max,
    scale use over every tile) equal the probes of the whole tensors, the
    same on both ranks."""
    x, amax, w = _probe_inputs()
    want = {**{f"act/{k}": float(v) for k, v in
               obs_numerics.quant_error_stats(x, amax).items()},
            **{f"w/{k}": float(v) for k, v in
               obs_numerics.packed_weight_stats(w).items()}}
    r0, r1 = (r["probes"] for r in runs["tp2"])
    assert r0 == r1 and sorted(r0) == sorted(want)
    for key, v in want.items():
        assert r0[key] == pytest.approx(v, rel=1e-6, abs=1e-9), key


def test_moe_engine_tp4_replicated_experts(runs):
    """Greedy tokens at tp = 4: qwen2-moe smoke's 6 experts do not divide
    4, so E stays whole (each of the router and the stacks warned once),
    the gate and up stacks split on the FFN dim (12 features a rank: the
    hidden is gathered) and the packed down stacks stay whole; tokens
    equal the single-device engine's on every rank."""
    want = runs["single"]["qwen2-moe"]
    for r in runs["tp4"]:
        np.testing.assert_array_equal(r["tokens"], want)
        assert not r["leaked"]
        assert len(r["warnings"]) == len(set(r["warnings"]))   # once each
        for leaf in ("layers.router", "layers.moe_wg", "layers.moe_wu",
                     "layers.moe_wd"):
            assert any(f"'{leaf}'" in w and "'expert'" in w
                       for w in r["warnings"]), leaf
        assert not r["report"]["experts_sharded"]


def test_tp_serve_cli_spec_and_shadow():
    """The CLI at tp = 2 on arctic smoke (MoE, FP8 pool) with a speculative
    draft and the shadow teacher: every check of ``run_engine`` holds
    (speculative streams equal the plain TP engine's)."""
    res = serve.main(["--device", "cpu", "--arch", "arctic-480b",
                      "--weight-format", "packed", "--engine", "--tp", "2",
                      "--requests", "4", "--gen", "6", "--speculative", "2",
                      "--shadow-rate", "0.5"])
    assert res["ok"] and res["tokens_match_serve_batch"]
    assert res["stats"]["speculative"] and res["stats"]["fp8"]


def test_tp_refusals_that_stay():
    """Raised before any collective: a slab config whose heads do not
    split over the group (rwkv6 smoke's 2 at tp = 4: the plain and the
    speculative engine, naming the heads), the fused tier forced on with
    a mesh."""
    rcfg = configs.get_smoke("rwkv6-3b")
    with pytest.raises(NotImplementedError, match="heads"):
        Engine(rcfg, {"embed": torch.zeros(1)}, device="cpu",
               mesh=_cpu_tp(0, 4))
    with pytest.raises(NotImplementedError, match="heads"):
        SpecEngine(rcfg, {"embed": torch.zeros(1)}, device="cpu",
                   mesh=_cpu_tp(0, 4))
    cfg = configs.get_smoke("arctic-480b")
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    with pytest.raises(ValueError, match="single-device"):
        Engine(cfg, params, qcfg, device="cpu", mesh=_cpu_tp(0, 2),
               fused_kernels="on", **MOE_ENGINE)
