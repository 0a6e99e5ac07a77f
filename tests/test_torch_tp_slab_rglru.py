"""The RG-LRU hybrids on the slab engine under tensor parallelism in the
PyTorch port (nemotron-nano-9b-sim and recurrentgemma-2b smoke, tp = 2),
on the CPU, against the JAX package and the port's single-device engine.

The reference runs once, in a subprocess with two emulated host devices
(``--xla_force_host_platform_device_count=2``) and
``--xla_allow_excess_precision=false``, while the port's ranks run: its
tp = 2 engine (GSPMD over ``make_rules(mesh, "tp_only")``) serves the
port's packed weights of each config (the port's PTQ, bitwise the
reference's) on the workload below and writes every weight's device
shards.  The port's ranks are processes of one gloo group on the CPU
(``launch.mesh.spawn``).  Parity levels, as each test names them:

  * **bitwise**: every weight tile ``shard_params`` cuts against the data
    of the reference's device shard; the fused QKV leaves against the
    reference's whole leaf regrouped by head (recurrentgemma's one KV
    head replicated in both ranks' tiles);
  * **greedy tokens**: the port's tp = 2 slab engine against the
    reference's tp = 2 engine and the port's one-device engine (3 slots,
    prompts of 4, 11 and 16 tokens staggered, 6 tokens each:
    recurrentgemma's smoke window of 16 wraps);
  * **tolerance**: each slot's prefill and decode logits against the
    one-device engine's at ``test_torch_engine.LOGIT_TOL``.

The helpers here serve ``test_torch_tp_slab_rwkv_whisper.py`` too.
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
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tp_mesh
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serve import Engine
from test_torch_engine import LOGIT_TOL
from test_torch_serve import _flat, _unflat
from test_torch_tp_serve import _cpu_tp, _jtree, _prompts, _shards

ARCHS = ("nemotron-nano-9b-sim", "recurrentgemma-2b")
# the reference's tp = 2 slab engine as it was checked against its
# one-device engine: 3 slots, s_alloc 32, prompts of 4, 11 and 16 tokens
SLAB_ENGINE = dict(n_slots=3, block_size=8, n_blocks=12, max_blocks_per_slot=4)
LENS, GEN = (4, 11, 16), 6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(cfg):
    """(prompts, extras): seeded prompts of ``LENS``, and for an
    encoder-decoder each request's own frames (else None)."""
    prompts = _prompts(cfg.vocab_size, LENS, 3)
    extras = None
    if cfg.family == "encdec":
        extras = [{"enc_frames": f} for f in serve.enc_frames(cfg, len(LENS),
                                                                0)]
    return prompts, extras


def _heads(cfg):
    return (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _run(eng, prompts, extras):
    """The staggered workload through ``eng`` (``serve.run_workload``),
    with each request's prefill logits and each decode step's logits and
    active mask kept on the host."""
    pre, dec = {}, []
    prefill, decode = eng._prefill_exact, eng.state.decode

    def keep_prefill(req):
        lg = prefill(req)
        pre[req.rid] = lg.float().clone()
        return lg

    def keep_decode(reqs, toks, lens, active):
        lg = decode(reqs, toks, lens, active)
        dec.append((lg[:, -1].float().clone(), active.copy()))
        return lg

    eng._prefill_exact, eng.state.decode = keep_prefill, keep_decode
    rids, outs = serve.run_workload(eng, prompts, GEN, extras)
    return dict(tokens=np.stack([outs[r] for r in rids]),
                pre=[pre[r] for r in rids], dec=dec,
                leaked=eng.state.leaked(), stats=eng.stats())


def _serve_rank(tp, arch, tile_loader: bool) -> dict:
    """One config at tp = 2 on this rank: its run (``_run``) and the shard
    report; with ``tile_loader`` the weights are drawn tile by tile."""
    cfg = configs.get_smoke(arch)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu",
                                        tp=tp if tile_loader else None)
    eng = Engine(cfg, params, qcfg, device="cpu", mesh=tp, **SLAB_ENGINE)
    out = _run(eng, *_workload(cfg))
    out["report"] = serve.tp_shard_report(eng)
    return out


def _single(arch) -> dict:
    """The port's one-device slab engine on the workload."""
    cfg = configs.get_smoke(arch)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    return _run(Engine(cfg, params, qcfg, device="cpu", **SLAB_ENGINE),
                *_workload(cfg))


# ---------------------------------------------------------------- reference


def _reference(in_path: str, out_path: str, archs) -> None:
    """The reference's tp = 2 engine on each config (runs in the JAX
    subprocess, 2 devices): its tokens and its weights' device shards."""
    from repro import configs as jconfigs
    from repro.core.nvfp4 import PackedNVFP4 as JPacked
    from repro.distributed import sharding as jshd
    from repro.launch import serve as jserve
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_host_mesh
    from repro.serve import Engine as JEngine

    with np.load(in_path) as f:
        inp = dict(f)
    res = {}
    mesh = make_host_mesh(model_parallel=2)
    rules = jshd.make_rules(mesh, "tp_only")
    for arch in archs:
        cfg = jconfigs.get_smoke(arch)
        params = _jtree(_unflat(inp, f"{arch}/params/"))
        qcfg = dataclasses.replace(jspecs.recipe_qconfig(cfg),
                                   weight_format="packed")
        eng = JEngine(cfg, params, qcfg, mesh=mesh, rules=rules,
                      **SLAB_ENGINE)
        n = len(LENS)
        prompts = [inp[f"{arch}/prompts/{i}"] for i in range(n)]
        extras = ([{"enc_frames": inp[f"{arch}/frames/{i}"]}
                   for i in range(n)] if f"{arch}/frames/0" in inp
                  else [None] * n)
        rids, outs = jserve._run_workload(eng, prompts, extras, GEN)
        res[f"{arch}/tokens"] = np.stack([np.asarray(outs[r]) for r in rids])
        for key, leaf in _flat(eng.params).items():
            parts = (("codes", leaf.codes), ("scales", leaf.scales)) \
                if isinstance(leaf, JPacked) else (("data", leaf),)
            for part, arr in parts:
                for i, a in enumerate(_shards(arr)):
                    res[f"{arch}/tiles/{key}/{part}/{i}"] = a
    np.savez(out_path, **res)


def _start_reference(tmp, archs):
    """Write the reference's inputs (the port's packed weights, prompts,
    frames) and start its subprocess; returns (process, output path)."""
    inp = {}
    for arch in archs:
        cfg = configs.get_smoke(arch)
        params, _ = serve.load_quantized(cfg, 0, "packed", "cpu")
        inp.update(_flat(to_numpy(params), f"{arch}/params/"))
        prompts, extras = _workload(cfg)
        for i, p in enumerate(prompts):
            inp[f"{arch}/prompts/{i}"] = p
            if extras:
                inp[f"{arch}/frames/{i}"] = extras[i]["enc_frames"]
    in_path, out_path = str(tmp / "in.npz"), str(tmp / "ref.npz")
    np.savez(in_path, **inp)
    here = os.path.dirname(os.path.abspath(__file__))
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=2"
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]))
    code = ("import test_torch_tp_slab_rglru as t; "
            f"t._reference({in_path!r}, {out_path!r}, {tuple(archs)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out_path


def _finish_reference(proc, out_path):
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    with np.load(out_path) as data:
        return dict(data)


# ---------------------------------------------------------------- checks


def check_tiles(ref, arch):
    """Every leaf's tile on each rank against the reference's shard r, a
    fused QKV leaf's against the reference's whole leaf (its shards
    joined) at the rank's regrouped rows; a second cut is a no-op."""
    cfg = configs.get_smoke(arch)
    params, _ = serve.load_quantized(cfg, 0, "packed", "cpu")
    pspecs = get_model(cfg).param_specs(cfg)
    rules = sharding.make_rules()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tiles = [sharding.shard_params(params, pspecs, _cpu_tp(r, 2), rules,
                                        _heads(cfg)) for r in range(2)]
    fused = set()
    for key, leaf in _flat(params).items():
        path = key.replace("/", ".")
        parts = ("codes", "scales") if hasattr(leaf, "codes") else ("data",)
        for part in parts:
            want = [ref[f"{arch}/tiles/{key}/{part}/{i}"] for i in range(2)]
            got = [_flat(t)[key] for t in tiles]
            got = [(getattr(g, part) if part != "data" else g)
                   .to(torch.float32).numpy() for g in got]
            if sharding._fused(path):
                n_axis = -2 if part != "data" else -1
                whole = np.concatenate(want, n_axis)    # split contiguously
                rows = sharding._qkv_rows(*_heads(cfg), 2, path).numpy()
                per = len(rows) // 2
                for r, g in enumerate(got):
                    np.testing.assert_array_equal(
                        g, np.take(whole, rows[r * per:(r + 1) * per], n_axis),
                        err_msg=f"{arch} {key} {part} rank {r}")
                fused.add(key)
            else:
                for r, (g, w) in enumerate(zip(got, want)):
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{arch} {key} {part} rank {r}")
    for t in tiles:
        again = sharding.shard_params(t, pspecs, _cpu_tp(0, 2), rules,
                                      _heads(cfg))
        for a, b in zip(_flat(again).values(), _flat(t).values()):
            assert a is b
    return len(fused)


def check_tokens(runs, arch):
    """Greedy tokens of both ranks against the reference's tp = 2 engine
    and the port's one-device engine; the slots drain."""
    want = runs["ref"][f"{arch}/tokens"]
    np.testing.assert_array_equal(runs["single"][arch]["tokens"], want)
    for r in runs["tp2"]:
        got = r[arch]
        np.testing.assert_array_equal(got["tokens"], want)
        assert not got["leaked"] and got["stats"]["used_slots"] == 0


def check_logits(runs, arch):
    """Each request's prefill logits and each decode step's active slots'
    logits on both ranks within ``LOGIT_TOL`` of the one-device engine's
    (the same schedule: every step's active mask equal)."""
    single = runs["single"][arch]
    for r in runs["tp2"]:
        got = r[arch]
        for g, w in zip(got["pre"], single["pre"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
        assert len(got["dec"]) == len(single["dec"]) > 0
        for (g, ga), (w, wa) in zip(got["dec"], single["dec"]):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_allclose(g[ga].numpy(), w[wa].numpy(),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)


def check_report(runs, arch, split):
    """The shard report on both ranks: every packed leaf split but those
    the rules keep whole, each state leaf split where ``split(path)`` says
    and whole elsewhere (a split leaf's bytes half one card's), the
    state's bytes a slot on the rank and over the group."""
    for r in runs["tp2"]:
        rep = r[arch]["report"]
        assert rep["packed_sharded"] == (rep["packed_total"]
                                         - rep["packed_rule_whole"]) > 0
        leaves = rep["state_leaves"]
        assert {k: v["split"] for k, v in leaves.items()} == {
            k: split(k) for k in leaves}
        mine = sum(v["bytes"] for v in leaves.values())
        total = sum(v["bytes"] * (2 if v["split"] else 1)
                    for v in leaves.values())
        n = SLAB_ENGINE["n_slots"]
        assert rep["state_bytes_per_slot"] * n == mine
        assert rep["state_bytes_per_slot_total"] * n == total
        assert rep["kv_sharded"] == any(v["split"] for v in leaves.values())


# ---------------------------------------------------------------- this file


def _rank(tp) -> dict:
    """Both configs at tp = 2 (recurrentgemma's weights tile by tile)."""
    return {arch: _serve_rank(tp, arch, arch == "recurrentgemma-2b")
            for arch in ARCHS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (a subprocess, started first), the port's tp = 2
    spawn and its one-device engines, each computed once."""
    proc, out_path = _start_reference(
        tmp_path_factory.mktemp("jax_tp_slab_rglru"), ARCHS)
    try:
        tp2 = tp_mesh.spawn(_rank, 2, device="cpu", timeout=600)
        single = {arch: _single(arch) for arch in ARCHS}
    except BaseException:
        proc.kill()
        raise
    return dict(ref=_finish_reference(proc, out_path), tp2=tp2, single=single)


@pytest.mark.parametrize("arch", ARCHS)
def test_rglru_tiles_bitwise(runs, arch):
    """Bitwise: every tile of the packed smoke weights (``wx``, ``w_a``,
    the conv, ``lam``, the BF16 attention, the vocab-split embedding and
    head) equals the reference's device shard; ``wqkv`` equals the
    reference's whole leaf at the rank's head rows (recurrentgemma: its 2
    query heads and the one KV head, replicated)."""
    assert check_tiles(runs["ref"], arch) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_rglru_engine_tp2_tokens(runs, arch):
    """Greedy tokens: the tp = 2 slab engine equals the reference's tp = 2
    engine and the port's one-device engine on both ranks (recurrentgemma
    past its 16-token window); the slots drain."""
    check_tokens(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_rglru_engine_tp2_logits(runs, arch):
    """Tolerance (``LOGIT_TOL``): every prefill and decode step's logits
    at tp = 2 against the one-device engine's."""
    check_logits(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_rglru_shard_report(runs, arch):
    """The report: every packed leaf split; the conv and ``h`` state split
    on ``d_rnn``; nemotron's dense KV split by KV head, recurrentgemma's
    ring (one KV head) whole on both ranks."""
    mqa = arch == "recurrentgemma-2b"
    check_report(runs, arch,
                 lambda k: not (mqa and k.startswith("blocks.kv.")))


def test_mqa_tile_shape():
    """Unit: at tp = 2 recurrentgemma's fused QKV tile is the rank's query
    heads and the whole KV head ((2 + 2) heads of 16 at smoke size, not
    the contiguous half's 3); the cut accepts that shape and no other, and
    the count reads it as split; KV heads that neither divide nor number
    one raise."""
    cfg = configs.get_smoke("recurrentgemma-2b")
    params, _ = serve.load_quantized(cfg, 0, "packed", "cpu")
    pspecs = get_model(cfg).param_specs(cfg)
    rules = sharding.make_rules()
    heads = _heads(cfg)
    hd = cfg.head_dim
    rows = sharding._qkv_rows(*heads, 2, "wqkv")
    q, k, v = 0, cfg.n_heads * hd, (cfg.n_heads + 1) * hd
    want = np.concatenate([np.arange(q, q + 2 * hd), np.arange(k, k + hd),
                           np.arange(v, v + hd),
                           np.arange(q + 2 * hd, q + 4 * hd),
                           np.arange(k, k + hd), np.arange(v, v + hd)])
    np.testing.assert_array_equal(rows.numpy(), want)
    spec = pspecs["blocks"]["attn"]["wqkv"]
    w = params["blocks"]["attn"]["wqkv"]
    tile = sharding.shard_leaf(spec, w, 1, 2, rules, "blocks.attn.wqkv",
                               heads)
    assert tile.shape[-1] == (cfg.n_heads // 2 + 2) * hd == 64
    assert sharding.shard_leaf(spec, tile, 1, 2, rules, "blocks.attn.wqkv",
                               heads) is tile
    half = w[..., : cfg.qkv_dim // 2]
    with pytest.raises(ValueError, match="neither the whole"):
        sharding.shard_leaf(spec, half, 0, 2, rules, "blocks.attn.wqkv",
                            heads)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tiles = sharding.shard_params(params, pspecs, _cpu_tp(0, 2), rules,
                                      heads)
    got = sharding.shard_counts(pspecs, tiles, 2, rules, heads)
    assert got["packed_sharded"] == got["packed_total"] > 0
    with pytest.raises(NotImplementedError, match="KV heads"):
        sharding._qkv_rows(6, 3, hd, 2, "wqkv")


def test_rglru_refusals():
    """Raised before any collective, naming the dim: ``d_rnn`` that does
    not split in whole 16-value blocks, query heads that do not divide,
    KV heads that neither divide nor number one."""
    cfg = configs.get_smoke("nemotron-nano-9b-sim")
    cases = ((dataclasses.replace(cfg, d_rnn=48), 2, "d_rnn"),
             (cfg, 8, "query heads"),
             (dataclasses.replace(cfg, n_heads=6, n_kv_heads=3), 2,
              "KV heads"))
    for c, size, what in cases:
        with pytest.raises(NotImplementedError, match=what):
            Engine(c, {"embed": torch.zeros(1)}, device="cpu",
                   mesh=_cpu_tp(0, size), **SLAB_ENGINE)
