"""RWKV6 and Whisper on the slab engine under tensor parallelism in the
PyTorch port (rwkv6-3b and whisper-tiny smoke, tp = 2), on the CPU,
against the JAX package and the port's single-device engine.

The reference runs once, in a subprocess with two emulated host devices
and ``--xla_allow_excess_precision=false``, while the port's ranks run
(``test_torch_tp_slab_rglru.py``'s machinery and workload: 3 slots,
prompts of 4, 11 and 16 tokens staggered, 6 tokens each; whisper's
requests with their own frames).  Parity levels, as each test names them:

  * **bitwise**: every weight tile ``shard_params`` cuts against the data
    of the reference's device shard; whisper's fused ``wqkv``/``bqkv``
    and cross-attention ``x_wqkv``/``x_bqkv`` against the reference's
    whole leaf regrouped by head;
  * **greedy tokens**: the port's tp = 2 slab engine against the
    reference's tp = 2 engine and the port's one-device engine; rwkv6's
    ``SpecEngine`` at tp = 2 (a self-qdq and a two-model draft) against
    the one-device plain engine; the CLI at tp = 2 on both configs
    against ``serve_batch``;
  * **tolerance**: each slot's prefill and decode logits against the
    one-device engine's at ``test_torch_engine.LOGIT_TOL``, and rwkv6's
    shadow teacher at tp = 2 against the one-device shadow at
    ``test_torch_tp_serve.SHADOW_TOL``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tp_mesh
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serve import Engine
from repro_torch.spec import SpecEngine
from test_torch_tp_serve import _close, _shadow_host
from test_torch_tp_slab_rglru import (GEN, SLAB_ENGINE, _finish_reference,
                                      _heads, _serve_rank, _single,
                                      _start_reference, _workload,
                                      check_logits, check_report,
                                      check_tiles, check_tokens)

RWKV, WHISPER = "rwkv6-3b", "whisper-tiny"
ARCHS = (RWKV, WHISPER)
# name -> SpecEngine keywords of rwkv6's speculative runs at tp = 2
SPEC_RUNS = {"self-qdq": dict(draft_k=2, draft="self-qdq"),
             "two-model": dict(draft_k=2)}
SHADOW_LENS = (5, 12, 17)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shadow_contexts(vocab):
    rng = np.random.default_rng(9)
    return [rng.integers(4, vocab, (n,)).astype(np.int64)
            for n in SHADOW_LENS]


def _shadow_records(cfg, mesh=None):
    """rwkv6 smoke's shadow record of each context (the BF16 teacher drawn
    tile by tile under ``mesh``)."""
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    teacher = serve.load_teacher(cfg, 0, "cpu", tp=mesh)
    eng = Engine(cfg, params, qcfg, device="cpu", mesh=mesh,
                 shadow_teacher=teacher, shadow_rate=0.5, **SLAB_ENGINE)
    return [_shadow_host(eng.shadow_score(c))
            for c in _shadow_contexts(cfg.vocab_size)]


def _rank(tp) -> dict:
    """Both configs at tp = 2 (whisper's weights tile by tile: its
    cross-attention leaves regrouped as they are drawn), rwkv6's
    speculative runs and its shadow."""
    out = {arch: _serve_rank(tp, arch, arch == WHISPER) for arch in ARCHS}
    cfg = configs.get_smoke(RWKV)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    prompts, _ = _workload(cfg)
    out["spec"] = {}
    for name, kw in SPEC_RUNS.items():
        kw = dict(kw)
        if name == "two-model":
            dcfg = dataclasses.replace(cfg, n_layers=1, name=f"{cfg.name}-2m")
            kw["draft_model"] = (dcfg, *serve.load_quantized(
                dcfg, 99, "qdq", "cpu", tp=tp))
        eng = SpecEngine(cfg, params, qcfg, device="cpu", mesh=tp,
                         **SLAB_ENGINE, **kw)
        _, outs = serve.run_workload(eng, prompts, GEN)
        out["spec"][name] = dict(tokens=np.stack([outs[r] for r in
                                                  sorted(outs)]),
                                 stats=eng.stats(), leaked=eng.state.leaked())
    out["shadow"] = _shadow_records(cfg, tp)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (a subprocess, started first), the port's tp = 2
    spawn and its one-device oracles, each computed once."""
    proc, out_path = _start_reference(
        tmp_path_factory.mktemp("jax_tp_slab_rwkv_whisper"), ARCHS)
    try:
        tp2 = tp_mesh.spawn(_rank, 2, device="cpu", timeout=600)
        single = {arch: _single(arch) for arch in ARCHS}
        single["shadow"] = _shadow_records(configs.get_smoke(RWKV))
    except BaseException:
        proc.kill()
        raise
    return dict(ref=_finish_reference(proc, out_path), tp2=tp2, single=single)


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_tiles_bitwise(runs, arch):
    """Bitwise: every tile of the packed smoke weights equals the
    reference's device shard (rwkv6's column and row projections, the
    local ``w0``, ``u``, ``ln_x`` and ``dec_w2``, the whole ddlerp;
    whisper's encoder, decoder and vocab-split embedding); each fused QKV
    leaf (whisper: ``wqkv``/``bqkv`` in the encoder and the decoder, and
    the cross-attention's ``x_wqkv``/``x_bqkv``) equals the reference's
    whole leaf at the rank's head rows."""
    assert check_tiles(runs["ref"], arch) == (0 if arch == RWKV else 6)


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_engine_tp2_tokens(runs, arch):
    """Greedy tokens: the tp = 2 slab engine equals the reference's tp = 2
    engine and the port's one-device engine on both ranks (whisper with
    each request's frames); the slots drain."""
    check_tokens(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_engine_tp2_logits(runs, arch):
    """Tolerance (``LOGIT_TOL``): every prefill and decode step's logits
    at tp = 2 against the one-device engine's."""
    check_logits(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_shard_report(runs, arch):
    """The report: every packed leaf split but RWKV's ``dec_w1`` and
    ``ts_w1``, which the rules keep whole; RWKV's WKV state split by head,
    its token-shift carries whole; whisper's self-attention KV split by
    head, ``enc_out`` whole."""
    check_report(runs, arch, lambda k: k in ("S", "k", "v"))
    rep = runs["tp2"][0][arch]["report"]
    assert rep["packed_rule_whole"] == (2 if arch == RWKV else 0)


@pytest.mark.parametrize("name", sorted(SPEC_RUNS))
def test_rwkv_spec_engine_tp2(runs, name):
    """Greedy tokens: rwkv6's ``SpecEngine`` at tp = 2 (``name``'s draft,
    rolled back through snapshots of the rank's state tiles) equals the
    one-device plain engine on both ranks; drafted = accepted + rolled
    back; a self-qdq draft accepts everything; the ranks agree."""
    want = runs["single"][RWKV]["tokens"]
    stats = []
    for r in runs["tp2"]:
        got = r["spec"][name]
        np.testing.assert_array_equal(got["tokens"], want)
        st = got["stats"]
        assert st["drafted_tokens"] == (st["accepted_tokens"]
                                        + st["rolled_back_tokens"]) > 0
        assert not got["leaked"]
        stats.append(st)
    if name == "self-qdq":
        assert stats[0]["acceptance_rate"] == 1.0
    assert stats[0]["accepted_tokens"] == stats[1]["accepted_tokens"]


def test_rwkv_shadow_tp2_matches_single_device(runs):
    """Tolerance (``SHADOW_TOL``): rwkv6's shadow at tp = 2 (the teacher
    drawn tile by tile, the probes reduced over the group) records the
    sites and stats of the one-device shadow on the same contexts, within
    tolerance, and the same record on both ranks bitwise."""
    single = runs["single"]["shadow"]
    r0, r1 = runs["tp2"]
    for mine, other, want in zip(r0["shadow"], r1["shadow"], single):
        assert sorted(mine) == sorted(want) and mine
        for key in mine:
            np.testing.assert_array_equal(mine[key], other[key])
            assert _close(key.rsplit("/", 1)[1], mine[key], want[key]), (
                key, mine[key], want[key])


def test_fused_qkv_regroups_cross_attention():
    """Unit: whisper's cross-attention leaves ``x_wqkv`` (packed) and
    ``x_bqkv`` match ``FUSED_QKV`` by suffix and are regrouped by head:
    rank r's tile is its query, key and value heads' rows, not the
    contiguous half."""
    cfg = configs.get_smoke(WHISPER)
    params, _ = serve.load_quantized(cfg, 0, "packed", "cpu")
    pspecs = get_model(cfg).param_specs(cfg)
    rules = sharding.make_rules()
    heads = _heads(cfg)
    assert sharding._fused("dec_layers.x_wqkv")
    assert sharding._fused("dec_layers.x_bqkv")
    assert not sharding._fused("dec_layers.x_wo")
    rows = sharding._qkv_rows(*heads, 2, "x_wqkv")
    per = len(rows) // 2
    w = params["dec_layers"]["x_wqkv"]
    # the bias is initialised to zeros: an arange shows its order
    spec_b = pspecs["dec_layers"]["x_bqkv"]
    b = torch.arange(int(np.prod(spec_b.shape)), dtype=torch.float32) \
        .reshape(spec_b.shape).to(torch.bfloat16)
    for r in range(2):
        mine = rows[r * per:(r + 1) * per]
        tile = sharding.shard_leaf(pspecs["dec_layers"]["x_wqkv"], w, r, 2,
                                   rules, "dec_layers.x_wqkv", heads)
        assert torch.equal(tile.codes, w.codes[..., mine, :])
        assert torch.equal(tile.scales.view(torch.uint8),
                           w.scales[..., mine, :].view(torch.uint8))
        bt = sharding.shard_leaf(spec_b, b, r, 2, rules, "dec_layers.x_bqkv",
                                 heads)
        assert torch.equal(bt, b[..., mine])
        assert not torch.equal(bt, b.chunk(2, -1)[r])


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serve_cli_slab(arch):
    """The CLI at tp = 2 on a slab config (whisper with each request's
    frames): every check of ``run_engine`` holds, each rank's tokens equal
    to ``serve_batch`` on the full weights."""
    res = serve.main(["--device", "cpu", "--arch", arch, "--weight-format",
                      "packed", "--engine", "--tp", "2", "--requests", "4",
                      "--gen", "5"])
    assert res["ok"] and res["tokens_match_serve_batch"]
    assert res["pool_drained"]
