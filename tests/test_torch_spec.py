"""Speculative decoding in the PyTorch port (``repro_torch.spec``), on the
CPU, against the port's plain engine and the JAX package.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (``test_torch_rwkv6.run_reference``).
With that flag the reference's own ``tests/test_spec.py::
test_verify_step_bitwise_matches_sequential[qwen1.5-0.5b]`` passes; with
XLA's default it fails (its jitted verify keeps bf16 intermediates in f32
where its eager decode does not: ROADMAP C.2 (b)).  The port's bitwise
verify test below holds ``verify_step_paged`` to the port's own sequential
``decode_step_paged``.

Parity levels, as each test names them:

  * **bitwise**: ``speculative_verify_tokens`` on the reference's unit
    cases (the greedy chain, an identical draft always accepted, a token
    of zero target mass rejected); ``verify_step_paged`` at per-token
    scales against sequential ``decode_step_paged`` calls, per position;
    the drafted, accepted and rolled-back counts and the verify steps of
    a greedy workload against the reference's ``SpecEngine.stats()``;
  * **distribution**: seeded stochastic verify over 20000 draws at V = 8:
    the emitted first token's counts against the target's
    ``filtered_probs``, chi-square below 24.32 (the 0.999 quantile at 7
    degrees of freedom);
  * **greedy tokens**: ``SpecEngine`` against the port's plain ``Engine``
    on the same requests, for every draft mode (self-qdq on qdq and
    packed weights, self-truncate, two-model), FP8-KV MoE (arctic-480b
    smoke), EOS mid-pack, adaptive k, and a slab family (rwkv6-3b smoke)
    through ``SlabDraftProposer`` with a two-model draft; and against the
    reference's ``SpecEngine``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.nvfp4 import PackedNVFP4
from repro_torch.launch import serve
from repro_torch.models import common, decoder
from repro_torch.serve import Engine, SamplingParams
from repro_torch.serve.sampling import (filtered_probs,
                                        speculative_verify_tokens)
from repro_torch.spec import SpecEngine, self_draft_model
from test_torch_engine import _port
from test_torch_rwkv6 import run_reference
from test_torch_serve import _flat

ARCH = "qwen1.5-0.5b"
GEN = 5
ENG_KW = dict(n_slots=2, block_size=8, max_blocks_per_slot=4, n_blocks=16,
              device="cpu")
REF_LENS = (5, 13, 13, 5)
COUNTS = ("verify_steps", "verify_slot_rounds", "drafted_tokens",
          "accepted_tokens", "rolled_back_tokens")
# chi-square's 0.999 quantile at 7 degrees of freedom (V = 8)
CHI2_BOUND = 24.32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in lens]


def _drain(eng, prompts, gen=GEN, sampling=None):
    rids = [eng.submit(p, gen, sampling=sampling) for p in prompts]
    out = eng.drain(max_steps=500)
    assert not eng.state.leaked()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def loaded():
    cfg = configs.get_smoke(ARCH)
    return cfg, {fmt: serve.load_quantized(cfg, 0, fmt, "cpu")
                 for fmt in ("qdq", "packed")}


def _reference(out_path: str) -> None:
    """The reference's SpecEngine on a greedy workload (runs in the JAX
    subprocess)."""
    import jax

    from repro import configs as jconfigs
    from repro.launch import serve as jserve
    from repro.models import get_model as jget_model
    from repro.spec import SpecEngine as JSpec

    res = {}
    cfg = jconfigs.get_smoke(ARCH)
    dense = jget_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    for key, a in _flat(dense).items():
        res[f"{ARCH}/params/{key}"] = np.asarray(a.astype(np.float32))
    params, qcfg = jserve.load_quantized(cfg, jax.random.PRNGKey(0), "qdq")
    kw = {k: v for k, v in ENG_KW.items() if k != "device"}
    prompts = _prompts(cfg.vocab_size, REF_LENS)
    for draft in ("self-qdq", "self-truncate"):
        eng = JSpec(cfg, params, qcfg, draft_k=3, draft=draft, draft_layers=1,
                    **kw)
        rids = [eng.submit(p, GEN) for p in prompts]
        out = eng.drain(max_steps=500)
        res[f"spec/{draft}/out"] = np.stack([out[r] for r in rids])
        st = eng.stats()
        res[f"spec/{draft}/counts"] = np.asarray([st[k] for k in COUNTS])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_spec_ref") / "ref.npz")
    return run_reference("test_torch_spec", out)


# ---------------------------------------------------------------------------
# accept / resample
# ---------------------------------------------------------------------------


def _chain_logits(chain, v, k1):
    lg = torch.zeros((1, k1, v))
    for i, t in enumerate(chain):
        lg[0, i, t] = 5.0
    return lg


def test_accept_greedy_chain():
    """Bitwise (token ids): the reference's four greedy cases."""
    v, k = 16, 3
    chain = [4, 7, 9, 11]
    lg = _chain_logits(chain, v, k + 1)
    args = ([0.0], [0], [0], [0])
    for draft, n_prop, n_acc_want, emitted in (
            ([4, 7, 1], k, 2, chain[:3]), (chain[:k], k, k, chain),
            ([1, 2, 3], k, 0, chain[:1]), ([1, 2, 3], 0, 0, chain[:1])):
        out, n_emit, n_acc = speculative_verify_tokens(
            lg, torch.tensor([draft]), None, [n_prop], *args)
        assert int(n_acc[0]) == n_acc_want
        assert int(n_emit[0]) == n_acc_want + 1
        assert out[0, :len(emitted)].tolist() == emitted
        assert not out[0, len(emitted):].any()


def test_accept_identical_draft_always_accepts():
    """q == p accepts every proposal (u q < p for every u < 1) and draws a
    bonus token."""
    v, k = 8, 3
    lg = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, k + 1, v)).astype(np.float32))
    p = filtered_probs(lg, torch.tensor([[0.7]]), torch.tensor([[0]]))
    draft = torch.argmax(p[:, :k], -1)
    out, n_emit, n_acc = speculative_verify_tokens(
        lg, draft, p[:, :k], [k], [0.7], [0], [3], [0])
    assert int(n_acc[0]) == k and int(n_emit[0]) == k + 1
    assert torch.equal(out[0, :k], draft[0])


def test_accept_zero_q_rejects():
    """A draft token of zero target mass is rejected and the resample
    comes from the residual's support."""
    v, k = 8, 1
    lg = torch.full((1, k + 1, v), -30.0)
    lg[0, :, 2] = 5.0
    q = torch.zeros((1, k, v))
    q[0, 0, 6] = 1.0
    out, _, n_acc = speculative_verify_tokens(lg, torch.tensor([[6]]), q, [k],
                                              [1.0], [0], [7], [0])
    assert int(n_acc[0]) == 0 and int(out[0, 0]) == 2


def test_stochastic_verify_is_lossless():
    """Distribution: the first emitted token of 20000 seeded verifies (the
    draft's token drawn from its own q, which differs from the target's p)
    is distributed as p: chi-square below CHI2_BOUND."""
    v, k, n = 8, 2, 20000
    rng = np.random.default_rng(4)
    lg = torch.from_numpy(rng.standard_normal((1, k + 1, v)).astype(np.float32))
    qlg = torch.from_numpy(rng.standard_normal((1, k, v)).astype(np.float32))
    t = torch.tensor([[0.9]])
    p = filtered_probs(lg, t, torch.tensor([[0]]))[0, 0].double()
    q = filtered_probs(qlg, t, torch.tensor([[0]]))
    counts = np.zeros(v)
    batch = 1000
    for b0 in range(0, n, batch):
        draft = torch.from_numpy(np.stack([
            rng.choice(v, p=q[0, i].double().numpy() / float(q[0, i].sum()),
                       size=batch) for i in range(k)], 1))
        out, n_emit, _ = speculative_verify_tokens(
            lg.expand(batch, -1, -1), draft, q.expand(batch, -1, -1),
            [k] * batch, [0.9] * batch, [0] * batch,
            list(range(b0, b0 + batch)), [0] * batch)
        counts += np.bincount(out[:, 0].numpy(), minlength=v)
        assert bool((n_emit >= 1).all())
    want = p.numpy() * n
    chi2 = float(((counts - want) ** 2 / want).sum())
    assert chi2 < CHI2_BOUND, (chi2, counts, want)


# ---------------------------------------------------------------------------
# the draft and the verify step
# ---------------------------------------------------------------------------


def test_self_draft_model_truncation(loaded):
    """``self-truncate`` slices every stacked leaf to its first layers:
    packed codes, block scales and per-layer tensor scales alike (views of
    the target's), and shares the embedding and the head."""
    cfg, by_fmt = loaded
    params, qcfg = by_fmt["packed"]
    dcfg, dparams = self_draft_model(cfg, params, "truncate", 1)
    assert dcfg.n_layers == 1
    n_packed = 0
    for a, full in zip(common.tree_leaves(dparams["layers"]),
                       common.tree_leaves(params["layers"])):
        if isinstance(a, PackedNVFP4):
            n_packed += 1
            for part, whole in ((a.codes, full.codes), (a.scales, full.scales),
                                (a.tensor_scale, full.tensor_scale)):
                if part.dtype == torch.float8_e4m3fn:
                    part, whole = part.view(torch.uint8), whole.view(torch.uint8)
                assert part.shape[0] == 1 and torch.equal(part[0], whole[0])
            assert a.orig_k == full.orig_k
        else:
            assert a.shape[0] == 1 and torch.equal(a[0], full[0])
    assert n_packed and dparams["embed"] is params["embed"]
    with pytest.raises(ValueError):
        self_draft_model(cfg, params, "truncate", cfg.n_layers + 1)
    with pytest.raises(ValueError):
        SpecEngine(cfg, params, qcfg, draft_k=0, **ENG_KW)


@pytest.mark.parametrize("arch", [ARCH, "arctic-480b"])
def test_verify_step_bitwise_matches_sequential(arch):
    """Bitwise: a 5-token prompt in the pool by exact prefill, then 3
    sequential ``decode_step_paged`` (row scope), against one
    ``verify_step_paged`` of those 3 tokens at per-token scope (MoE: token
    dispatch): the logits of every position, and the pool's pages."""
    cfg = configs.get_smoke(arch)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_dispatch="local")
    vcfg = (dataclasses.replace(cfg, moe_dispatch="token")
            if cfg.n_experts else cfg)
    sq_row = dataclasses.replace(qcfg, quantize_weights=False, act_scope="row")
    sq_tok = dataclasses.replace(sq_row, act_scope="token")
    prompt = _prompts(cfg.vocab_size, [5], seed=5)[0]
    bt = torch.arange(4, dtype=torch.int32)[None]
    active = torch.tensor([True])
    pools = []
    with torch.inference_mode():
        for _ in range(2):
            pool = decoder.init_paged_pool(cfg, 8, 8, "cpu")
            logits, cache = decoder.prefill(cfg, params, {"tokens": torch.from_numpy(
                prompt[None].astype(np.int64))}, sq_row, s_max=None)
            decoder.write_prompt_to_pool(
                pool, {k: v for k, v in cache.items() if k != "pos"}, [0])
            pools.append(pool)
        toks, seq = [int(torch.argmax(logits[0, -1]))], []
        for i in range(3):
            lg, _ = decoder.decode_step_paged(
                cfg, params, pools[0], bt, torch.tensor([5 + i], dtype=torch.int32),
                active, {"tokens": torch.tensor([[toks[-1]]])}, sq_row)
            seq.append(lg[0, 0])
            toks.append(int(torch.argmax(lg[0, 0])))
        vlg, _ = decoder.verify_step_paged(
            vcfg, params, pools[1], bt, torch.tensor([5], dtype=torch.int32),
            active, torch.tensor([2], dtype=torch.int32),
            {"tokens": torch.tensor([toks[:3]])}, sq_tok)
    for i in range(3):
        assert torch.equal(vlg[0, i], seq[i]), f"verify position {i}"
    for key, a in pools[0].items():
        assert torch.equal(a.view(torch.uint8), pools[1][key].view(torch.uint8)), key


# ---------------------------------------------------------------------------
# the engine: greedy parity with the plain engine, every draft mode
# ---------------------------------------------------------------------------


def _two_model(cfg, layers):
    dcfg = dataclasses.replace(cfg, n_layers=layers, name="student")
    dparams, dqcfg = serve.load_quantized(dcfg, 99, "qdq", "cpu")
    return dcfg, dparams, dqcfg


@pytest.mark.parametrize("fmt,draft", [("qdq", "self-qdq"),
                                       ("packed", "self-qdq"),
                                       ("packed", "self-truncate"),
                                       ("packed", "two-model")])
def test_greedy_parity_with_plain_engine(loaded, fmt, draft):
    """Greedy tokens: every draft mode emits the plain engine's streams;
    the pool drains, drafted = accepted + rolled back, and a self-qdq
    draft on QDQ weights (the target itself) accepts everything."""
    cfg, by_fmt = loaded
    params, qcfg = by_fmt[fmt]
    prompts = _prompts(cfg.vocab_size, [5, 13, 9])
    want = _drain(Engine(cfg, params, qcfg, **ENG_KW), prompts)
    kw = (dict(draft_model=_two_model(cfg, 1)) if draft == "two-model"
          else dict(draft=draft, draft_layers=1))
    eng = SpecEngine(cfg, params, qcfg, draft_k=3, **kw, **ENG_KW)
    got = _drain(eng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st = eng.stats()
    assert st["drafted_tokens"] == st["accepted_tokens"] + st["rolled_back_tokens"]
    assert st["verify_steps"] < eng.decode_tokens or draft == "two-model"
    if (fmt, draft) == ("qdq", "self-qdq"):
        assert st["acceptance_rate"] == 1.0 and st["rolled_back_tokens"] == 0
    if draft == "two-model":
        assert st["rolled_back_tokens"] > 0


def test_greedy_parity_fp8_kv_moe():
    """Greedy tokens: the arctic smoke config (FP8 pool, MoE) with a
    self-qdq draft at k = 2, against the plain engine; the draft's mirror
    pool is FP8 too."""
    cfg = configs.get_smoke("arctic-480b")
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    prompts = _prompts(cfg.vocab_size, [4, 9], seed=5)
    want = _drain(Engine(cfg, params, qcfg, **ENG_KW), prompts, 4)
    eng = SpecEngine(cfg, params, qcfg, draft_k=2, draft="self-qdq", **ENG_KW)
    assert eng.pool.fp8 and eng.proposer.data["k"].dtype == torch.float8_e4m3fn
    for g, w in zip(_drain(eng, prompts, 4), want):
        np.testing.assert_array_equal(g, w)
    assert eng.stats()["acceptance_rate"] > 0.5


def test_eos_mid_pack_truncates_and_matches(loaded):
    """An EOS accepted inside a verified pack ends the request there (the
    accepted tail dropped), as the plain engine ends it."""
    cfg, by_fmt = loaded
    params, qcfg = by_fmt["qdq"]
    prompts = _prompts(cfg.vocab_size, [6], seed=21)
    (full,) = _drain(Engine(cfg, params, qcfg, **ENG_KW), prompts, 8)
    eos = int(full[2])
    (plain,) = _drain(Engine(cfg, params, qcfg, eos_id=eos, **ENG_KW),
                      prompts, 8)
    eng = SpecEngine(cfg, params, qcfg, draft_k=4, draft="self-qdq",
                     eos_id=eos, **ENG_KW)
    (got,) = _drain(eng, prompts, 8)
    np.testing.assert_array_equal(got, plain)
    assert got[-1] == eos and len(got) == 3
    assert next(iter(eng.sched.finished.values())).finish_reason == "eos"


def test_adaptive_k_parity_and_histogram(loaded):
    """Greedy tokens with adaptive k equal the plain engine's; the chosen-k
    histogram counts every slot round and opens at the full k."""
    cfg, by_fmt = loaded
    params, qcfg = by_fmt["qdq"]
    prompts = _prompts(cfg.vocab_size, [5, 13])
    want = _drain(Engine(cfg, params, qcfg, **ENG_KW), prompts, 10)
    eng = SpecEngine(cfg, params, qcfg, draft_k=4, draft="self-qdq",
                     adaptive_k=True, **ENG_KW)
    for g, w in zip(_drain(eng, prompts, 10), want):
        np.testing.assert_array_equal(g, w)
    hist = eng.stats()["chosen_k_hist"]
    assert sum(hist.values()) == eng.verify_slot_rounds and eng.spec_k in hist
    assert eng._acc_ewma == 1.0
    # the cost model: no acceptance and a costly draft collapse k to 1
    req = eng.sched.submit(np.asarray([5, 6, 7]), 8)
    eng._draft_tok_s, eng._verify_s = 0.001, 0.01
    eng._req_acc[req.rid] = (100, 0)
    assert eng._choose_k(req) == 1
    eng._req_acc[req.rid] = (100, 100)
    assert eng._choose_k(req) == eng.spec_k


def test_stochastic_spec_is_deterministic(loaded):
    """Seeded sampling through the speculative engine: two runs give the
    same streams and every request completes."""
    cfg, by_fmt = loaded
    params, qcfg = by_fmt["qdq"]
    sp = SamplingParams(temperature=0.8, top_k=16, seed=123)

    def run():
        eng = SpecEngine(cfg, params, qcfg, draft_k=3, draft="self-truncate",
                         draft_layers=1, **ENG_KW)
        return [o.tolist() for o in _drain(
            eng, _prompts(cfg.vocab_size, [5, 12], seed=11), 4, sp)]
    first = run()
    assert first == run() and all(len(o) == 4 for o in first)


def test_slab_two_model_draft_rolls_back_losslessly():
    """Greedy tokens: rwkv6-3b smoke on the slab engine with a two-model
    draft of its family (seed 99): rejections happen and are restored from
    the snapshot chain, and the streams equal the plain slab engine's."""
    cfg = configs.get_smoke("rwkv6-3b")
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cpu")
    prompts = _prompts(cfg.vocab_size, [5, 9, 16])
    want = _drain(Engine(cfg, params, qcfg, **ENG_KW), prompts, GEN + 1)
    dcfg, dparams, dqcfg = _two_model(cfg, cfg.n_layers)
    eng = SpecEngine(cfg, params, qcfg, draft_k=3,
                     draft_model=(dcfg, dparams, dqcfg), **ENG_KW)
    for g, w in zip(_drain(eng, prompts, GEN + 1), want):
        np.testing.assert_array_equal(g, w)
    st = eng.stats()
    assert st["rolled_back_tokens"] > 0
    assert st["drafted_tokens"] == st["accepted_tokens"] + st["rolled_back_tokens"]


@pytest.mark.parametrize("draft", ["self-qdq", "self-truncate"])
def test_counts_match_reference(ref, draft):
    """Bitwise: the verify steps, slot rounds, drafted, accepted and
    rolled-back counts of a greedy workload (4 requests, 2 slots, k = 3,
    QDQ weights from the reference's init) equal the reference's
    ``SpecEngine.stats()``, and so do the streams (greedy tokens)."""
    cfg, params, qcfg = _port(ref, ARCH, "qdq")
    prompts = _prompts(cfg.vocab_size, REF_LENS)
    eng = SpecEngine(cfg, params, qcfg, draft_k=3, draft=draft,
                     draft_layers=1, **ENG_KW)
    got = np.stack(_drain(eng, prompts))
    np.testing.assert_array_equal(got, ref[f"spec/{draft}/out"])
    st = eng.stats()
    assert [st[k] for k in COUNTS] == ref[f"spec/{draft}/counts"].tolist()


def test_cli_speculative_line(capsys):
    """``--speculative 3 --draft self-qdq`` on the CPU: the streams equal
    the plain engine's and the speculative line is printed."""
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--weight-format",
                      "packed", "--engine", "--requests", "4", "--gen", "5",
                      "--speculative", "3", "--draft", "self-qdq"])
    out = capsys.readouterr().out
    assert res["ok"] and res["tokens_match_serve_batch"]
    assert "parity=AGREE pool-drained=True" in out
    assert "[engine] speculative: acceptance=" in out
    assert res["stats"]["speculative"] and res["stats"]["spec_k"] == 3
