"""Serving telemetry of the PyTorch port (``repro_torch.obs``: the tracer,
the dispatch recorder, the engine's instruments and snapshot, the
speculative counters, the shadow teacher), on the CPU, against the JAX
package.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (``test_torch_rwkv6.run_reference``):
its ``Engine`` with metrics, a tracer and the shadow teacher, its
``SpecEngine`` (self-qdq, k = 2) with metrics and a tracer, and its paged
prefix-cache engine on a pool small enough to preempt, with both, each on
the same weights (the reference's seeded init, bridged; the port's PTQ,
bitwise the reference's, quantizes them for both packages) and the same
prompts as the port's.  The port's engine with the shadow matches the
reference's instrument by instrument; its engine without the shadow
matches its lanes and event counters (the shadow adds neither).

Parity levels, as each test names them:

  * **greedy tokens, bitwise**: each engine with telemetry off, metrics
    on and tracing on, and with the shadow teacher on, against each other
    and the reference's;
  * **bookkeeping, bitwise**: each request lane's sequence of (phase,
    name) trace events and the engine lane's, timestamps aside; every
    counter and gauge of the engine's event plane (submitted, finished by
    reason, prefill and decode tokens, cache hits, misses and evictions,
    preemptions, requeues, queue depth, occupancy) and every histogram's
    count;
  * **dispatch, by label set**: the ``qeinsum_dispatch_total`` and
    ``kernel_dispatch_total`` label sets equal the reference's, but for
    ``nvfp4_qdq``: the port's activation QDQ is the K1 op (its calls
    count), the reference's serving QDQ a jnp fake-quant beside its
    kernel (nothing to count).  The values differ by design: the
    reference counts one dispatch per compiled specialization, the eager
    port one per call, which the test holds to the calls the engine's
    forwards make;
  * **shadow teacher, within tolerance**: the same sites, stats, series
    and ``sampled_records`` as the reference; values within
    ``SHADOW_TOL`` (SQNR 0.5 dB, amax and hidden MSE rel 1e-2, hidden
    cosine abs 1e-3, live KL rel 5e-2, clip fraction and scale use abs
    1e-2): NVFP4 amplifies any change in summation order;
  * the noise canary (``inject_quant_noise(params, 0.3)``) trips
    ``obs.compare.gate_violations`` at the reference test's
    ``THRESHOLDS``; clean against clean does not.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy, to_numpy
from repro_torch.distributed.ctx import TP
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.obs import NOOP, Observability
from repro_torch.obs import compare as obs_compare
from repro_torch.obs import dispatch as obs_dispatch
from repro_torch.obs import export as obs_export
from repro_torch.obs import validate as obs_validate
from repro_torch.obs.metrics import NOOP_INSTRUMENT, MetricsRegistry
from repro_torch.obs.schema import load_schema, validate
from repro_torch.obs.trace import NOOP_TRACER, Tracer, request_tid
from repro_torch.serve import Engine
from repro_torch.spec import SpecEngine
from test_torch_engine import _port
from test_torch_rwkv6 import run_reference
from test_torch_serve import _flat, _unflat

ARCH = "qwen1.5-0.5b"
MIXED_LENS = [4, 7, 11, 16]
GEN = 5
ENG = dict(n_slots=4, block_size=8, max_blocks_per_slot=4, n_blocks=16)
# the paged prefix-cache engine on a pool too small for its load: cache
# hits, evictions, preemptions and requeues
CACHE_ENG = dict(prefill_mode="paged", prefix_cache=True,
                 kv_alloc="ondemand", headroom=0, n_slots=3, n_blocks=6,
                 max_blocks_per_slot=4, block_size=8)
CACHE_GEN = 12
CACHE_N = 8
# (engine class, constructor keywords) of each run both packages make,
# with metrics and a tracer; "shadow" also takes the teacher.  The port
# also runs "plain", "shadow" without it; the reference only "shadow".
RUNS = {
    "shadow": ("engine", dict(ENG, shadow_rate=1.0)),
    "spec": ("spec", dict(ENG, draft_k=2)),
    "cache": ("engine", dict(CACHE_ENG)),
}
# the reference run each port run is held to
REF_OF = {"plain": "shadow", "shadow": "shadow", "spec": "spec",
          "cache": "cache"}
THRESHOLDS = {"max_sqnr_drop_db": 1.0, "max_kl_increase": 0.05,
              "max_cos_drop": 0.02, "max_amax_rel": 0.1}
# stat -> (kind, tolerance) of the shadow's per-layer values
SHADOW_TOL = {"sqnr_db": ("abs", 0.5), "amax": ("rel", 1e-2),
              "hidden_mse": ("rel", 1e-2), "hidden_cos": ("abs", 1e-3),
              "kl": ("rel", 5e-2), "clip_frac": ("abs", 1e-2),
              "scale_util": ("abs", 1e-2), "top1_agree": ("abs", 0.0)}
# the engine's event plane: counters and gauges compared by value,
# histograms by count (their values are wall times)
EVENT_INSTRUMENTS = (
    "serve_requests_total", "serve_tokens_total", "serve_queue_depth",
    "serve_active_slots", "serve_state_used", "serve_state_capacity",
    "prefix_cache_hit_total", "prefix_cache_miss_total",
    "prefix_cache_evict_total", "serve_preempt_total", "serve_requeue_total",
    "serve_shared_blocks", "serve_cached_blocks", "spec_draft_tokens_total",
    "spec_accepted_tokens_total", "spec_rolled_back_tokens_total",
    "spec_draft_steps_total", "serve_queue_wait_seconds",
    "serve_ttft_seconds", "serve_inter_token_seconds",
    "serve_prefill_step_seconds", "serve_decode_step_seconds",
    "spec_draft_seconds", "spec_verify_seconds")


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


def _cache_prompts(vocab):
    """Mixed-length prompts, most sharing a one-block head."""
    rng = np.random.default_rng(7)
    head = rng.integers(4, vocab, (8,)).astype(np.int32)
    out = []
    for i in range(CACHE_N):
        tail = rng.integers(4, vocab, (2 + i % 5,)).astype(np.int32)
        out.append(np.concatenate([head, tail]) if i % 5 else tail)
    return out


def _workload(name, vocab):
    if name == "cache":
        return _cache_prompts(vocab), CACHE_GEN
    return _prompts(vocab, MIXED_LENS), GEN


def _run(eng, prompts, gen):
    """Two requests up front, one step, then the rest (the reference
    test's staggered arrivals); returns the outputs in submission
    order."""
    rids = [eng.submit(p, gen) for p in prompts[:2]]
    eng.step()
    rids += [eng.submit(p, gen) for p in prompts[2:]]
    out = eng.drain(max_steps=500)
    assert not eng.state.leaked()
    return np.stack([out[r] for r in rids])


def _reference(out_path: str) -> None:
    """The reference's three instrumented runs (in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.nvfp4 import PackedNVFP4 as JPacked
    from repro.launch import specs as jspecs
    from repro.models import get_model as jget_model
    from repro.obs import Observability as JObs
    from repro.obs.export import metrics_snapshot as jsnapshot
    from repro.serve import Engine as JEngine
    from repro.spec import SpecEngine as JSpec

    res = {}
    cfg = jconfigs.get_smoke(ARCH)
    model = jget_model(cfg)
    teacher = jax.jit(lambda r: model.init_params(cfg, r))(
        jax.random.PRNGKey(0))
    for key, a in _flat(teacher).items():
        res[f"{ARCH}/params/{key}"] = np.asarray(a.astype(np.float32))
    _, tparams, _ = _port(res, ARCH, "packed")

    def one(t):
        if isinstance(t, dict) and "codes" in t:
            return JPacked(jnp.asarray(t["codes"]),
                           jnp.asarray(t["scales"]).astype(jnp.float8_e4m3fn),
                           jnp.asarray(t["tensor_scale"]), t["orig_k"])
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return jnp.asarray(t).astype(jnp.bfloat16)

    params = one(to_numpy(tparams))
    qcfg = dataclasses.replace(jspecs.recipe_qconfig(cfg),
                               weight_format="packed")
    for name, (kind, kw) in RUNS.items():
        kw = dict(kw)
        if name == "shadow":
            kw["shadow_teacher"] = teacher
        obs = JObs(metrics=True, trace=True)
        eng = (JSpec if kind == "spec" else JEngine)(cfg, params, qcfg,
                                                     obs=obs, **kw)
        prompts, gen = _workload(name, cfg.vocab_size)
        res[f"{name}/out"] = _run(eng, prompts, gen)
        res[f"{name}/snap"] = np.asarray(json.dumps(jsnapshot(eng)))
        res[f"{name}/trace"] = np.asarray(json.dumps(obs.trace.to_chrome()))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_obs_ref") / "ref.npz")
    return run_reference("test_torch_obs", out)


def _doc(ref, name, what):
    return json.loads(str(ref[f"{name}/{what}"]))


@pytest.fixture(scope="module")
def loaded(ref):
    cfg, params, qcfg = _port(ref, ARCH, "packed")
    teacher = params_from_numpy(_unflat(ref, f"{ARCH}/params/"), "cpu")
    return cfg, params, qcfg, teacher


def _engine(loaded, kind="engine", obs=None, shadow=False, params=None,
            **kw):
    cfg, p, qcfg, teacher = loaded
    cls = SpecEngine if kind == "spec" else Engine
    if shadow:
        kw["shadow_teacher"] = teacher
    return cls(cfg, p if params is None else params, qcfg, obs=obs,
               device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(loaded):
    """The port's runs: each of ``RUNS`` instrumented as the reference's,
    and the comparison runs (telemetry off, metrics only, tracing without
    the shadow, the shadow again and on the noisy weights, the
    speculative engine with the shadow).  name -> (engine, outputs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    vocab = loaded[0].vocab_size
    out = {}
    try:
        for name, (kind, kw) in RUNS.items():
            kw = dict(kw)
            shadow = "shadow_rate" in kw
            prompts, gen = _workload(name, vocab)
            obs = Observability(metrics=True, trace=True)
            eng = _engine(loaded, kind, obs, shadow, **kw)
            out[name] = (eng, _run(eng, prompts, gen))
        prompts = _prompts(vocab, MIXED_LENS)
        extra = {
            "plain": ("engine", Observability(metrics=True, trace=True), {},
                      ENG),
            "off": ("engine", None, {}, ENG),
            "metrics": ("engine", Observability(metrics=True), {}, ENG),
            "spec_off": ("spec", None, {}, dict(ENG, draft_k=2)),
            "shadow_again": ("engine", Observability(metrics=True),
                             {"shadow": True}, dict(ENG, shadow_rate=1.0)),
            "shadow_noisy": ("engine", Observability(metrics=True),
                             {"shadow": True, "params": serve.
                              inject_quant_noise(loaded[1], 0.3)},
                             dict(ENG, shadow_rate=1.0)),
            "spec_shadow": ("spec", None, {"shadow": True},
                            dict(ENG, draft_k=2, shadow_rate=1.0)),
        }
        for name, (kind, obs, more, kw) in extra.items():
            eng = _engine(loaded, kind, obs, **more, **kw)
            out[name] = (eng, _run(eng, prompts, GEN))
        prompts, gen = _workload("cache", vocab)
        eng = _engine(loaded, obs=None, **CACHE_ENG)
        out["cache_off_obs"] = (eng, _run(eng, prompts, gen))
    finally:
        torch.set_num_threads(n)
    return out


# ---------------------------------------------------------------------------
# the tracer, the validator, the dispatch recorder
# ---------------------------------------------------------------------------


def test_tracer_spans_nest_and_chrome_doc_validates():
    tr = Tracer()
    tr.thread_name(request_tid(0), "request 0")
    tr.begin("request", request_tid(0), rid=0)
    with tr.span("engine.decode_step"):
        with tr.annotate("spec.verify"):
            pass
    tr.instant("first_token", request_tid(0), token=5)
    tr.end("request", request_tid(0))
    doc = tr.to_chrome()
    assert validate(doc, load_schema("trace")) == []
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert names == ["request", "engine.decode_step", "spec.verify",
                     "spec.verify", "engine.decode_step", "first_token",
                     "request"]
    ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)
    assert doc["metadata"]["schema"] == "repro.obs.trace/v1"


def test_noop_tracer_records_nothing():
    assert NOOP_TRACER.enabled is False
    NOOP_TRACER.begin("x")
    with NOOP_TRACER.span("y"):
        pass
    with NOOP_TRACER.annotate("z"):
        pass
    assert NOOP_TRACER.events == ()
    assert NOOP_TRACER.to_chrome()["traceEvents"] == []
    assert NOOP.trace is NOOP_TRACER and NOOP.dispatch is None


def test_annotate_opens_a_profiler_range():
    """``annotate`` opens a ``record_function`` of the span's name, so a
    torch.profiler trace lines up with the engine's spans."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.annotate("engine.decode_step", n_active=2):
            torch.ones(4) + 1
    names = {e.key for e in prof.key_averages()}
    assert "engine.decode_step" in names
    assert [e["ph"] for e in tr.events] == ["B", "E"]


def _bad_trace(kind):
    tr = Tracer()
    lane = request_tid(0)
    tr.begin("request", lane)
    if kind == "unbalanced":
        tr.begin("queue", lane)                  # never closed
        return tr.to_chrome(), "unclosed"
    if kind == "cross_nested":
        tr.begin("queue", lane)
        tr.end("request", lane)                  # closes the outer first
        tr.end("queue", lane)
        return tr.to_chrome(), "must nest"
    if kind == "backwards":
        tr.end("request", lane)
        doc = tr.to_chrome()
        doc["traceEvents"][-1]["ts"] = -1.0
        return doc, "emitted in order"
    tr.end("request", lane)                       # lifecycle spans missing
    return tr.to_chrome(), "never occurs"


@pytest.mark.parametrize("kind", ["unbalanced", "cross_nested", "backwards",
                                  "missing_spans"])
def test_trace_validator_catches_bad_docs(kind):
    """Both packages' ``check_trace`` reject the same bad documents."""
    from repro.obs import validate as jvalidate
    doc, why = _bad_trace(kind)
    for check in (obs_validate.check_trace, jvalidate.check_trace):
        errs = check(doc)
        assert any(why in e for e in errs), (kind, errs)


def test_dispatch_recorder_counts_each_plain_kernel_call():
    """One call each of K1, K2 and K7's plain versions, and of qeinsum on
    a packed and a dense weight, under a recorder: one count each (every
    call counts, on the CPU too); nothing is counted outside
    ``recording``."""
    reg = MetricsRegistry()
    rec = obs_dispatch.DispatchRecorder(reg)
    x = torch.randn(4, 64).to(torch.bfloat16)
    w = torch.randn(64, 48)
    pw = ops.pack_weight(w)
    pool = {"k": torch.randn(4, 8, 1, 32).to(torch.bfloat16),
            "v": torch.randn(4, 8, 1, 32).to(torch.bfloat16)}
    bt = torch.tensor([[2, 0]], dtype=torch.int32)
    pos = torch.tensor([5], dtype=torch.int32)
    from repro_torch.core.qconfig import BF16
    with obs_dispatch.recording(rec):
        assert obs_dispatch.active() is rec
        y = ops.nvfp4_qdq(x)
        ops.nvfp4_matmul(y, pw)
        out = ops.paged_attention(x[:1].reshape(1, 1, 2, 32), pool, bt, pos)
        layers.qeinsum(BF16, "mlp", layers._DENSE_EQ, x, pw)
        layers.qeinsum(BF16, "mlp", layers._DENSE_EQ, x,
                       w.to(torch.bfloat16))
    assert obs_dispatch.active() is None
    ops.nvfp4_qdq(x)                                   # not recorded
    np.testing.assert_array_equal(
        out.float().numpy(), kref.paged_attention_ref(
            x[:1].reshape(1, 1, 2, 32), pool, bt, pos).float().numpy())
    snap = reg.snapshot()
    kern = {c["labels"]["kernel"]: c["value"]
            for c in snap["kernel_dispatch_total"]["labels"]}
    assert kern == {"nvfp4_qdq": 1.0, "nvfp4_matmul": 2.0,
                    "paged_attention": 1.0}
    gemm = {c["labels"]["backend"]: c["value"]
            for c in snap["qeinsum_dispatch_total"]["labels"]}
    assert gemm == {"pallas_2d": 1.0, "dense": 1.0}
    nbytes = {c["labels"]["backend"]: c["value"]
              for c in snap["qeinsum_weight_bytes_total"]["labels"]}
    # packed: 48 x 32 code bytes, 48 x 4 FP8 block scales, an f32 scale
    assert nbytes == {"pallas_2d": 48 * 32 + 48 * 4 + 4,
                      "dense": 64 * 48 * 2}


def test_engine_without_obs_holds_noop_handles(loaded):
    """An engine built without ``obs`` allocates no instrument, and its
    stats carry the speculative keys disabled (one shape for both
    engines), percentiles None before any data."""
    eng = _engine(loaded, **ENG)
    assert eng.obs is NOOP and eng.numerics is None
    assert eng._m_ttft is NOOP_INSTRUMENT
    assert eng._m_req_finished["eos"] is NOOP_INSTRUMENT
    st = eng.stats()
    assert st["speculative"] is False
    assert st["acceptance_rate"] is None and st["accepted_per_step"] is None
    assert st["ttft_p50_s"] is None and st["decode_lat_p95_s"] is None
    assert eng.obs.metrics.snapshot() == {}


def test_shadow_refused_under_tensor_parallelism(loaded):
    """Under tensor parallelism the shadow teacher is cut into the rank's
    tiles with the student's rules (a teacher already cut passes as it
    is); a teacher leaf at neither its whole shape nor its tile is
    refused before any collective.  (The shadow's records under TP:
    ``test_torch_tp_serve.py``.)"""
    cfg, params, qcfg, teacher = loaded
    tp = TP(group=None, rank=0, size=2, device=torch.device("cpu"))
    eng = Engine(cfg, params, qcfg, mesh=tp, shadow_teacher=teacher,
                 shadow_rate=0.5, device="cpu")
    wqkv = eng.shadow_teacher["layers"]["wqkv"]
    assert wqkv.shape[-1] * 2 == teacher["layers"]["wqkv"].shape[-1]
    again = Engine(cfg, params, qcfg, mesh=tp, shadow_teacher=eng.shadow_teacher,
                   shadow_rate=0.5, device="cpu")
    assert again.shadow_teacher["layers"]["wqkv"] is wqkv
    layers = dict(teacher["layers"], wqkv=teacher["layers"]["wqkv"][..., :8])
    with pytest.raises(ValueError, match="neither the whole"):
        Engine(cfg, params, qcfg, mesh=tp,
               shadow_teacher=dict(teacher, layers=layers), shadow_rate=0.5,
               device="cpu")


# ---------------------------------------------------------------------------
# the engines against each other and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "metrics", "plain", "shadow"])
def test_engine_tokens_bitwise_with_telemetry(ref, runs, mode):
    """Greedy tokens, bitwise: the engine with telemetry off, metrics on,
    tracing on, and tracing with the shadow, against the reference's
    engine."""
    np.testing.assert_array_equal(runs[mode][1], ref["shadow/out"])


def test_spec_tokens_bitwise_with_telemetry(ref, runs):
    """Greedy tokens, bitwise: the speculative engine with telemetry off
    and on, the plain engine and the reference's speculative engine."""
    for name in ("spec_off", "spec"):
        np.testing.assert_array_equal(runs[name][1], ref["spec/out"])
    np.testing.assert_array_equal(runs["spec"][1], runs["off"][1])


def test_cache_tokens_bitwise_with_telemetry(ref, runs):
    """Greedy tokens, bitwise, under preemption and the prefix cache, with
    tracing on and off, against the reference."""
    eng = runs["cache"][0]
    assert eng.preempts > 0 and eng.state.cache.hits > 0
    np.testing.assert_array_equal(runs["cache"][1], ref["cache/out"])
    np.testing.assert_array_equal(runs["cache_off_obs"][1], ref["cache/out"])


def _lanes(doc):
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] in "BEi":
            lanes.setdefault(e["tid"], []).append((e["ph"], e["name"]))
    return lanes


@pytest.mark.parametrize("name", ["plain", "spec", "cache"])
def test_trace_lanes_equal_reference(ref, runs, name):
    """Bitwise bookkeeping: every lane's (phase, name) sequence, the
    engine's and each request's, equals the reference's; each request
    lane opens ``request`` then ``queue`` and closes ``request``."""
    doc = runs[name][0].obs.trace.to_chrome()
    mine, theirs = _lanes(doc), _lanes(_doc(ref, REF_OF[name], "trace"))
    assert sorted(mine) == sorted(theirs)
    for tid in sorted(theirs):
        assert mine[tid] == theirs[tid], tid
        if tid:
            assert mine[tid][:2] == [("B", "request"), ("B", "queue")]
            assert mine[tid][-1] == ("E", "request")
    if name == "cache":
        assert ("B", "preempt") in mine[0] and ("B", "cache_lookup") in mine[0]


def _event_plane(metrics):
    out = {}
    for name in EVENT_INSTRUMENTS:
        inst = metrics.get(name)
        if inst is None:
            continue
        key = "count" if inst["kind"] == "histogram" else "value"
        cells = inst.get("labels")
        out[name] = ({tuple(c["labels"].items()): c[key] for c in cells}
                     if cells is not None else inst[key])
    return out


@pytest.mark.parametrize("name", ["plain", "shadow", "spec", "cache"])
def test_event_counters_equal_reference(ref, runs, name):
    """Bitwise bookkeeping: the event plane's counters and gauges, and the
    histograms' counts, equal the reference's."""
    mine = _event_plane(obs_export.metrics_snapshot(runs[name][0])["metrics"])
    theirs = _event_plane(_doc(ref, REF_OF[name], "snap")["metrics"])
    assert set(mine) == set(theirs)
    for inst in sorted(theirs):
        assert mine[inst] == theirs[inst], inst
    if name == "cache":
        assert theirs["serve_preempt_total"] > 0
        assert theirs["prefix_cache_evict_total"] > 0


def _labels(metrics, name, key):
    return {c["labels"][key]: c["value"] for c in metrics[name]["labels"]}


@pytest.mark.parametrize("name", ["shadow", "spec", "cache"])
def test_dispatch_counters_labels_and_per_call_values(ref, runs, name):
    """The dispatch counters' label sets equal the reference's.  Their
    values follow the per-call rule: each packed site of each forward is
    one ``pallas_2d`` GEMM and one K2 call, each activation one K1 call,
    each layer of each decode (or verify, or paged prefill chunk) forward
    one K7 call."""
    eng = runs[name][0]
    mine = eng.obs.metrics.snapshot()
    theirs = _doc(ref, name, "snap")["metrics"]
    for inst, key in (("qeinsum_dispatch_total", "backend"),
                      ("kernel_dispatch_total", "kernel"),
                      ("qeinsum_weight_bytes_total", "backend")):
        want = set(_labels(theirs, inst, key))
        if inst == "kernel_dispatch_total":
            assert "nvfp4_qdq" not in want
            want.add("nvfp4_qdq")
        assert set(_labels(mine, inst, key)) == want, inst
    gemm = _labels(mine, "qeinsum_dispatch_total", "backend")
    kern = _labels(mine, "kernel_dispatch_total", "kernel")
    assert gemm["pallas_2d"] == kern["nvfp4_matmul"]
    assert kern["nvfp4_qdq"] == kern["nvfp4_matmul"]
    n_layers = eng.cfg.n_layers
    st = eng.stats()
    if name == "shadow":
        # the shadow's student forwards: one a request a sampled step
        fwd = (st["requests_finished"] + st["decode_steps"]
               + eng.numerics.records - eng.shadow_steps)
        assert kern["nvfp4_matmul"] == 5 * n_layers * fwd
        assert kern["paged_attention"] == n_layers * st["decode_steps"]
        plain = _labels(runs["plain"][0].obs.metrics.snapshot(),
                        "kernel_dispatch_total", "kernel")
        fwd = st["requests_finished"] + st["decode_steps"]
        assert plain["nvfp4_matmul"] == 5 * n_layers * fwd
    if name == "spec":
        draft = mine["spec_draft_steps_total"]["value"]
        fwd = (2 * st["requests_finished"] + st["verify_steps"] + draft)
        assert kern["nvfp4_matmul"] == 5 * n_layers * fwd
        assert kern["paged_attention"] == n_layers * (st["verify_steps"]
                                                      + draft)
    bts = _labels(mine, "qeinsum_weight_bytes_total", "backend")
    assert bts["pallas_2d"] > 0


@pytest.mark.parametrize("name", ["plain", "spec", "cache", "shadow"])
def test_both_validators_accept_the_artifacts(runs, name, tmp_path):
    """The port's snapshot (with its Prometheus text) and trace pass both
    packages' validators."""
    from repro.obs import validate as jvalidate
    eng = runs[name][0]
    spec, cache = name == "spec", name == "cache"
    path = str(tmp_path / "m.json")
    snap = obs_export.write_metrics(eng, path)
    assert json.loads(open(path).read()) == json.loads(json.dumps(snap))
    prom = open(obs_export.prom_path(path)).read()
    assert snap["engine"]["kind"] == ("spec" if spec else "engine")
    for v in (obs_validate, jvalidate):
        assert v.check_metrics(snap, spec, cache) == []
        assert v.check_prometheus(prom) == []
    if eng.obs.trace.enabled:
        obs_export.write_trace(eng, str(tmp_path / "t.json"))
        doc = json.loads(open(tmp_path / "t.json").read())
        for v in (obs_validate, jvalidate):
            assert v.check_trace(doc, spec, cache) == []


def test_spec_counters_equal_stats(runs):
    """The speculative counters by draft kind equal ``stats()``, the verify
    histogram counts the verify steps, and the proposer counted its
    steps."""
    eng = runs["spec"][0]
    st = eng.stats()
    snap = eng.obs.metrics.snapshot()
    for inst, key in (("spec_draft_tokens_total", "drafted_tokens"),
                      ("spec_accepted_tokens_total", "accepted_tokens"),
                      ("spec_rolled_back_tokens_total",
                       "rolled_back_tokens")):
        assert _labels(snap, inst, "draft") == {"self-qdq": st[key]}, inst
    assert st["drafted_tokens"] > 0
    assert snap["spec_verify_seconds"]["count"] == st["verify_steps"]
    assert snap["spec_draft_seconds"]["count"] == st["verify_steps"]
    assert snap["spec_draft_steps_total"]["value"] > 0


# ---------------------------------------------------------------------------
# the shadow teacher
# ---------------------------------------------------------------------------


def test_shadow_tokens_bitwise(ref, runs):
    """The shadow leaves the token streams bitwise as they were, on both
    engines; the speculative engine's acceptance series exists."""
    for name in ("shadow", "shadow_again", "spec_shadow"):
        assert runs[name][0].shadow_steps > 0
        np.testing.assert_array_equal(runs[name][1], ref["shadow/out"])
    pts = runs["spec_shadow"][0].numerics.series["spec_accept_rate"]
    assert pts and all(0.0 <= v <= 1.0 for _, v in pts)
    assert "spec_accept_rate" not in runs["shadow"][0].numerics.series


def test_shadow_sites_and_records_equal_reference(ref, runs):
    """The same sites, stats per site, series (with their steps) and
    ``sampled_records`` as the reference's shadow."""
    mine = obs_export.metrics_snapshot(runs["shadow"][0])["numerics"]
    theirs = _doc(ref, "shadow", "snap")["numerics"]
    assert mine["sampled_records"] == theirs["sampled_records"] > 0
    assert sorted(mine["per_layer"]) == sorted(theirs["per_layer"])
    for site, stats in theirs["per_layer"].items():
        assert sorted(mine["per_layer"][site]) == sorted(stats), site
    assert sorted(mine["series"]) == sorted(theirs["series"])
    for name, pts in theirs["series"].items():
        assert [p[0] for p in mine["series"][name]] == [p[0] for p in pts]
    assert any(s.startswith("layers.") and "sqnr_db" in st
               for s, st in mine["per_layer"].items())


def _close(stat, got, want):
    kind, tol = SHADOW_TOL[stat]
    if kind == "abs":
        return abs(got - want) <= tol
    return abs(got - want) <= tol * max(abs(want), 1e-12)


def test_shadow_values_within_tolerance(ref, runs):
    """Within ``SHADOW_TOL``: every per-layer value of the last record and
    every point of the live KL and top-1 series."""
    mine = obs_export.metrics_snapshot(runs["shadow"][0])["numerics"]
    theirs = _doc(ref, "shadow", "snap")["numerics"]
    bad = []
    for site, stats in sorted(theirs["per_layer"].items()):
        for stat, want in sorted(stats.items()):
            got = mine["per_layer"][site][stat]
            if not _close(stat, got, want):
                bad.append((site, stat, got, want))
    for series, stat in (("qad_live_kl", "kl"),
                         ("qad_top1_agree", "top1_agree")):
        for (_, got), (_, want) in zip(mine["series"][series],
                                       theirs["series"][series]):
            if not _close(stat, got, want):
                bad.append((series, stat, got, want))
    assert not bad, bad
    assert abs(mine["sqnr_db_min"] - theirs["sqnr_db_min"]) <= 0.5


def test_shadow_records_deterministic(runs):
    """Two runs record identical per-layer values and series."""
    a, b = runs["shadow"][0].numerics, runs["shadow_again"][0].numerics
    assert a.records == b.records > 0
    assert a.series == b.series
    assert a.last == b.last


def test_noise_canary_trips_the_gate(runs):
    """``inject_quant_noise(params, 0.3)`` trips the drift gate at the
    reference test's thresholds with an amax or KL violation; clean
    against clean passes."""
    clean = obs_export.metrics_snapshot(runs["shadow"][0])
    noisy = obs_export.metrics_snapshot(runs["shadow_noisy"][0])
    assert obs_validate.check_metrics(noisy) == []
    assert obs_compare.gate_violations(clean, clean, THRESHOLDS) == []
    violations = obs_compare.gate_violations(clean, noisy, THRESHOLDS)
    assert any("amax" in v or "kl" in v for v in violations), violations


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_writes_artifacts_the_validator_accepts(tmp_path):
    m, t = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--weight-format",
                      "packed", "--engine", "--obs", "trace", "--requests",
                      "4", "--gen", "4", "--prefix-cache", "on",
                      "--shadow-rate", "0.5", "--metrics-out", m,
                      "--trace-out", t])
    assert res["ok"] and res["obs"]
    snap = json.loads(open(m).read())
    assert snap["numerics"]["sampled_records"] > 0
    from repro_torch.obs.validate import main as validate_main
    assert validate_main(["--trace", t, "--metrics", m, "--prom",
                          str(tmp_path / "m.prom"),
                          "--expect-prefix-cache"]) == 0
    assert validate_main(["--trace", t, "--expect-spec"]) == 1


@pytest.mark.parametrize("argv, why", [
    (["--obs", "metrics"], "--engine"),
    (["--metrics-out", "m.json"], "--engine"),
    (["--shadow-rate", "0.5"], "--engine"),
    (["--engine", "--inject-quant-noise", "0.3"], "packed"),
])
def test_cli_refusals(argv, why):
    with pytest.raises(SystemExit, match=why):
        serve.main(["--device", "cpu", "--arch", ARCH] + argv)
