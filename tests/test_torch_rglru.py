"""The RG-LRU hybrid family (``models/rglru.py``) and the engine's slab
backend (``serve/state.py``) in the PyTorch port against the JAX package,
on the CPU, at the two smoke configs: ``nemotron-nano-9b-sim-smoke`` (no
window: dense attention KV) and ``recurrentgemma-2b-smoke`` (window 16: a
ring).

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (see ``test_torch_serve.py``) on
numpy-seeded inputs and its own ``init_params``, bridged to the port
(``bridge.params_from_numpy``); the port packs them with its own PTQ.

Parity levels, as each test names them:

  * **bitwise**: ``_causal_conv`` (bf16), ``_lru_scan`` against the
    reference's eager ``associative_scan`` (the jitted one contracts
    ``a2 * b1 + b2`` into fused multiply-adds, one f32 ulp away),
    ``merge_slot_state``, ``slab_write``, ``slab_restore_select``, the
    ring alignment of a windowed prompt's KV, and the slab engine's
    snapshot, which no later step writes;
  * **tolerance**: ``apply``, ``prefill`` and ``decode_step_slots``
    logits against the jitted reference, rtol = atol = 5e-2 (the
    reference's NVFP4 rounding of f32 values its fused multiply-adds and
    XLA's exp, tanh and logistic move by an ulp, where the port's torch
    functions round otherwise, on a few codes a layer);
  * **greedy tokens**: the port's slab engine against the port's
    ``serve_batch`` on mixed prompts (the ring wraps on recurrentgemma);
  * **tolerance**: one QAD step on the nemotron smoke config against the
    jitted reference step, ``test_torch_train.py``'s levels but loss and
    KL within rtol 1e-4 and the moments within 2e-2 relative L2 (the
    student's forward is not bitwise here: the ulps above move a few of
    its NVFP4 codes; 1.8e-5 and 0.4-1.6%, largest in the first layers'
    conv, measured);
  * **reference finding 1** (``ROADMAP.md`` C): without a window the
    reference's ``prefill`` returns KV of the prompt's length whatever
    ``s_max`` says; the port's has ``s_max`` positions.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy, to_numpy
from repro_torch.core import nvfp4, ptq, qad, qconfig
from repro_torch.launch import serve, specs
from repro_torch.models import attention as attn
from repro_torch.models import common, get_model, rglru
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.serve import Engine
from repro_torch.serve import state as state_mod
from test_torch_serve import _flat, _unflat
from test_torch_train import (LR, TOTAL, WARMUP, _assert_tree_rel_l2,
                              _batch_np, _bf16_ulp)

ARCHS = ["nemotron-nano-9b-sim", "recurrentgemma-2b"]
NEMO, RG = ARCHS
TOL = 5e-2
APPLY_LEN = 20                 # past recurrentgemma's window of 16
SLOT_LEN = 19                  # two slots prefilled, the third idle
N_SLOTS, S_ALLOC = 3, 32
ENGINE_LENS = [4, 9, 15, 17, 22, 26]
ENGINE_GEN = 6
SCAN_LENS = (1, 6, 16, 37)     # one, even, a power of two, odd


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(i):
    return np.random.default_rng(40 + i)


def _slot_inputs(vocab):
    """Two prompts (one compile of the reference's prefill), then two slot
    decode steps: slot 0 alone, then slots 0 and 1 at positions 20 and 19
    (slot 2 idle throughout).  Returns (prompts, lens, active) per step
    and the fed tokens."""
    rng = _rng(1)
    prompts = [rng.integers(4, vocab, (SLOT_LEN,)).astype(np.int32)
               for _ in range(2)]
    lens = np.asarray([[SLOT_LEN, SLOT_LEN, 0], [SLOT_LEN + 1, SLOT_LEN, 0]],
                      np.int32)
    active = np.asarray([[True, False, False], [True, True, False]])
    toks = rng.integers(4, vocab, (2, N_SLOTS, 1)).astype(np.int32)
    return prompts, lens, active, toks


def _conv_inputs():
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32)
    return x, w, b, st


def _scan_inputs(n):
    rng = _rng(3 + n)
    return (rng.uniform(0.3, 1.0, (2, n, 8)).astype(np.float32),
            rng.standard_normal((2, n, 8)).astype(np.float32))


def _rand_tree(specs, seed):
    """Random numpy values (bf16-exact for bf16 leaves) shaped as a slab
    spec tree given as {path: (shape, is_f32)}."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, f32) in specs.items():
        a = rng.standard_normal(shape).astype(np.float32)
        out[k] = a if f32 else torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return out


def _slab_layout(cfg):
    """{path: (shape, is_f32)} of the port's slot-state specs."""
    sp = _flat(get_model(cfg).slot_state_specs(cfg, N_SLOTS, S_ALLOC))
    return {k: (s.shape, s.dtype == torch.float32) for k, s in sp.items()}


def _reference(out_path: str, layouts: dict) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import qad as jqad
    from repro.launch import specs as jspecs
    from repro.models import common as jcommon
    from repro.models import rglru as jrglru
    from repro.optim import AdamW as JAdamW
    from repro.optim import warmup_cosine as jwarmup_cosine
    from repro.serve import state as jstate

    def f32(a):
        return np.asarray(a).astype(np.float32)

    def port_packed(arch, dense, qc):
        """The port's PTQ of ``dense`` as the reference's packed tree (the
        two PTQs are bitwise equal, ``test_torch_nvfp4.py``; the port's is
        eager torch, quicker here than the reference's eager JAX)."""
        from repro.core.nvfp4 import PackedNVFP4 as JPacked
        tcfg = configs.get_smoke(arch)
        tq = dataclasses.replace(specs.recipe_qconfig(tcfg),
                                 weight_format="packed")
        tp = ptq.quantize_weights(
            params_from_numpy(jax.tree.map(f32, dense), "cpu"),
            rglru.param_specs(tcfg), tq)

        def one(t):
            if isinstance(t, dict) and "codes" in t:
                return JPacked(jnp.asarray(t["codes"]),
                               jnp.asarray(t["scales"]).astype(jnp.float8_e4m3fn),
                               jnp.asarray(t["tensor_scale"]), t["orig_k"])
            if isinstance(t, dict):
                return {k: one(v) for k, v in t.items()}
            return jnp.asarray(t).astype(bf)
        return one(to_numpy(tp))

    res, denses = {}, {}
    bf = jnp.bfloat16
    x, w, b, st = _conv_inputs()
    for name, state in (("fresh", None), ("state", st)):
        y, s = jrglru._causal_conv(jnp.asarray(x, bf), jnp.asarray(w, bf),
                                   jnp.asarray(b, bf),
                                   None if state is None else jnp.asarray(state, bf))
        res[f"conv/{name}/y"], res[f"conv/{name}/state"] = f32(y), f32(s)
    for n in SCAN_LENS:
        a, bb = _scan_inputs(n)
        res[f"scan/{n}"] = f32(jrglru._lru_scan(jnp.asarray(a), jnp.asarray(bb)))

    for arch in ARCHS:
        cfg = jconfigs.get_smoke(arch)
        dense = denses[arch] = jax.jit(lambda r: jrglru.init_params(cfg, r))(
            jax.random.PRNGKey(0))
        for k, v in _flat(dense).items():
            res[f"{arch}/params/{k}"] = f32(v)
        toks = jnp.asarray(_rng(0).integers(4, cfg.vocab_size,
                                            (2, APPLY_LEN)).astype(np.int32))
        qc = jspecs.recipe_qconfig(cfg)
        from repro.core.qconfig import BF16
        for name, q in (("bf16", BF16), ("nvfp4", qc)):
            res[f"{arch}/apply/{name}"] = f32(jax.jit(
                lambda p, t: jrglru.apply(cfg, p, {"tokens": t}, q))(dense, toks))

        # the slab path over packed weights (the dense-weight GEMM form,
        # cheaper to compile than the Pallas kernel in interpret mode):
        # reference prefill into a slab via slab_write, then two
        # decode_step_slots steps
        params = port_packed(arch, dense, qc)
        sq = dataclasses.replace(qc, weight_format="packed",
                                 quantize_weights=False, act_scope="row",
                                 packed_backend="dequant")
        prompts, lens, active, dtoks = _slot_inputs(cfg.vocab_size)
        specs_ = jrglru.slot_state_specs(cfg, N_SLOTS, S_ALLOC)
        data = jcommon.zeros_from_specs(specs_)
        pre = jax.jit(lambda p, t: jrglru.prefill(cfg, p, {"tokens": t}, sq,
                                                  None))
        write = jax.jit(lambda d, c, slot: jstate.slab_write(specs_, d, c, slot))
        for slot, p in enumerate(prompts):
            lg, cache = pre(params, jnp.asarray(p[None]))
            res[f"{arch}/prefill/{slot}"] = f32(lg)
            cache = {k: v for k, v in cache.items() if k != "pos"}
            data = write(data, cache, jnp.asarray(slot, jnp.int32))
        step = jax.jit(lambda p, d, t, l, a: jrglru.decode_step_slots(
            cfg, p, d, {"tokens": t}, l, a, sq))
        for i in range(2):
            lg, data = step(params, data, jnp.asarray(dtoks[i]),
                            jnp.asarray(lens[i]), jnp.asarray(active[i]))
            res[f"{arch}/slots/{i}"] = f32(lg)
        if arch == NEMO:
            # reference finding 1: windowless prefill ignores s_max
            _, cache = jax.eval_shape(lambda p, t: jrglru.prefill(
                cfg, p, {"tokens": t}, sq, s_max=9), params,
                jnp.zeros((1, 5), jnp.int32))
            res["finding1/kv_shape"] = np.asarray(cache["blocks"]["kv"]["k"].shape)

        # the slab machinery on random state trees
        lay = layouts[arch]
        trees = [_unflat(_rand_tree(lay, 100 + j), "") for j in range(3)]
        jt = [jax.tree.map(lambda sp, a: jnp.asarray(a, sp.dtype), specs_, t,
                           is_leaf=jcommon.is_spec) for t in trees]
        act = jnp.asarray([True, False, True])
        for k, v in _flat(jax.jit(lambda a, b: jcommon.merge_slot_state(
                specs_, a, b, act))(jt[0], jt[1])).items():
            res[f"{arch}/merge/{k}"] = f32(v)
        one = jax.tree.map(lambda s: jnp.asarray(
            np.random.default_rng(7).standard_normal(
                tuple(1 if a == "batch" else (min(n, 5) if a == "seq" else n)
                      for n, a in zip(s.shape, s.axes))).astype(np.float32)),
            specs_, is_leaf=jcommon.is_spec)
        for k, v in _flat(one).items():
            res[f"{arch}/write_in/{k}"] = f32(v)
        for k, v in _flat(write(jt[0], one, jnp.asarray(1, jnp.int32))).items():
            res[f"{arch}/write/{k}"] = f32(v)
        sel = jnp.asarray([2, 0, 1])
        for k, v in _flat(jax.jit(lambda t, s: jstate.slab_restore_select(
                specs_, t, s))(jt, sel)).items():
            res[f"{arch}/restore/{k}"] = f32(v)

    # ring alignment of a windowed prompt's KV (rglru.py:390-398)
    a = _rng(5).standard_normal((2, 1, 21, 3, 4)).astype(np.float32)
    res["ring"] = np.asarray(jnp.roll(jnp.asarray(a)[:, :, 21 - 16:], 21 % 16,
                                      axis=2))
    # one QAD step on the nemotron smoke config
    cfg = jconfigs.get_smoke(NEMO)
    model = jrglru
    qc = jspecs.recipe_qconfig(cfg)
    dense = denses[NEMO]
    toks, labels, mask = _batch_np(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "mask": jnp.asarray(mask)}
    opt = JAdamW(lr=jwarmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=dense,
                            teacher=jax.tree.map(jnp.copy, dense),
                            opt_state=opt.init(dense))
    new, m = jax.jit(jqad.make_train_step(model, cfg, qc, opt))(state, batch)
    for k, v in m.items():
        res[f"qad/metrics/{k}"] = f32(v)
    for name, tree in (("student", new.student), ("m", new.opt_state.m),
                       ("v", new.opt_state.v)):
        for k, v in _flat(tree).items():
            res[f"qad/{name}/{k}"] = f32(v)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_rglru_ref") / "ref.npz")
    layouts = {a: _slab_layout(configs.get_smoke(a)) for a in ARCHS}
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = ("import test_torch_rglru as t; "
            f"t._reference({out!r}, {layouts!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _dense(ref, arch):
    cfg = configs.get_smoke(arch)
    return cfg, params_from_numpy(_unflat(ref, f"{arch}/params/"), "cpu")


def _packed(ref, arch):
    """(cfg, packed params, recipe qcfg, the engine's serving qcfg)."""
    cfg, dense = _dense(ref, arch)
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format="packed")
    params = ptq.quantize_weights(dense, rglru.param_specs(cfg), qc)
    sq = dataclasses.replace(qc, quantize_weights=False, act_scope="row")
    return cfg, params, qc, sq


def _close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)


def _bf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# bitwise: the recurrence's pieces and the slab machinery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fresh", "state"])
def test_causal_conv_bitwise(ref, name):
    """Bitwise (bf16): the conv output and the new state, from zeros and
    from a decode state."""
    x, w, b, st = _conv_inputs()
    y, s = rglru._causal_conv(_bf(x), _bf(w), _bf(b),
                              None if name == "fresh" else _bf(st))
    assert y.dtype == s.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), ref[f"conv/{name}/y"])
    np.testing.assert_array_equal(s.float().numpy(), ref[f"conv/{name}/state"])


@pytest.mark.parametrize("n", SCAN_LENS)
def test_lru_scan_bitwise(ref, n):
    """Bitwise (f32) against the reference's eager scan, at odd, even and
    power-of-two lengths; and the sequential recurrence within 1e-5."""
    a, b = _scan_inputs(n)
    h = rglru._lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(h.numpy(), ref[f"scan/{n}"])
    seq, hp = [], np.zeros_like(a[:, 0])
    for t in range(n):
        hp = a[:, t] * hp + b[:, t]
        seq.append(hp)
    np.testing.assert_allclose(h.numpy(), np.stack(seq, 1), rtol=1e-5,
                               atol=1e-6)


def test_ring_align_bitwise(ref):
    """Bitwise: the last ``window`` positions, slot p % window holding
    position p, as the reference's prefill lays them out."""
    a = _rng(5).standard_normal((2, 1, 21, 3, 4)).astype(np.float32)
    got = attn.ring_align(torch.from_numpy(a[:, 0]), 16)
    np.testing.assert_array_equal(got.numpy(), ref["ring"][:, 0])
    for p in range(21 - 16, 21):
        np.testing.assert_array_equal(got[:, p % 16].numpy(), a[:, 0, p])


def _slab_trees(arch, n=3):
    cfg = configs.get_smoke(arch)
    lay = _slab_layout(cfg)
    sp = rglru.slot_state_specs(cfg, N_SLOTS, S_ALLOC)

    def port(tree):
        flat = _flat(tree)
        return _unflat({k: torch.from_numpy(v).to(
            torch.float32 if lay[k][1] else torch.bfloat16)
            for k, v in flat.items()}, "")
    return sp, [port(_unflat(_rand_tree(lay, 100 + j), "")) for j in range(n)]


def _assert_tree_bitwise(got, ref, prefix):
    flat = _flat(to_numpy(got))
    want = _flat(_unflat(ref, prefix))
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_machinery_bitwise(ref, arch):
    """Bitwise: ``merge_slot_state`` (slots 0 and 2 new, 1 old),
    ``slab_write`` of a short cache into slot 1 (zero-padded on the
    sequence axis) and ``slab_restore_select`` over a chain of three
    trees; none of them writes its inputs."""
    sp, trees = _slab_trees(arch)
    before = [tree_map(torch.clone, t) for t in trees]
    merged = common.merge_slot_state(sp, trees[0], trees[1],
                                     torch.tensor([True, False, True]))
    _assert_tree_bitwise(merged, ref, f"{arch}/merge/")
    one = params_from_numpy(_unflat(ref, f"{arch}/write_in/"), "cpu",
                            torch.float32)
    _assert_tree_bitwise(state_mod.slab_write(sp, trees[0], one, 1), ref,
                         f"{arch}/write/")
    _assert_tree_bitwise(state_mod.slab_restore_select(sp, trees, [2, 0, 1]),
                         ref, f"{arch}/restore/")
    for t, b in zip(trees, before):
        assert all(torch.equal(x, y) for x, y in zip(common.tree_leaves(t),
                                                      common.tree_leaves(b)))


# ---------------------------------------------------------------------------
# tolerance: forwards against the jitted reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["bf16", "nvfp4"])
def test_apply_logits_match(ref, arch, name):
    """Tolerance: teacher-forcing logits, the BF16 teacher and the hybrid
    recipe's NVFP4 student (fake-quantized at run time), over 20 tokens
    (past recurrentgemma's window)."""
    cfg, dense = _dense(ref, arch)
    qc = {"bf16": qconfig.BF16, "nvfp4": specs.recipe_qconfig(cfg)}[name]
    toks = torch.from_numpy(_rng(0).integers(4, cfg.vocab_size,
                                             (2, APPLY_LEN))).long()
    with torch.no_grad():
        got = rglru.apply(cfg, dense, {"tokens": toks}, qc)
    assert got.shape == (2, APPLY_LEN, cfg.vocab_size)
    _close(got, ref[f"{arch}/apply/{name}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_slot_decode_logits_match(ref, arch):
    """Tolerance: the engine's path over packed weights, the reference's
    oracle (its ``prefill`` and ``decode_step_slots``, not its
    ``serve_batch``): two prompts prefilled into slots 0 and 1 through
    ``slab_write``, then two slot decode steps, slot 0 alone and then
    slots 0 and 1 at independent positions; slot 2, idle, stays zero."""
    cfg, params, _, sq = _packed(ref, arch)
    prompts, lens, active, dtoks = _slot_inputs(cfg.vocab_size)
    sp = rglru.slot_state_specs(cfg, N_SLOTS, S_ALLOC)
    data = common.zeros_from_specs(sp, "cpu")
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            lg, cache = rglru.prefill(cfg, params,
                                      {"tokens": torch.from_numpy(p[None]).long()},
                                      sq, None)
            _close(lg, ref[f"{arch}/prefill/{slot}"])
            cache.pop("pos")
            data = state_mod.slab_write(sp, data, cache, slot)
        for i in range(2):
            lg, data = rglru.decode_step_slots(
                cfg, params, data, {"tokens": torch.from_numpy(dtoks[i]).long()},
                torch.from_numpy(lens[i]), torch.from_numpy(active[i]), sq)
            rows = active[i]
            _close(lg[rows], ref[f"{arch}/slots/{i}"][rows])
    for leaf, spec in zip(common.tree_leaves(data), common.tree_leaves(sp)):
        assert not leaf.narrow(spec.axes.index("batch"), 2, 1).any()


def test_windowless_prefill_pads_kv_to_s_max(ref):
    """Reference finding 1: on the nemotron smoke config a 5-token prompt
    with ``s_max=9`` gets attention KV of 5 positions from the reference
    and of 9 from the port, whose decode then writes position 5 into its
    own slot; ``serve_batch`` over the padded cache equals decoding step
    by step with the same cache."""
    cfg, params, _, sq = _packed(ref, NEMO)
    toks = torch.from_numpy(_rng(6).integers(4, cfg.vocab_size, (1, 5))).long()
    assert list(ref["finding1/kv_shape"]) == [2, 1, 5, 2, 16]
    with torch.inference_mode():
        _, cache = rglru.prefill(cfg, params, {"tokens": toks}, sq, s_max=9)
        assert list(cache["blocks"]["kv"]["k"].shape) == [2, 1, 9, 2, 16]
        assert not cache["blocks"]["kv"]["k"][:, :, 5:].any()
        _, cache = rglru.decode_step(cfg, params, cache,
                                     {"tokens": toks[:, :1]}, sq)
    kv = cache["blocks"]["kv"]["k"]
    assert kv[:, :, 5].any() and not kv[:, :, 6:].any()
    assert cache["pos"] == 6


# ---------------------------------------------------------------------------
# greedy tokens: the slab engine against serve_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_engine_matches_serve_batch(ref, arch):
    """Greedy tokens: mixed prompt lengths (past the window of 16 on
    recurrentgemma, so its ring wraps in prefill and in decode),
    staggered arrivals over 3 slots; every request equals a single-request
    ``serve_batch``, and every slot is released."""
    cfg, params, qc, _ = _packed(ref, arch)
    rng = _rng(8)
    prompts = [rng.integers(4, cfg.vocab_size, (n,)).astype(np.int32)
               for n in ENGINE_LENS]
    eng = Engine(cfg, params, qc, n_slots=3, block_size=8,
                 max_blocks_per_slot=4, device="cpu")
    assert eng.state_plan == (("recurrent", "dense_kv") if arch == NEMO
                              else ("recurrent", "window_kv"))
    rids, outs = serve.run_workload(eng, prompts, ENGINE_GEN)
    for rid, p in zip(rids, prompts):
        toks, _ = serve.serve_batch(cfg, params, torch.from_numpy(p[None]).long(),
                                    ENGINE_GEN, qcfg=qc)
        np.testing.assert_array_equal(outs[rid], toks[0].numpy())
    st = eng.stats()
    assert eng.pool is None and not eng.state.leaked()
    assert st["state_backend"] == "slab" and st["peak_used_slots"] == 3
    assert st["state_dense_bound"] == (32 if arch == NEMO else None)
    assert st["state_bytes_per_slot"] == state_mod.slab_bytes_per_slot(
        eng.state.specs, 3)


def test_slab_snapshot_is_never_written(ref):
    """Bitwise: a snapshot taken mid-run keeps its bytes through later
    decode steps and prefills, and ``restore_select`` puts each slot's
    snapshot rows back exactly."""
    cfg, params, qc, _ = _packed(ref, RG)
    rng = _rng(9)
    prompts = [rng.integers(4, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (18, 5, 11)]
    eng = Engine(cfg, params, qc, n_slots=3, block_size=8,
                 max_blocks_per_slot=4, device="cpu")
    for p in prompts[:2]:
        eng.submit(p, 8)
    eng.step()
    snap = eng.state.snapshot()
    saved = tree_map(torch.clone, snap)
    eng.submit(prompts[2], 8)
    eng.step()
    eng.step()
    assert all(torch.equal(a, b) for a, b in zip(common.tree_leaves(snap),
                                                 common.tree_leaves(saved)))
    now = eng.state.snapshot()
    eng.state.restore_select([snap, now], [0, 1, 1])
    for spec, got, old, new in zip(common.tree_leaves(eng.state.specs),
                                   common.tree_leaves(eng.state.data),
                                   common.tree_leaves(saved),
                                   common.tree_leaves(now)):
        ax = spec.axes.index("batch")
        assert torch.equal(got.narrow(ax, 0, 1), old.narrow(ax, 0, 1))
        assert torch.equal(got.narrow(ax, 1, 2), new.narrow(ax, 1, 2))
    eng.state.restore(now)
    eng.drain(max_steps=100)
    assert not eng.state.leaked()


def test_family_dispatch_and_refusals():
    """``get_model`` gives the rglru module for ``rglru_hybrid`` (and the
    rwkv6, whisper and decoder modules for the other families, M-RoPE's
    qwen2-vl included); a dense-KV slab refuses a request that cannot
    fit; the family passes the tensor-parallel check at tp = 2 (served,
    ``test_torch_tp_slab_rglru.py``), and it refuses a ``d_rnn`` that does
    not split in whole 16-value blocks, naming it; FP8 KV and MoE
    (arctic-480b) pass the check."""
    from repro_torch.models import decoder, rwkv6, whisper
    cfg = configs.get_smoke(NEMO)
    assert get_model(cfg) is rglru
    assert get_model(configs.get_smoke(RG)) is rglru
    for arch, module in (("rwkv6-3b", rwkv6), ("whisper-tiny", whisper),
                         ("qwen2-vl-2b", decoder)):
        c = configs.get_smoke(arch)
        assert get_model(c) is module and module.param_specs(c)
    arctic = configs.get_smoke("arctic-480b")
    assert get_model(arctic).param_specs(arctic)
    params = rglru.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, n_slots=2, block_size=8, max_blocks_per_slot=2,
                 device="cpu")
    with pytest.raises(ValueError, match="capacity=16"):
        eng.submit(np.arange(4, 14, dtype=np.int32), 8)
    from repro_torch.serve import engine as engine_mod
    assert engine_mod._check_tp(cfg, 2) is None
    with pytest.raises(NotImplementedError, match="nemotron.*d_rnn"):
        engine_mod._check_tp(dataclasses.replace(cfg, d_rnn=48), 2)
    assert engine_mod._check_tp(arctic, 2) is None


# ---------------------------------------------------------------------------
# tolerance: one QAD step
# ---------------------------------------------------------------------------


def test_qad_step_matches_reference(ref):
    """Tolerance (the module docstring): one QAD step on the nemotron
    smoke config through ``get_model(cfg).apply``: loss and KL rtol 1e-4,
    the norms within 1e-2 and the moments within 2e-2 relative L2, each
    updated parameter within one bf16 ulp plus 2 lr."""
    cfg, dense = _dense(ref, NEMO)
    model = get_model(cfg)
    toks, labels, mask = _batch_np(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=dense, teacher=tree_map(torch.clone, dense),
                           opt_state=opt.init(dense))
    new, m = qad.make_train_step(model, cfg, specs.recipe_qconfig(cfg),
                                 opt)(state, batch)
    for k in ("loss", "kl", "ce"):
        np.testing.assert_allclose(float(m[k]), ref[f"qad/metrics/{k}"],
                                   rtol=1e-4)
    for k in ("grad_norm", "update_norm"):
        np.testing.assert_allclose(float(m[k]), ref[f"qad/metrics/{k}"],
                                   rtol=1e-2)
    _assert_tree_rel_l2(to_numpy(new.opt_state.m), ref, "qad/m/", 2e-2)
    sqrt_v = {k: np.sqrt(v) for k, v in ref.items() if k.startswith("qad/v/")}
    _assert_tree_rel_l2(tree_map(np.sqrt, to_numpy(new.opt_state.v)), sqrt_v,
                        "qad/v/", 2e-2)
    got = _flat(to_numpy(new.student))
    want = _flat(_unflat(ref, "qad/student/"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        lim = _bf16_ulp(np.maximum(np.abs(got[k]), np.abs(w))) + 2 * LR
        assert (np.abs(got[k] - w) <= lim).all(), k


def test_bridge_carries_two_axis_packed_stacks(ref):
    """Bitwise: a packed rglru tree (``blocks/rec`` over two leading axes,
    a tensor scale per [layer, inner] slice) goes through
    ``bridge.to_numpy`` and ``params_from_numpy`` unchanged, and a slice
    keeps ``orig_k`` and its scale's shape."""
    cfg, params, _, _ = _packed(ref, NEMO)
    back = params_from_numpy(to_numpy(params), "cpu")
    wx = back["blocks"]["rec"]["wx"]
    n_sb, n_rec = rglru._counts(cfg)[:2]
    assert wx.tensor_scale.shape == (n_sb, n_rec, 1, 1)
    assert wx[1][0].orig_k == cfg.d_model and wx[1][0].tensor_scale.shape == (1, 1)
    for a, b in zip(common.tree_leaves(params), common.tree_leaves(back)):
        if isinstance(a, nvfp4.PackedNVFP4):
            assert a.orig_k == b.orig_k
            assert all(torch.equal(x, y) for x, y in (
                (a.codes, b.codes), (a.scales.float(), b.scales.float()),
                (a.tensor_scale, b.tensor_scale)))
        else:
            assert torch.equal(a, b)
