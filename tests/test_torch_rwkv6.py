"""The RWKV6 family (``models/rwkv6.py``) in the PyTorch port against the
JAX package, on the CPU, at the ``rwkv6-3b-smoke`` config, and through the
engine's slab backend.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (see ``test_torch_serve.py``) on
numpy-seeded inputs and its own ``init_params``, bridged to the port
(``bridge.params_from_numpy``); the port packs them with its own PTQ and
hands the packed tree to the reference (``jax_packed``), whose packed
GEMMs run in their dense form (cheaper than its Pallas kernel in
interpret mode, and equal to it on greedy tokens).

Parity levels, as each test names them:

  * **tolerance** (f32): ``_wkv_chunked`` at 64 and 128 tokens (one and
    two chunks) from a nonzero state, with decays at 0 and near it, within
    1e-5 relative to the output's scale (the reference's dots and its
    cumulative sum add in other orders than torch's, an ulp or two);
  * **tolerance**: ``apply``, ``prefill`` and ``decode_step_slots``
    logits, relative L2 over each position's vocabulary within 5e-2 (the
    size of ``test_torch_rglru.py``'s level).  XLA's exp and logistic and
    the orders above move a bf16 value by an ulp here and there, and the
    time mix's per-head group norm amplifies it where a head's output
    varies little: on the BF16 teacher over 128 tokens one position in
    256 reaches 0.024 (1.8e-3 over all logits), where elementwise 5e-2
    would fail 3 values in 131072 (measured);
  * **greedy tokens**: the port's slab engine against the reference's
    ``serve_batch`` on mixed prompts, one of them 128 tokens (two WKV
    chunks).  With excess precision on, the reference's own slab-engine
    parity test for rwkv6 fails (``ROADMAP.md`` C.3); with it off its
    ``serve_batch`` is a valid oracle;
  * **tolerance**: one QAD step against the reference's jitted step, at
    ``test_torch_rglru.py``'s levels.
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
from repro_torch.core import ptq, qad, qconfig
from repro_torch.launch import serve, specs
from repro_torch.models import common, get_model, rwkv6
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.serve import Engine
from repro_torch.serve import state as state_mod
from test_torch_serve import _flat, _unflat
from test_torch_train import (LR, TOTAL, WARMUP, _assert_tree_rel_l2,
                              _batch_np, _bf16_ulp)

ARCH = "rwkv6-3b"
TOL = 5e-2
WKV_LENS = (64, 128)
APPLY_LEN = 128                # two WKV chunks
SLOT_LEN = 20
N_SLOTS, S_ALLOC = 3, 32
ENGINE_LENS = [9, 64, 128]
ENGINE_GEN = 6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(i):
    return np.random.default_rng(60 + i)


def _wkv_inputs(s):
    """r, k, v, w [2, s, 2, 8], u [2, 8], s0 [2, 2, 8, 8]; a few decays at
    0 and at 1e-35 (``log`` then sees the clip at 1e-30)."""
    rng = _rng(s)
    r, k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.0, 1.0, (2, s, 2, 8)).astype(np.float32)
    w[0, 3, 1, :3] = 0.0
    w[1, s - 5, 0, 2:6] = 1e-35
    u = rng.standard_normal((2, 8)).astype(np.float32)
    s0 = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    return r, k, v, w, u, s0


def _slot_inputs(vocab):
    """Two prompts prefilled into slots 0 and 1, then two slot decode
    steps: slot 0 alone, then slots 0 and 1 (slot 2 idle throughout)."""
    rng = _rng(1)
    prompts = [rng.integers(4, vocab, (SLOT_LEN,)).astype(np.int32)
               for _ in range(2)]
    lens = np.asarray([[SLOT_LEN, SLOT_LEN, 0], [SLOT_LEN + 1, SLOT_LEN, 0]],
                      np.int32)
    active = np.asarray([[True, False, False], [True, True, False]])
    toks = rng.integers(4, vocab, (2, N_SLOTS, 1)).astype(np.int32)
    return prompts, lens, active, toks


def _engine_prompts(vocab):
    rng = _rng(8)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in ENGINE_LENS]


def jax_packed(arch, port_model, dense):
    """The port's PTQ of the reference's dense tree ``dense``, as the
    reference's packed tree (the two PTQs are bitwise equal,
    ``test_torch_nvfp4.py``; the port's is quicker here).  Runs in the JAX
    subprocess."""
    import jax
    import jax.numpy as jnp

    from repro.core.nvfp4 import PackedNVFP4 as JPacked

    tcfg = configs.get_smoke(arch) if isinstance(arch, str) else arch
    tq = dataclasses.replace(specs.recipe_qconfig(tcfg),
                             weight_format="packed")
    tp = ptq.quantize_weights(
        params_from_numpy(jax.tree.map(
            lambda a: np.asarray(a).astype(np.float32), dense), "cpu"),
        port_model.param_specs(tcfg), tq)

    def one(t):
        if isinstance(t, dict) and "codes" in t:
            return JPacked(jnp.asarray(t["codes"]),
                           jnp.asarray(t["scales"]).astype(jnp.float8_e4m3fn),
                           jnp.asarray(t["tensor_scale"]), t["orig_k"])
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return jnp.asarray(t).astype(jnp.bfloat16)
    return one(to_numpy(tp))


def jax_qad_step(model, cfg, dense, batch, res, prefix="qad"):
    """One jitted reference QAD step on ``dense`` into ``res`` (metrics,
    the student and the moments).  Runs in the JAX subprocess."""
    import jax
    import jax.numpy as jnp

    from repro.core import qad as jqad
    from repro.launch import specs as jspecs
    from repro.optim import AdamW as JAdamW
    from repro.optim import warmup_cosine as jwarmup_cosine

    opt = JAdamW(lr=jwarmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=dense,
                            teacher=jax.tree.map(jnp.copy, dense),
                            opt_state=opt.init(dense))
    new, m = jax.jit(jqad.make_train_step(model, cfg,
                                          jspecs.recipe_qconfig(cfg), opt))(
        state, batch)
    for k, v in m.items():
        res[f"{prefix}/metrics/{k}"] = np.asarray(v).astype(np.float32)
    for name, tree in (("student", new.student), ("m", new.opt_state.m),
                       ("v", new.opt_state.v)):
        for k, v in _flat(tree).items():
            res[f"{prefix}/{name}/{k}"] = np.asarray(v).astype(np.float32)


def check_qad_step(cfg, dense, batch, ref, prefix="qad", kl_rtol=1e-4):
    """One port QAD step through ``get_model(cfg).apply`` against the
    reference's (``jax_qad_step``): loss, KL and CE rtol 1e-4 (loss and KL
    ``kl_rtol``), the norms within 1e-2 and the moments within 2e-2
    relative L2, each updated parameter within one bf16 ulp plus 2 lr
    (``test_torch_rglru.py``'s levels)."""
    model = get_model(cfg)
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=dense, teacher=tree_map(torch.clone, dense),
                           opt_state=opt.init(dense))
    new, m = qad.make_train_step(model, cfg, specs.recipe_qconfig(cfg),
                                 opt)(state, batch)
    for k, tol in (("loss", kl_rtol), ("kl", kl_rtol), ("ce", 1e-4)):
        np.testing.assert_allclose(float(m[k]), ref[f"{prefix}/metrics/{k}"],
                                   rtol=tol)
    for k in ("grad_norm", "update_norm"):
        np.testing.assert_allclose(float(m[k]), ref[f"{prefix}/metrics/{k}"],
                                   rtol=1e-2)
    _assert_tree_rel_l2(to_numpy(new.opt_state.m), ref, f"{prefix}/m/", 2e-2)
    sqrt_v = {k: np.sqrt(v) for k, v in ref.items()
              if k.startswith(f"{prefix}/v/")}
    _assert_tree_rel_l2(tree_map(np.sqrt, to_numpy(new.opt_state.v)), sqrt_v,
                        f"{prefix}/v/", 2e-2)
    got = _flat(to_numpy(new.student))
    want = _flat(_unflat(ref, f"{prefix}/student/"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        lim = _bf16_ulp(np.maximum(np.abs(got[k]), np.abs(w))) + 2 * LR
        assert (np.abs(got[k] - w) <= lim).all(), k


def run_reference(module: str, out: str, timeout: int = 600) -> dict:
    """``module._reference(out)`` in a JAX subprocess with excess precision
    off; returns its arrays."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = f"import {module} as t; t._reference({out!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.qconfig import BF16
    from repro.launch import serve as jserve
    from repro.launch import specs as jspecs
    from repro.models import common as jcommon
    from repro.models import rwkv6 as jrwkv6
    from repro.serve import state as jstate

    def f32(a):
        return np.asarray(a).astype(np.float32)

    res = {}
    wkv = jax.jit(jrwkv6._wkv_chunked)
    for s in WKV_LENS:
        out, sf = wkv(*map(jnp.asarray, _wkv_inputs(s)))
        res[f"wkv/{s}/out"], res[f"wkv/{s}/state"] = f32(out), f32(sf)

    cfg = jconfigs.get_smoke(ARCH)
    dense = jax.jit(lambda r: jrwkv6.init_params(cfg, r))(jax.random.PRNGKey(0))
    for k, v in _flat(dense).items():
        res[f"params/{k}"] = f32(v)
    toks = jnp.asarray(_rng(0).integers(4, cfg.vocab_size,
                                        (2, APPLY_LEN)).astype(np.int32))
    qc = jspecs.recipe_qconfig(cfg)
    for name, q in (("bf16", BF16), ("nvfp4", qc)):
        res[f"apply/{name}"] = f32(jax.jit(
            lambda p, t: jrwkv6.apply(cfg, p, {"tokens": t}, q))(dense, toks))

    # the slab path over packed weights: prefill into slots through
    # slab_write, then two decode_step_slots steps
    params = jax_packed(ARCH, rwkv6, dense)
    sq = dataclasses.replace(qc, weight_format="packed",
                             quantize_weights=False, act_scope="row",
                             packed_backend="dequant")
    prompts, lens, active, dtoks = _slot_inputs(cfg.vocab_size)
    specs_ = jrwkv6.slot_state_specs(cfg, N_SLOTS, S_ALLOC)
    data = jcommon.zeros_from_specs(specs_)
    pre = jax.jit(lambda p, t: jrwkv6.prefill(cfg, p, {"tokens": t}, sq, None))
    write = jax.jit(lambda d, c, slot: jstate.slab_write(specs_, d, c, slot))
    for slot, p in enumerate(prompts):
        lg, cache = pre(params, jnp.asarray(p[None]))
        res[f"prefill/{slot}"] = f32(lg)
        cache = {k: v for k, v in cache.items() if k != "pos"}
        data = write(data, cache, jnp.asarray(slot, jnp.int32))
    step = jax.jit(lambda p, d, t, l, a: jrwkv6.decode_step_slots(
        cfg, p, d, {"tokens": t}, l, a, sq))
    for i in range(2):
        lg, data = step(params, data, jnp.asarray(dtoks[i]),
                        jnp.asarray(lens[i]), jnp.asarray(active[i]))
        res[f"slots/{i}"] = f32(lg)

    # greedy tokens of single-request serve_batch on the engine's prompts,
    # its packed GEMMs through the Pallas kernel: at M = 1 the dense form
    # fused into the jit can part from the exact product by tens of bf16
    # ulps with excess precision off (ROADMAP.md C.8), the kernel sums in f32
    bq = dataclasses.replace(qc, weight_format="packed")
    for i, p in enumerate(_engine_prompts(cfg.vocab_size)):
        toks, _ = jserve.serve_batch(cfg, params, jnp.asarray(p[None]),
                                     ENGINE_GEN, qcfg=bq)
        res[f"serve_batch/{i}"] = np.asarray(toks[0])

    toks, labels, mask = _batch_np(cfg.vocab_size)
    jax_qad_step(jrwkv6, cfg, dense,
                 {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                  "mask": jnp.asarray(mask)}, res)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_rwkv6_ref") / "ref.npz")
    return run_reference("test_torch_rwkv6", out)


def _dense(ref):
    cfg = configs.get_smoke(ARCH)
    return cfg, params_from_numpy(_unflat(ref, "params/"), "cpu")


def _packed(ref):
    """(cfg, packed params, recipe qcfg, the engine's serving qcfg)."""
    cfg, dense = _dense(ref)
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format="packed")
    params = ptq.quantize_weights(dense, rwkv6.param_specs(cfg), qc)
    sq = dataclasses.replace(qc, quantize_weights=False, act_scope="row")
    return cfg, params, qc, sq


def close_by_position(got: torch.Tensor, want: np.ndarray, tol=TOL):
    """Relative L2 of each position's logits (the last axis) within
    ``tol``."""
    got = got.float().numpy()
    assert got.shape == want.shape
    rel = (np.linalg.norm(got - want, axis=-1)
           / np.maximum(np.linalg.norm(want, axis=-1), 1e-30))
    assert rel.max() <= tol, (rel.max(), np.unravel_index(rel.argmax(),
                                                          rel.shape))


# ---------------------------------------------------------------------------
# the chunked WKV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", WKV_LENS)
def test_wkv_chunked_matches_reference(ref, s):
    """Tolerance (f32): the output and the final state within 1e-5 of
    their scale, against the reference's jitted two-pass scan; and the
    per-token recurrence within 1e-4 of it (the chunked form's
    ``exp(cumsum(log w))`` is another sum than the running products)."""
    r, k, v, w, u, s0 = _wkv_inputs(s)
    out, sf = rwkv6._wkv_chunked(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    for got, key in ((out, "out"), (sf, "state")):
        want = ref[f"wkv/{s}/{key}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    st, seq = s0.copy(), []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        seq.append(np.einsum("bhi,bhij->bhj", r[:, t],
                             st + u[None, :, :, None] * kv))
        st = w[:, t, :, :, None] * st + kv
    seq = np.stack(seq, 1)
    np.testing.assert_allclose(out.numpy(), seq, rtol=0,
                               atol=1e-4 * np.abs(seq).max())
    np.testing.assert_allclose(sf.numpy(), st, rtol=0,
                               atol=1e-4 * np.abs(st).max())


@pytest.mark.parametrize("s", [65, 100, 130])
def test_wkv_refuses_lengths_off_its_chunks(s):
    """The reference's contract: at most 64 tokens or a multiple of 64; any
    other length raises (padding would change the state), from the model's
    prefill too."""
    args = [torch.zeros((1, s, 2, 8)) for _ in range(4)]
    with pytest.raises(ValueError, match=r"s % min\(64, s\) == 0"):
        rwkv6._wkv_chunked(*args, torch.zeros((2, 8)), torch.zeros((1, 2, 8, 8)))
    cfg = configs.get_smoke(ARCH)
    params = rwkv6.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="multiple of 64"):
        rwkv6.prefill(cfg, params, {"tokens": torch.zeros((1, s),
                                                          dtype=torch.long)},
                      specs.serve_qconfig(cfg))


# ---------------------------------------------------------------------------
# tolerance: forwards against the jitted reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bf16", "nvfp4"])
def test_apply_logits_match(ref, name):
    """Tolerance: teacher-forcing logits over 128 tokens (two WKV chunks),
    the BF16 teacher and the NVFP4 student (fake-quantized at run time)."""
    cfg, dense = _dense(ref)
    qc = {"bf16": qconfig.BF16, "nvfp4": specs.recipe_qconfig(cfg)}[name]
    toks = torch.from_numpy(_rng(0).integers(4, cfg.vocab_size,
                                             (2, APPLY_LEN))).long()
    with torch.no_grad():
        got = rwkv6.apply(cfg, dense, {"tokens": toks}, qc)
    assert got.shape == (2, APPLY_LEN, cfg.vocab_size)
    close_by_position(got, ref[f"apply/{name}"])


def test_prefill_and_slot_decode_logits_match(ref):
    """Tolerance: two prompts prefilled into slots 0 and 1 through
    ``slab_write``, then two slot decode steps (slot 0 alone, then slots 0
    and 1); slot 2, idle, stays zero."""
    cfg, params, _, sq = _packed(ref)
    prompts, lens, active, dtoks = _slot_inputs(cfg.vocab_size)
    sp = rwkv6.slot_state_specs(cfg, N_SLOTS, S_ALLOC)
    data = common.zeros_from_specs(sp, "cpu")
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            lg, cache = rwkv6.prefill(
                cfg, params, {"tokens": torch.from_numpy(p[None]).long()}, sq)
            close_by_position(lg, ref[f"prefill/{slot}"])
            cache.pop("pos")
            data = state_mod.slab_write(sp, data, cache, slot)
        for i in range(2):
            lg, data = rwkv6.decode_step_slots(
                cfg, params, data, {"tokens": torch.from_numpy(dtoks[i]).long()},
                torch.from_numpy(lens[i]), torch.from_numpy(active[i]), sq)
            rows = active[i]
            close_by_position(lg[rows], ref[f"slots/{i}"][rows])
    for leaf, spec in zip(common.tree_leaves(data), common.tree_leaves(sp)):
        assert not leaf.narrow(spec.axes.index("batch"), 2, 1).any()


# ---------------------------------------------------------------------------
# greedy tokens: the slab engine against the reference's serve_batch
# ---------------------------------------------------------------------------


def test_slab_engine_matches_reference_serve_batch(ref):
    """Greedy tokens: prompts of 9, 64 and 128 tokens, staggered over 2
    slots on the plan ("recurrent",); every request equals the
    reference's single-request ``serve_batch`` (and the port's), every
    slot is released, and a slot's state is constant in size."""
    cfg, params, qc, _ = _packed(ref)
    prompts = _engine_prompts(cfg.vocab_size)
    eng = Engine(cfg, params, qc, n_slots=2, block_size=8,
                 max_blocks_per_slot=4, device="cpu")
    assert eng.state_plan == ("recurrent",)
    rids, outs = serve.run_workload(eng, prompts, ENGINE_GEN)
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        np.testing.assert_array_equal(outs[rid], ref[f"serve_batch/{i}"])
        toks, _ = serve.serve_batch(cfg, params,
                                    torch.from_numpy(p[None]).long(),
                                    ENGINE_GEN, qcfg=qc)
        np.testing.assert_array_equal(outs[rid], toks[0].numpy())
    st = eng.stats()
    assert eng.pool is None and not eng.state.leaked()
    assert st["state_backend"] == "slab" and st["state_dense_bound"] is None
    h, n = rwkv6._n_heads(cfg), cfg.rwkv_head_dim
    assert st["state_bytes_per_slot"] == cfg.n_layers * (
        h * n * n * 4 + 2 * cfg.d_model * 2)


# ---------------------------------------------------------------------------
# tolerance: one QAD step
# ---------------------------------------------------------------------------


def test_qad_step_matches_reference(ref):
    """Tolerance (``check_qad_step``): one QAD step on the smoke config."""
    cfg, dense = _dense(ref)
    toks, labels, mask = _batch_np(cfg.vocab_size)
    check_qad_step(cfg, dense, {"tokens": torch.from_numpy(toks).long(),
                                "labels": torch.from_numpy(labels).long(),
                                "mask": torch.from_numpy(mask)}, ref)
