"""The rest of QAD training in the PyTorch port against the JAX package, on
the CPU: rematerialization, MoE QAD, teacher-generated data and activation
calibration.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (see ``test_torch_train.py``) on
numpy-seeded inputs and its own ``init_params``, bridged to the port.

Parity levels, as each test names them:

  * **bitwise**, rematerialization: one port QAD step under ``remat``
    "none", "dots" and "full" gives the same loss, gradients, moments and
    updated parameters, on ``olmo-1b-smoke`` and ``qwen2-moe-a2.7b-smoke``;
  * **tolerance**, one QAD step against the reference's jitted step (its
    "full" remat; the MoE model under global and local capacity dispatch):
    ``test_torch_train.py``'s levels, loss and KL rtol 1e-5, every
    gradient leaf (router and expert stacks included; the reference's
    gradient read from its first AdamW moment, which is the clipped
    gradient times 1 - b1) and the moments within 1e-2 relative L2, each
    updated parameter within one bf16 ulp plus 2 lr; ``moe_ffn``'s own gradients within 1e-2 relative L2 and
    its dropped fraction equal;
  * **greedy tokens**, ``generate_tokens`` at temperature 1e-6 from BOS
    and from seeded prompts; **bitwise**, the top-p mask (with ties),
    ``bos_prompts`` and ``batch_from_generated``;
  * **bitwise**, the calibrated amaxes (max, percentile, mse).
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
from repro_torch.core import ptq, qad
from repro_torch.core.qconfig import BF16
from repro_torch.data import DataConfig, eval_batches, generated
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.models import common, decoder, get_model, layers
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim import adamw
from repro_torch.optim.adamw import global_norm
from test_torch_train import (LR, TOTAL, WARMUP, _assert_tree_rel_l2,
                              _batch_np, _bf16_ulp, _flat, _rel_l2, _unflat)

DENSE, MOE = "olmo-1b", "qwen2-moe-a2.7b"
# (case, arch, moe_dispatch, remat of the reference's step)
STEP_CASES = [("dense_full", DENSE, None, "full"),
              ("moe_global_full", MOE, "global", "full"),
              ("moe_local", MOE, "local", "none")]
REMATS = ("none", "dots", "full")
GEN_NEW = 6
# activation samples for calibration: (name, shape); one length is not a
# multiple of the 16-value block
CALIB = [("a", (3, 40)), ("b", (2, 5, 37))]
TOP_P = (0.5, 0.9)



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: these tests run long chains of small
    torch ops, which slow down many times over when the suite's parallel
    workers each spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfg(arch, dispatch=None, remat="none"):
    cfg = configs.get_smoke(arch)
    kw = {"remat": remat}
    if dispatch:
        kw["moe_dispatch"] = dispatch
    return dataclasses.replace(cfg, **kw)


def _calib_acts(i):
    rng = np.random.default_rng(20 + i)
    out = {}
    for name, shape in CALIB:
        a = rng.standard_normal(shape).astype(np.float32)
        a.reshape(-1)[rng.integers(0, a.size, 3)] *= 9.0       # outliers
        out[name] = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return out


def _top_p_logits():
    rng = np.random.default_rng(9)
    lg = (rng.standard_normal((4, 1, 300)) * 2).astype(np.float32)
    lg[:, :, 10:20] = lg[:, :, 5:6]             # ties, some near the cutoff
    lg[1, :, :150] = lg[1, :, 150:]             # every value twice
    return lg


def _prompts(vocab):
    return np.random.default_rng(4).integers(4, vocab, (2, 5)).astype(np.int32)


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import ptq as jptq
    from repro.core.qconfig import BF16 as JBF16
    from repro.core import qad as jqad
    from repro.data import generated as jgen
    from repro.launch import specs as jspecs
    from repro.models import get_model as jget_model
    from repro.models import layers as jlayers
    from repro.optim import AdamW as JAdamW
    from repro.optim import warmup_cosine as jwarmup_cosine

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    res, inits = {}, {}
    for case, arch, dispatch, remat in STEP_CASES:
        kw = {"remat": remat}
        if dispatch:
            kw["moe_dispatch"] = dispatch
        cfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
        model = jget_model(cfg)
        qc = jspecs.recipe_qconfig(cfg)
        if arch not in inits:       # one compile, not one per leaf
            inits[arch] = jax.jit(lambda k, m=model, c=cfg: m.init_params(
                c, k))(jax.random.PRNGKey(0))
        params = inits[arch]
        for k, v in _flat(params).items():
            res[f"{case}/params/{k}"] = f32(v)
        toks, labels, mask = _batch_np(cfg.vocab_size)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                 "mask": jnp.asarray(mask)}
        opt = JAdamW(lr=jwarmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
        state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=params,
                                teacher=jax.tree.map(jnp.copy, params),
                                opt_state=opt.init(params))
        new, m = jax.jit(jqad.make_train_step(model, cfg, qc, opt))(state,
                                                                     batch)
        for k, v in m.items():
            res[f"{case}/step/metrics/{k}"] = f32(v)
        for name, tree in (("student", new.student), ("m", new.opt_state.m),
                           ("v", new.opt_state.v)):
            for k, v in _flat(tree).items():
                res[f"{case}/step/{name}/{k}"] = f32(v)

        if arch == MOE:
            # moe_ffn alone, unquantized (the capacity dispatch's backward
            # without NVFP4's amplification of rounding): its aux and its
            # gradients against a seeded cotangent, on layer 0's weights
            p0 = jax.tree.map(lambda a: a[0], params["layers"])
            x = jnp.asarray(_moe_x(cfg.d_model))
            g = jnp.asarray(_moe_g(cfg.d_model))

            def moe(x, r, wg, wu, wd):
                out, aux = jlayers.moe_ffn(JBF16, cfg, x, r, wg, wu, wd)
                return jnp.sum(out.astype(jnp.float32) * g), aux

            (_, maux), mgrads = jax.jit(jax.value_and_grad(
                moe, argnums=(0, 1, 2, 3, 4), has_aux=True))(
                x, p0["router"], p0["moe_wg"], p0["moe_wu"], p0["moe_wd"])
            for name, v in zip(("x", "router", "wg", "wu", "wd"), mgrads):
                res[f"{case}/moe_ffn/grad/{name}"] = f32(v)
            for k, v in maux.items():
                res[f"{case}/moe_ffn/aux/{k}"] = f32(v)

        if case == "dense_full":
            # generated data: greedy (temperature 1e-6) from BOS and from
            # seeded prompts
            for name, prompts in (("bos", jgen.bos_prompts(2)),
                                  ("prompts", jnp.asarray(_prompts(
                                      cfg.vocab_size)))):
                # one compile for the whole loop (the eager prefill would
                # compile each of its operations)
                toks = jax.jit(lambda p, t: jgen.generate_tokens(
                    model, cfg, p, t, GEN_NEW, jax.random.PRNGKey(1),
                    temperature=1e-6))(params, prompts)
                res[f"gen/{name}"] = np.asarray(toks)
            res["gen/batch/tokens"] = np.asarray(jgen.batch_from_generated(
                res["gen/prompts"], 8)["tokens"])

    # the top-p mask: the logits ``sample`` hands to the categorical draw
    captured = []
    real = jax.random.categorical

    def spy(key, lg, axis=-1):
        captured.append(np.asarray(lg))
        return real(key, lg, axis)

    jax.random.categorical = spy

    class _Stub:
        @staticmethod
        def prefill(cfg, params, batch, qcfg, s_max):
            return jnp.asarray(_top_p_logits()), None
    for top_p in TOP_P:
        jgen.generate_tokens(_Stub, None, None, jnp.ones((4, 1), jnp.int32), 1,
                             jax.random.PRNGKey(0), temperature=0.7,
                             top_p=top_p)
        res[f"top_p/{top_p}"] = captured.pop()
    jax.random.categorical = real

    # calibration
    for method in ("max", "percentile", "mse"):
        obs = jptq.AmaxObserver(method=method)
        for i in range(2):
            obs.observe(jnp.asarray(_calib_acts(i)["b"], jnp.bfloat16))
        res[f"calib/observer/{method}"] = np.float64(obs.amax())
        got = jptq.calibrate_activations(
            lambda i: {k: jnp.asarray(v, jnp.bfloat16)
                       for k, v in _calib_acts(i).items()},
            range(2), [n for n, _ in CALIB], method)
        for site, amax in got.items():
            res[f"calib/{method}/{site}"] = np.float64(amax)
    np.savez(out_path, **res)


def _moe_x(d):
    x = np.random.default_rng(5).standard_normal((2, 8, d)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _moe_g(d):
    return np.random.default_rng(6).standard_normal((2, 8, d)).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_train_rest_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = f"import test_torch_train_rest as t; t._reference({out!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _params(ref, case, cfg):
    def fill(spec, path):
        if isinstance(spec, dict):
            return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
        return ref[f"{case}/params/{path[:-1]}"]
    return params_from_numpy(fill(get_model(cfg).param_specs(cfg), ""), "cpu")


def _setup(ref, case, remat=None):
    _, arch, dispatch, ref_remat = next(c for c in STEP_CASES if c[0] == case)
    cfg = _cfg(arch, dispatch, ref_remat if remat is None else remat)
    params = _params(ref, case, cfg)
    toks, labels, mask = _batch_np(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=params, teacher=tree_map(torch.clone, params),
                           opt_state=opt.init(params))
    return cfg, get_model(cfg), specs.recipe_qconfig(cfg), opt, state, batch


def _step(ref, case, remat=None):
    cfg, model, qc, opt, state, batch = _setup(ref, case, remat)
    loss_fn = qad.make_loss_fn(model, cfg, qc, qad.QADConfig(loss="kl"))
    loss, metrics, grads = qad.value_and_grad(loss_fn, state.student,
                                              state.teacher, batch)
    new, m = qad.make_train_step(model, cfg, qc, opt)(state, batch)
    return loss, metrics, grads, new, m


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dense_full", "moe_global_full"])
def test_remat_modes_bitwise_equal(ref, case):
    """Bitwise: loss, metrics, gradients, moments and the updated student
    of one QAD step under remat none, dots and full."""
    runs = {r: _step(ref, case, r) for r in REMATS}
    loss, metrics, grads, new, m = runs["none"]
    for r in ("dots", "full"):
        l2, met2, g2, new2, m2 = runs[r]
        assert torch.equal(loss, l2), r
        for k in ("kl", "ce", "top1_agree"):
            assert torch.equal(metrics[k], met2[k]), (r, k)
        for k in ("loss", "grad_norm", "update_norm"):
            assert torch.equal(m[k], m2[k]), (r, k)
        for a, b in zip(tree_leaves(grads), tree_leaves(g2)):
            assert torch.equal(a, b), r
        for part in ("student", "m", "v"):
            got = new.student if part == "student" else getattr(new.opt_state,
                                                                part)
            want = (new2.student if part == "student"
                    else getattr(new2.opt_state, part))
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(a, b), (r, part)


def _ref_grads(ref, case) -> dict:
    """The reference step's gradient, from its first AdamW moment: on step
    1, m = (1 - b1) g s, with the clip scale s = min(1, clip / |g|)."""
    opt = AdamW(lr=LR, clip_norm=1.0)
    gn = float(ref[f"{case}/step/metrics/grad_norm"])
    s = min(1.0, opt.clip_norm / max(gn, 1e-12))
    pre = f"{case}/step/m/"
    return {f"{case}/grads/{k[len(pre):]}": v / ((1 - opt.b1) * s)
            for k, v in ref.items() if k.startswith(pre)}


def _assert_step_matches(ref, case, loss, metrics, grads, new, m):
    np.testing.assert_allclose(float(loss), ref[f"{case}/step/metrics/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["kl"]),
                               ref[f"{case}/step/metrics/kl"], rtol=1e-5)
    _assert_tree_rel_l2(to_numpy(grads), _ref_grads(ref, case),
                        f"{case}/grads/", 1e-2)
    for k in ("loss", "kl", "ce"):
        np.testing.assert_allclose(float(m[k]), ref[f"{case}/step/metrics/{k}"],
                                   rtol=1e-5)
    for k in ("grad_norm", "update_norm"):
        np.testing.assert_allclose(float(m[k]), ref[f"{case}/step/metrics/{k}"],
                                   rtol=1e-2)
    _assert_tree_rel_l2(to_numpy(new.opt_state.m), ref, f"{case}/step/m/", 1e-2)
    sqrt_v = {k: np.sqrt(v) for k, v in ref.items()
              if k.startswith(f"{case}/step/v/")}
    _assert_tree_rel_l2(tree_map(np.sqrt, to_numpy(new.opt_state.v)), sqrt_v,
                        f"{case}/step/v/", 1e-2)
    got = _flat(to_numpy(new.student))
    want = _flat(_unflat(ref, f"{case}/step/student/"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        lim = _bf16_ulp(np.maximum(np.abs(got[k]), np.abs(w))) + 2 * LR
        assert (np.abs(got[k] - w) <= lim).all(), k


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_qad_step_matches_reference(ref, case):
    """Tolerance (the module docstring): one port QAD step against the
    reference's jitted step, under the reference's remat; for the MoE
    model under global and local dispatch, every leaf's gradient, the
    router and the expert stacks included."""
    _assert_step_matches(ref, case, *_step(ref, case))
    if case.startswith("moe"):
        assert {"router", "moe_wg", "moe_wu", "moe_wd", "sh_gate"} <= set(
            _unflat(_ref_grads(ref, case), f"{case}/grads/")["layers"])


def test_remat_saves_less_for_backward(ref, monkeypatch):
    """Bytes saved for the backward order none > dots > full; "full"
    saves no activation inside a layer (only the checkpoints' inputs),
    "dots" only the outputs of the weight GEMMs (``aten.mm``) there."""
    inside = [False]
    block = decoder._block

    def flagged(*a, **kw):
        inside[0] = True
        try:
            return block(*a, **kw)
        finally:
            inside[0] = False

    monkeypatch.setattr(decoder, "_block", flagged)
    cached = []
    policy = common._dots_policy

    def counting(ctx, func, *args, **kwargs):
        out = policy(ctx, func, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            cached.append((func, ctx.op_output.numel()
                           * ctx.op_output.element_size()))
        return out

    monkeypatch.setattr(common, "_dots_policy", counting)
    saved = {}
    for remat in REMATS:
        cfg, model, qc, _, state, batch = _setup(ref, "moe_global_full", remat)
        param_ptrs = {p.untyped_storage().data_ptr()
                      for p in tree_leaves(state.student)}
        seen, total = set(), {"in": 0, "out": 0}
        cached.clear()

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in seen and ptr not in param_ptrs:
                seen.add(ptr)
                total["in" if inside[0] else "out"] += t.untyped_storage().nbytes()
            return t

        loss_fn = qad.make_loss_fn(model, cfg, qc, qad.QADConfig(loss="kl"))
        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        state.student)
        param_ptrs |= {p.untyped_storage().data_ptr() for p in tree_leaves(live)}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(live, state.teacher, batch)
        loss.backward()
        saved[remat] = dict(total, cached=sum(n for _, n in cached),
                            ops={f for f, _ in cached})
    assert saved["none"]["in"] > 0 and saved["none"]["cached"] == 0
    assert saved["full"]["in"] == saved["dots"]["in"] == 0
    assert saved["full"]["cached"] == 0
    assert saved["dots"]["cached"] > 0
    assert saved["dots"]["ops"] == {torch.ops.aten.mm.default}
    tot = {r: s["in"] + s["out"] + s["cached"] for r, s in saved.items()}
    assert tot["none"] > tot["dots"] > tot["full"], saved


def test_no_remat_without_grad(monkeypatch):
    """The teacher's forward (no grad) runs no checkpoint: the same logits
    as without remat, and ``torch.utils.checkpoint`` is never called."""
    cfg = _cfg(DENSE, remat="full")
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu")
    batch = {"tokens": torch.from_numpy(_batch_np(cfg.vocab_size)[0]).long()}
    calls = []
    real = common.checkpoint
    monkeypatch.setattr(common, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    qc = specs.recipe_qconfig(cfg)
    with torch.no_grad():
        got = decoder.apply(cfg, params, batch, qc)
    assert not calls
    want = decoder.apply(dataclasses.replace(cfg, remat="none"), params,
                         batch, qc)
    assert torch.equal(got, want)
    with torch.enable_grad():
        decoder.apply(cfg, params, batch, qc)
    assert len(calls) == cfg.n_layers


def test_adamw_apply_is_update_then_add(monkeypatch):
    """Bitwise: ``AdamW.apply`` (the train step's update, leaf by leaf and
    slice by slice) gives the parameters and moments of ``update`` and the
    add, with clipping, weight decay and bf16 parameters, for leaves of
    one slice and of several (``_SLICE`` shrunk); the updates' norm
    within rtol 1e-6 of ``global_norm`` (its sums run slice by slice); it
    consumes the gradient tree and leaves the old state as it was."""
    monkeypatch.setattr(adamw, "_SLICE", 20)
    gen = torch.Generator().manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    params = {"b": {"d": rnd(2, 4).to(torch.bfloat16), "c": rnd(3)},
              "a": rnd(5, 7).to(torch.bfloat16), "e": rnd(3, 9, 4)}
    grads = tree_map(lambda p: 3 * rnd(*p.shape).to(p.dtype), params)
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10), clip_norm=1.0,
                weight_decay=0.1)
    state = type(opt.init(params))(
        m=tree_map(lambda p: rnd(*p.shape), params),
        v=tree_map(lambda p: rnd(*p.shape).abs(), params))
    old_m = tree_map(torch.clone, state.m)
    step = torch.tensor(3, dtype=torch.int32)
    updates, want = opt.update(grads, state, params, step)
    want_p = tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                      params, updates)
    consumed = tree_map(torch.clone, grads)
    got_p, got, norm = opt.apply(consumed, state, params, step)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(getattr(got, part)),
                        tree_leaves(getattr(want, part))):
            assert torch.equal(a, b), part
    # each leaf's squares summed slice by slice: the last bits may differ
    torch.testing.assert_close(norm, global_norm(updates), rtol=1e-6, atol=0)
    assert tree_leaves(consumed) == []
    for a, b in zip(tree_leaves(state.m), tree_leaves(old_m)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MoE QAD: moe_ffn's backward through capacity dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["moe_global_full", "moe_local"])
def test_moe_ffn_grads_match_reference(ref, case):
    """Tolerance: ``moe_ffn``'s gradients under ``BF16`` in x, the router
    and the three expert stacks (against a seeded cotangent) within 2e-2
    relative L2; the dropped fraction equal.

    The backward through the capacity dispatch, the renormalised top-k
    gates and the combine, without quantization: the router's and the
    expert GEMMs' bf16 sums run in other orders than XLA's, so the output
    differs by one bf16 ulp here and there (0.5% relative L2 measured) and
    the gradients by 0.5-0.9%.  Under NVFP4 those one-ulp differences
    cross E2M1 rounding boundaries in the expert activations and move the
    output by about 3% (measured), the level ``test_torch_moe.py`` holds the
    forward to; the NVFP4 gradients are held in the whole QAD step above.
    """
    cfg, _, _, _, state, _ = _setup(ref, case)
    p0 = common.layer_slice(state.student["layers"], 0)
    x = torch.from_numpy(_moe_x(cfg.d_model)).to(torch.bfloat16)
    ins = [t.detach().clone().requires_grad_(True)
           for t in (x, p0["router"], p0["moe_wg"], p0["moe_wu"], p0["moe_wd"])]
    out, aux = layers.moe_ffn(BF16, cfg, *ins)
    torch.sum(out.float() * torch.from_numpy(_moe_g(cfg.d_model))).backward()
    for name, t in zip(("x", "router", "wg", "wu", "wd"), ins):
        want = ref[f"{case}/moe_ffn/grad/{name}"]
        assert _rel_l2(t.grad.float().numpy(), want) < 2e-2, name
    assert float(aux["moe_dropped_frac"]) == float(
        ref[f"{case}/moe_ffn/aux/moe_dropped_frac"])
    assert float(aux["moe_dropped_frac"]) > 0        # capacity drops tokens


# ---------------------------------------------------------------------------
# teacher-generated data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["bos", "prompts"])
def test_generate_greedy_matches_reference(ref, source):
    """Greedy tokens: at temperature 1e-6 the port's tokens equal the
    reference's, from BOS and from seeded prompts."""
    cfg, model, _, _, state, _ = _setup(ref, "dense_full")
    prompts = (generated.bos_prompts(2) if source == "bos"
               else torch.from_numpy(_prompts(cfg.vocab_size)))
    ops.reset_launches()
    toks = generated.generate_tokens(model, cfg, state.teacher, prompts,
                                     GEN_NEW, seed=1, temperature=1e-6)
    assert toks.shape == (2, prompts.shape[1] + GEN_NEW)
    assert toks.dtype == torch.long
    np.testing.assert_array_equal(toks.numpy(), ref[f"gen/{source}"])


@pytest.mark.parametrize("top_p", TOP_P)
def test_top_p_mask_bitwise(ref, top_p):
    """Bitwise: the logits the draw takes (temperature, then the nucleus
    cutoff, ties included) equal the reference's.  (A top_p within f32
    rounding of a row's total mass, 0.9999999, is not held: there the
    cutoff index follows the last bits of the softmax and cumulative sums,
    which XLA forms in another order, an associative scan for the cumsum;
    it moves the cutoff by a few of the row's least likely tokens.)"""
    got = generated.top_p_logits(torch.from_numpy(_top_p_logits()), 0.7, top_p)
    want = ref[f"top_p/{top_p}"]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert (want == -1e30).any() and not (want == -1e30).all()


def test_bos_prompts_and_batch_bitwise(ref):
    """Bitwise: ``bos_prompts`` and ``batch_from_generated``."""
    assert torch.equal(generated.bos_prompts(3), torch.ones(3, 1,
                                                            dtype=torch.long))
    assert torch.equal(generated.bos_prompts(2, bos_id=7), torch.full(
        (2, 1), 7, dtype=torch.long))
    toks = torch.from_numpy(ref["gen/prompts"]).long()
    b = generated.batch_from_generated(toks, 8)
    np.testing.assert_array_equal(b["tokens"].numpy(), ref["gen/batch/tokens"])
    assert torch.equal(b["labels"], toks[:, 1:9])
    assert torch.equal(b["mask"], torch.ones(2, 8))
    assert torch.equal(b["domain_id"], torch.zeros(2, dtype=torch.long))


def test_seeded_draw_reproducible():
    """The same seed draws the same tokens; another seed others."""
    cfg = configs.get_smoke(DENSE)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    draw = lambda seed: generated.generate_tokens(
        model, cfg, params, generated.bos_prompts(4), 8, seed=seed,
        temperature=1.0, top_p=0.9)
    a = draw(3)
    assert torch.equal(a, draw(3))
    assert not torch.equal(a, draw(4))
    assert ((a >= 0) & (a < cfg.vocab_size)).all() and (a[:, 0] == 1).all()


def test_data_free_qad_lowers_kl():
    """Data-free QAD end to end: ``olmo-1b-smoke`` generates from BOS, and
    QAD on the generated batches (a fresh one each step) lowers the eval
    KL on held-out generated sequences and on the synthetic corpus, as
    ``test_torch_train.py``'s trainer test does on the corpus.  The smoke
    student starts within KL 0.002 of its teacher; at lr 1e-3 the
    updates overshoot it and the held-out KL rises, so this runs at 1e-4."""
    cfg = configs.get_smoke(DENSE)
    model = get_model(cfg)
    qc = specs.recipe_qconfig(cfg)
    steps, bs, seq = 40, 8, 32
    opt = AdamW(lr=warmup_cosine(1e-4, steps // 10, steps), clip_norm=1.0)
    with torch.no_grad():
        state = qad.init_state(model, cfg, torch.Generator().manual_seed(0),
                               opt, device="cpu")
    toks = generated.generate_tokens(model, cfg, state.teacher,
                                     generated.bos_prompts(steps * bs + 8),
                                     seq, seed=0)
    assert toks.shape == (steps * bs + 8, seq + 1) and (toks[:, 0] == 1).all()
    held = generated.batch_from_generated(toks[-8:], seq)
    corpus = eval_batches(DataConfig(cfg.vocab_size, seq, 4, seed=0), 2)
    step = qad.make_train_step(model, cfg, qc, opt)
    evaluate = qad.make_eval_step(model, cfg, qc)

    def kls(st):
        return (float(evaluate(st, held)["kl"]),
                float(np.mean([float(evaluate(st, b)["kl"]) for b in corpus])))

    before = kls(state)
    for i in range(steps):
        state, m = step(state, generated.batch_from_generated(
            toks[i * bs:(i + 1) * bs], seq))
    after = kls(state)
    assert np.isfinite(float(m["loss"]))
    assert after[0] < before[0] and after[1] < before[1], (before, after)


# ---------------------------------------------------------------------------
# activation calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["max", "percentile", "mse"])
def test_calibration_bitwise(ref, method):
    """Bitwise: an ``AmaxObserver`` over two batches of one site (37
    values a row: not a block multiple), and ``calibrate_activations`` over
    two sites, equal the reference's amaxes."""
    obs = ptq.AmaxObserver(method=method)
    for i in range(2):
        obs.observe(torch.from_numpy(_calib_acts(i)["b"]).to(torch.bfloat16))
    assert obs.amax() == float(ref[f"calib/observer/{method}"])
    got = ptq.calibrate_activations(
        lambda i: {k: torch.from_numpy(v).to(torch.bfloat16)
                   for k, v in _calib_acts(i).items()},
        range(2), [n for n, _ in CALIB], method)
    assert set(got) == {"a", "b"}
    for site, amax in got.items():
        assert amax == float(ref[f"calib/{method}/{site}"]), site
    if method == "max":
        assert got["b"] == float(np.abs(np.concatenate(
            [_calib_acts(i)["b"].ravel() for i in range(2)])).max())
