"""Training slice of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs and bridged parameters go through both packages.
The reference's training and eval steps run jitted in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, as in
``test_torch_serve.py``: XLA then rounds every bf16 operation as the
program is written, so the two NVFP4 student forwards agree bitwise.

Parity levels, named in each test:
  * **tolerance**, KL kernels' plain versions: per-token KL, logsumexps
    and the masked mean against the Pallas kernel in interpret mode, and
    the gradient against ``jax.grad`` of it, rtol 1e-4 / atol 1e-7 (the
    reference's own kernel tolerance);
  * **bitwise**, the straight-through QDQ gradient (the identity);
  * **tolerance**, one QAD step: loss and KL rtol 1e-5 (f32 softmax
    reductions in another order); each gradient leaf and the AdamW
    moments (``m``, and ``sqrt(v)``: ``v`` is quadratic in the gradient)
    within 1e-2 relative L2 (bf16 rounding in the backward falls at other
    places); each updated parameter within one bf16 ulp (of the larger of
    the two) plus 2 lr (on step 1 Adam's update is lr g / (|g| + eps), so
    a tiny gradient may flip its sign);
  * **structure**, the data pipeline (``jax.random`` streams cannot be
    reproduced);
  * **bitwise**, checkpoints written by one package and restored by the
    other.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import nvfp4 as jnvfp4
from repro.core import qad as jqad
from repro.data import pipeline as jpipeline
from repro.kernels import kl_loss as jkl
from repro.kernels import ops as jops
from repro.models import get_model as jget_model
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import configs
from repro_torch.bridge import params_from_numpy, state_from_numpy, to_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import losses, qad, qconfig
from repro_torch.data import DataConfig, make_batch
from repro_torch.data import pipeline
from repro_torch.kernels import kl_loss as kkl
from repro_torch.kernels import ops, ref
from repro_torch.launch import specs, train
from repro_torch.models import get_model
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, warmup_cosine

ARCHS = ["qwen1.5-0.5b", "olmo-1b"]
METHODS = ["ce", "mse", "kl+ce"]        # besides "kl", on qwen1.5-0.5b
LR, WARMUP, TOTAL = 1e-3, 0, 10
B, S = 2, 16


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
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _batch_np(vocab):
    rng = np.random.default_rng(3)
    toks = rng.integers(4, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0                       # a few masked-out tokens
    return toks[:, :-1], toks[:, 1:], mask


def _reference(out_path: str) -> None:
    """Every reference output of a training step (runs in the subprocess)."""
    from repro import configs as jconfigs
    from repro.launch import specs as jspecs

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    res = {}
    for arch in ARCHS:
        cfg = jconfigs.get_smoke(arch)
        model = jget_model(cfg)
        qc = jspecs.recipe_qconfig(cfg)
        params = model.init_params(cfg, jax.random.PRNGKey(0))
        for k, v in _flat(params).items():
            res[f"{arch}/params/{k}"] = f32(v)
        toks, labels, mask = _batch_np(cfg.vocab_size)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                 "mask": jnp.asarray(mask)}
        opt = JAdamW(lr=jwarmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
        state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=params,
                                teacher=jax.tree.map(jnp.copy, params),
                                opt_state=opt.init(params))
        methods = ["kl"] + (METHODS if arch == ARCHS[0] else [])
        step = jqad.make_train_step(model, cfg, qc, opt)
        evaluate = jqad.make_eval_step(model, cfg, qc)

        def everything(state, batch):
            # one jit for the arch: one compile instead of one per function
            vg = {m: jax.value_and_grad(
                      jqad.make_loss_fn(model, cfg, qc, jqad.QADConfig(loss=m)),
                      has_aux=True)(state.student, state.teacher, batch)
                  for m in methods}
            return vg, step(state, batch), evaluate(state, batch)

        vg, (new, m), ev = jax.jit(everything)(state, batch)
        for method, ((loss, aux), grads) in vg.items():
            res[f"{arch}/{method}/loss"] = f32(loss)
            for k, v in aux.items():
                res[f"{arch}/{method}/metrics/{k}"] = f32(v)
            for k, v in _flat(grads).items():
                res[f"{arch}/{method}/grads/{k}"] = f32(v)
        for k, v in m.items():
            res[f"{arch}/step/metrics/{k}"] = f32(v)
        for name, tree in (("student", new.student), ("m", new.opt_state.m),
                           ("v", new.opt_state.v)):
            for k, v in _flat(tree).items():
                res[f"{arch}/step/{name}/{k}"] = f32(v)
        for k, v in ev.items():
            res[f"{arch}/eval/{k}"] = f32(v)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_train_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(here, "..", "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_train as t; t._reference({out!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _port_params(jref, arch, cfg):
    """The reference's parameters in the port's tree (the spec tree keeps
    the empty dicts of a non-parametric norm, which flattening drops)."""
    def fill(spec, path):
        if isinstance(spec, dict):
            return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
        return jref[f"{arch}/params/{path[:-1]}"]
    return params_from_numpy(fill(get_model(cfg).param_specs(cfg), ""), "cpu")


def _port_setup(jref, arch):
    cfg = configs.get_smoke(arch)
    params = _port_params(jref, arch, cfg)
    toks, labels, mask = _batch_np(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=params, teacher=tree_map(torch.clone, params),
                           opt_state=opt.init(params))
    return cfg, get_model(cfg), specs.recipe_qconfig(cfg), opt, state, batch


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _assert_tree_rel_l2(got: dict, jref, prefix: str, tol: float):
    want = _unflat(jref, prefix)
    gflat, wflat = _flat(got), _flat(want)
    assert sorted(gflat) == sorted(wflat)
    bad = {k: _rel_l2(gflat[k], wflat[k]) for k in wflat
           if _rel_l2(gflat[k], wflat[k]) > tol}
    assert not bad, bad


# ---------------------------------------------------------------------------
# K5 and K6: the plain versions against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _logits(t, v, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tl = (rng.standard_normal((t, v)) * 2).astype(np.float32)
    sl = (tl + 0.2 * rng.standard_normal((t, v))).astype(np.float32)
    mask = (rng.uniform(size=t) > 0.3).astype(np.float32)
    mask[0] = 0.0                                 # a masked-out row
    return tl, sl, mask


@pytest.mark.parametrize("t,v,tt,tv", [(33, 257, 8, 64), (100, 3000, 32, 512),
                                       (17, 130, 16, 128)])
def test_kl_fwd_plain_matches_pallas_kernel(t, v, tt, tv):
    """Tolerance (rtol 1e-4, atol 1e-7): per-token KL, z_t, z_s and the
    masked mean, at ragged T and V with tiles smaller than the shape."""
    tl, sl, mask = _logits(t, v, t + v)
    kl_j, zt_j, zs_j = jkl._kl_fwd(jnp.asarray(tl), jnp.asarray(sl), tt, tv, True)
    kl, zt, zs = kkl.plain_fwd(torch.from_numpy(tl), torch.from_numpy(sl))
    for got, want in ((kl, kl_j), (zt, zt_j), (zs, zs_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-7)
    loss_j = jops.kl_loss(jnp.asarray(tl), jnp.asarray(sl), jnp.asarray(mask),
                          tile_t=tt, tile_v=tv)
    loss = ops.kl_loss(torch.from_numpy(tl), torch.from_numpy(sl),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(ref.kl_loss_ref(
        torch.from_numpy(tl), torch.from_numpy(sl), torch.from_numpy(mask))),
        float(loss_j), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("t,v,tt,tv", [(33, 257, 8, 64), (48, 640, 16, 128)])
def test_kl_bwd_plain_matches_jax_grad(t, v, tt, tv):
    """Tolerance (rtol 1e-4, atol 1e-7): the op's gradient (K6's plain
    version) against ``jax.grad`` of the Pallas kernel and against
    ``kl_grad_ref``; masked rows get exactly zero."""
    tl, sl, mask = _logits(t, v, 7 + t)
    want = jax.grad(lambda s: jops.kl_loss(jnp.asarray(tl), s, jnp.asarray(mask),
                                           tt, tv))(jnp.asarray(sl))
    s = torch.from_numpy(sl).requires_grad_()
    ops.kl_loss(torch.from_numpy(tl), s, torch.from_numpy(mask)).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(
        s.grad.numpy(), ref.kl_grad_ref(torch.from_numpy(tl), torch.from_numpy(sl),
                                        torch.from_numpy(mask)).numpy(),
        rtol=1e-4, atol=1e-7)
    assert not s.grad[mask == 0].any()


def test_kl_bf16_logits_and_identical_inputs():
    """bf16 logits: the gradient in bf16 within one bf16 ulp of the f32
    gradient of the same values; identical t and s give KL 0 exactly."""
    tl, sl, mask = _logits(24, 200, 5)
    tb = torch.from_numpy(tl).to(torch.bfloat16)
    sb = torch.from_numpy(sl).to(torch.bfloat16).requires_grad_()
    ops.kl_loss(tb, sb, torch.from_numpy(mask)).backward()
    assert sb.grad.dtype == torch.bfloat16
    want = ref.kl_grad_ref(tb, sb.detach(), torch.from_numpy(mask)).numpy()
    err = np.abs(sb.grad.float().numpy() - want)
    assert (err <= _bf16_ulp(want) + 1e-12).all()
    assert float(ops.kl_loss(tb, tb, torch.from_numpy(mask))) == 0.0
    kl, zt, zs = kkl.plain_fwd(tb, tb)
    assert torch.equal(zt, zs) and not kl.any()


# ---------------------------------------------------------------------------
# K1's straight-through backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scope", ["tensor", "row", "token"])
def test_qdq_straight_through_gradient(scope):
    """Bitwise: d q_act(x) / dx is the identity, as ``jax.grad`` of the
    reference's ``fake_quant`` is; the amax carries no gradient."""
    rng = np.random.default_rng(11)
    x_np = (rng.standard_normal((3, 4, 48)) * 3).astype(np.float32)
    g_np = rng.standard_normal((3, 4, 48)).astype(np.float32)
    qc = qconfig.QuantConfig(act_scope=scope)
    x = torch.from_numpy(x_np).requires_grad_()
    y = qc.q_act(x, "mlp")
    y.backward(torch.from_numpy(g_np))
    want = jax.grad(lambda a: jnp.sum(jnvfp4.fake_quant(a) * g_np))(
        jnp.asarray(x_np))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), g_np)
    amax = torch.tensor([4.0], requires_grad=True)
    x.grad = None
    ops.nvfp4_qdq(x, amax).sum().backward()
    assert amax.grad is None
    np.testing.assert_array_equal(x.grad.numpy(), np.ones_like(x_np))


# ---------------------------------------------------------------------------
# one QAD step against the jitted reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_qad_step_matches_reference(jref, arch):
    """Tolerance (see the module docstring): loss, KL, gradients, AdamW
    moments and the updated parameters of one jitted reference step."""
    cfg, model, qc, opt, state, batch = _port_setup(jref, arch)
    loss_fn = qad.make_loss_fn(model, cfg, qc, qad.QADConfig(loss="kl"))
    loss, metrics, grads = qad.value_and_grad(loss_fn, state.student,
                                              state.teacher, batch)
    np.testing.assert_allclose(float(loss), jref[f"{arch}/kl/loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["kl"]),
                               jref[f"{arch}/kl/metrics/kl"], rtol=1e-5)
    _assert_tree_rel_l2(to_numpy(grads), jref, f"{arch}/kl/grads/", 1e-2)

    new, m = qad.make_train_step(model, cfg, qc, opt)(state, batch)
    assert int(new.step) == 1
    for k in ("loss", "kl", "ce"):
        np.testing.assert_allclose(float(m[k]), jref[f"{arch}/step/metrics/{k}"],
                                   rtol=1e-5)
    for k in ("grad_norm", "update_norm"):
        np.testing.assert_allclose(float(m[k]), jref[f"{arch}/step/metrics/{k}"],
                                   rtol=1e-2)
    _assert_tree_rel_l2(to_numpy(new.opt_state.m), jref, f"{arch}/step/m/", 1e-2)
    # v is quadratic in g, so its relative error is twice the gradient's:
    # held as sqrt(v), the quantity the update divides by, to the
    # gradient's 1e-2
    sqrt_v = {k: np.sqrt(v) for k, v in jref.items()
              if k.startswith(f"{arch}/step/v/")}
    _assert_tree_rel_l2(tree_map(np.sqrt, to_numpy(new.opt_state.v)),
                        sqrt_v, f"{arch}/step/v/", 1e-2)
    got = _flat(to_numpy(new.student))
    want = _flat(_unflat(jref, f"{arch}/step/student/"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        lim = _bf16_ulp(np.maximum(np.abs(got[k]), np.abs(w))) + 2 * LR
        assert (np.abs(got[k] - w) <= lim).all(), k
    changed = sum(int((got[k] != jref[f"{arch}/params/{k}"]).sum()) for k in got)
    assert changed > 0


@pytest.mark.parametrize("method", METHODS)
def test_other_methods_match_reference(jref, method):
    """Tolerance: loss and metrics rtol 1e-5, gradients 1e-2 relative L2,
    for QAT (ce), the MSE ablation and kl+ce, on qwen1.5-0.5b."""
    arch = ARCHS[0]
    cfg, model, qc, _, state, batch = _port_setup(jref, arch)
    loss_fn = qad.make_loss_fn(model, cfg, qc, qad.QADConfig(loss=method))
    loss, metrics, grads = qad.value_and_grad(loss_fn, state.student,
                                              state.teacher, batch)
    np.testing.assert_allclose(float(loss), jref[f"{arch}/{method}/loss"],
                               rtol=1e-5)
    names = {k.rsplit("/", 1)[1] for k in jref
             if k.startswith(f"{arch}/{method}/metrics/")}
    assert names == set(metrics)
    for k in names:
        np.testing.assert_allclose(float(metrics[k]),
                                   jref[f"{arch}/{method}/metrics/{k}"],
                                   rtol=1e-5)
    _assert_tree_rel_l2(to_numpy(grads), jref, f"{arch}/{method}/grads/", 1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference(jref, arch):
    """Tolerance: CE and KL rtol 1e-5; top-1 agreement equal."""
    cfg, model, qc, _, state, batch = _port_setup(jref, arch)
    ev = qad.make_eval_step(model, cfg, qc)(state, batch)
    for k in ("ce", "kl"):
        np.testing.assert_allclose(float(ev[k]), jref[f"{arch}/eval/{k}"],
                                   rtol=1e-5)
    assert float(ev["top1_agree"]) == float(jref[f"{arch}/eval/top1_agree"])


# ---------------------------------------------------------------------------
# chunked losses, schedule, data, trainer, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_chunked_kl_matches_plain(n_chunks):
    """Tolerance: loss rtol 1e-5, gradients rtol 1e-4 (f32 inputs), the
    chunked fused loss against ``kl_from_logits`` on materialized logits."""
    rng = np.random.default_rng(n_chunks)
    d, v = 32, 96
    ht, hs = (torch.from_numpy(rng.standard_normal((2, 5, d)).astype(np.float32))
              for _ in range(2))
    wt = torch.from_numpy(rng.standard_normal((d, v)).astype(np.float32) / 4)
    ws = (wt + 0.05 * torch.from_numpy(rng.standard_normal((d, v)).astype(
        np.float32))).requires_grad_()
    hs.requires_grad_()
    mask = torch.from_numpy((rng.uniform(size=(2, 5)) > 0.2).astype(np.float32))
    got = losses.chunked_kl_loss(ht, wt, hs, ws, mask, n_chunks)
    g_hs, g_ws = torch.autograd.grad(got, (hs, ws))
    want = losses.kl_from_logits(ht @ wt, hs @ ws, mask)
    w_hs, w_ws = torch.autograd.grad(want, (hs, ws))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    np.testing.assert_allclose(g_hs.numpy(), w_hs.numpy(), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(g_ws.numpy(), w_ws.numpy(), rtol=1e-4, atol=1e-7)

    labels = torch.from_numpy(rng.integers(0, v, (2, 5)))
    got = losses.chunked_ce_loss(hs, ws, labels, mask, n_chunks)
    g = torch.autograd.grad(got, (hs, ws))
    want = losses.ce_from_logits(hs @ ws, labels, mask)
    w = torch.autograd.grad(want, (hs, ws))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7)


def test_schedule_matches_reference():
    """Tolerance rtol 1e-6: warmup and cosine, both in f32."""
    for warm, total in ((3, 20), (0, 10)):
        lr, jlr = warmup_cosine(1e-3, warm, total), jwarmup_cosine(1e-3, warm, total)
        for s in (0, 1, 3, 7, 19, 25):
            np.testing.assert_allclose(
                float(lr(torch.tensor(s, dtype=torch.int32))),
                float(jlr(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_make_batch_structure():
    """Structure: the reference's domain spans, BOS, labels shifted by one,
    tokens within each row's domain, and the same batch for the same
    (seed, step)."""
    vocab = 512
    cfg = DataConfig(vocab_size=vocab, seq_len=24, global_batch=12, seed=5,
                     domains=("math", "code", "prose", "random"))
    assert pipeline._domain_spans(vocab) == jpipeline._domain_spans(vocab)
    b = make_batch(cfg, 7)
    assert b["tokens"].shape == b["labels"].shape == (12, 24)
    assert (b["tokens"][:, 0] == 1).all()
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert torch.equal(b["mask"], torch.ones(12, 24))
    spans = pipeline._domain_spans(vocab)
    for row, dom in zip(b["labels"], b["domain_id"].tolist()):
        name = cfg.domains[dom]
        lo, hi = spans[name] if name != "random" else (4, vocab)
        assert ((row >= lo) & (row < hi)).all(), name
    again = make_batch(cfg, 7)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["tokens"], make_batch(cfg, 8)["tokens"])
    math_rows = b["labels"][b["domain_id"] == 0]
    if len(math_rows):           # the progression law holds on most steps
        lo, hi = spans["math"]
        d = (math_rows[:, 1:] - math_rows[:, :-1]) % (hi - lo)
        assert float((d == d.mode(1).values[:, None]).float().mean()) > 0.4


def test_port_trainer_lowers_kl():
    """As ``tests/test_system.py`` asserts for the reference's trainer."""
    ops.reset_launches()
    _, hist = train.train("qwen1.5-0.5b", smoke=True, steps=60, lr=1e-3,
                          method="qad", batch=4, seq=32, eval_every=30,
                          device="cpu", log=lambda *a: None)
    assert hist[-1]["kl"] < hist[0]["kl"]
    assert np.isfinite(hist[-1]["ce"])
    assert all(v == 0 for v in ops.launches.values())   # plain versions only


def _ref_state(arch):
    cfg = configs.get_smoke(arch)
    from repro import configs as jconfigs
    jcfg = jconfigs.get_smoke(arch)
    opt = JAdamW(lr=1e-3)
    st = jqad.init_state(jget_model(jcfg), jcfg, jax.random.PRNGKey(1), opt)
    rng = np.random.default_rng(0)
    m = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                           jnp.float32), st.opt_state.m)
    v = jax.tree.map(lambda a: jnp.asarray(rng.uniform(size=a.shape),
                                           jnp.float32), st.opt_state.v)
    st = st._replace(step=jnp.asarray(17, jnp.int32),
                     opt_state=st.opt_state._replace(m=m, v=v))
    return cfg, st


def _jax_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else np.asarray(a), tree)


def _state_dict(st):
    return {"step": np.asarray(st.step), "student": st.student,
            "teacher": st.teacher,
            "opt_state": {"m": st.opt_state.m, "v": st.opt_state.v}}


def _assert_state_equal(port_state, jstate):
    got = to_numpy(port_state)
    want = _jax_numpy(_state_dict(jstate))
    assert int(got["step"]) == int(want["step"])
    for part in ("student", "teacher"):
        gf, wf = _flat(got[part]), _flat(want[part])
        assert sorted(gf) == sorted(wf)
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k])
    for mv in ("m", "v"):
        gf, wf = _flat(got["opt_state"][mv]), _flat(want["opt_state"][mv])
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k])


def test_checkpoint_reference_to_port(tmp_path):
    """Bitwise: a TrainState written by the reference's CheckpointManager
    restores in the port (verified digest, the same keys)."""
    _, jst = _ref_state("olmo-1b")
    mgr = JCheckpointManager(str(tmp_path), async_save=False)
    mgr.save(17, jst, metrics={"kl": 0.5})
    like = state_from_numpy(_jax_numpy(_state_dict(jst)), "cpu")
    like = like._replace(student=tree_map(torch.zeros_like, like.student))
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 17
    assert restored.student["embed"].dtype == torch.bfloat16
    _assert_state_equal(restored, jst)


def test_checkpoint_port_to_reference(tmp_path):
    """Bitwise: a port TrainState saved by the port's manager restores in
    the reference's (its digest check included), with async save, keep-k
    and a torn newest checkpoint skipped."""
    _, jst = _ref_state("qwen1.5-0.5b")
    port = state_from_numpy(_jax_numpy(_state_dict(jst)), "cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (5, 9, 17):
        mgr.save(s, port, metrics={"step": s})
    mgr.wait()
    assert mgr.all_steps() == [9, 17]
    step, restored = JCheckpointManager(str(tmp_path)).restore_latest(jst)
    assert step == 17
    assert restored.student["embed"].dtype == jnp.bfloat16
    _assert_state_equal(port, restored)
    # tear the newest: both managers fall back to step 9
    with open(tmp_path / "step_0000000017" / "arrays.npz", "r+b") as f:
        f.seek(200)
        f.write(b"\xff" * 64)
    assert CheckpointManager(str(tmp_path)).latest_step() == 9
    assert JCheckpointManager(str(tmp_path)).latest_step() == 9


def test_train_cli_cpu_resumes_from_checkpoint(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: the chunked QAD
    method trains, saves, and a longer run resumes from the checkpoint."""
    args = ["--device", "cpu", "--arch", "olmo-1b", "--batch", "2", "--seq",
            "8", "--method", "qad_chunked", "--ckpt-dir", str(tmp_path / "ck")]
    hist = train.main(args + ["--steps", "2", "--out", str(tmp_path / "h.json")])
    assert [h["step"] for h in hist] == [2] and np.isfinite(hist[0]["kl"])
    assert (tmp_path / "h.json").exists()
    hist = train.main(args + ["--steps", "3"])
    assert [h["step"] for h in hist] == [3]
    assert "resumed from step 2" in capsys.readouterr().out
