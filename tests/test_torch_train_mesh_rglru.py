"""QAD on a data x model mesh for the RG-LRU hybrids, the port against the
reference's own mesh step, on the CPU; and the BF16 attention of the
``moe_hybrid`` and ``hybrid`` recipes against the jitted reference, op by
op (ROADMAP C.11).

As ``test_torch_train_mesh_moe.py`` does: the reference runs once per
module in a subprocess (``Popen``, while the port's ranks run) on four
emulated host devices with excess precision off, its jitted
``make_train_step`` on a (2, 2) mesh made by ``repro.launch.mesh.
_make_mesh`` under ``fsdp_tp`` (one compile a model: its one-device step
is left out, the port's one-device step being held to it by
``test_torch_rglru.py`` and ``test_torch_train.py``); the port's four
ranks are gloo processes on the CPU, one intra-op thread each, every case
in one spawn.  Two smoke configs, a batch of 8 x 32, the port's seed-0
draw given to both packages (so the two run at once):

  * ``nemotron-nano-9b-sim`` smoke: two super-blocks of two RG-LRU layers
    and a windowless attention layer (GQA, 2 of 4 KV heads a rank);
  * ``recurrentgemma-2b`` smoke: two super-blocks and two trailing
    RG-LRU layers, attention over a 16-token window with one MQA KV head,
    which every model rank holds whole in its fused QKV tile.

Both run the ``hybrid`` recipe: the RG-LRU GEMMs NVFP4, attention BF16.
On the mesh an RG-LRU layer's ``w_a`` and ``w_i`` split on their input
dim, as the reference's rules place them; the local ``z`` multiplies
them and the partial pre-activations are reduce-scattered
(``ctx.scatter_from_model``).  Parity levels, as each test names them:

  * **tolerance**, each rule's step: ``fsdp_tp`` and ``tp_only`` against
    the reference's mesh step, ``fsdp_only`` and ``dp_only`` against the
    port's one-device step: loss, KL, CE and top-1, the gathered first
    moment and each leaf's update (new - initial) relative L2, within
    limits read on this CPU and printed by each test; a planted fault,
    the gates' reduce-scatter forward-only (no gradient back through it),
    parts beyond them on the update and the moment, not on the loss;
  * **gradient**, one RG-LRU layer on a (1, 2) mesh against one device,
    leaf by leaf, and the planted fault beyond the limit;
  * **bitwise**, a (1, 1) mesh against the port's one-device step; every
    rank's metrics equal; each leaf a group replicates equal on its
    ranks, recurrentgemma's KV rows of the fused QKV tile on every model
    rank among them; each rank's shards of the seed's draw its slices of
    the one-device draw; the stored bytes the partition factors' share;
  * **bitwise**, checkpoint resume through ``train_on_mesh`` on
    recurrentgemma (nested stacks, the MQA tile): a run resumed after
    step 1 equals the uninterrupted one on every rank; its checkpoint
    restored by the one-device ``train()`` equals the gathered state, and
    a one-device checkpoint restored on the mesh gives each rank its
    slices;
  * C.11, **bitwise and tolerance** on ``arctic-480b`` smoke (its
    ``moe_hybrid`` recipe's BF16 attention, the same switch as
    ``hybrid``'s): the first layer's QKV product, RoPE, blockwise
    attention (scores, softmax, PV) and ``wo``, and their gradients, on
    the reference's own inputs; the norms part only at bf16 rounding ties
    of the program as written, where XLA's f32 mean and its rsqrt (not
    correctly rounded) land on the other side; composed from the
    reference's norms the layer's output is the reference's, and from the
    port's its MoE routing carries the tie far.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import qad
from repro_torch.core.qconfig import BF16
from repro_torch.distributed import ctx, sharding
from repro_torch.distributed.ctx import TP
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import specs, train
from repro_torch.models import common, get_model, rwkv6
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_train_mesh import LR, METRICS, SHAPE, TOTAL, WARMUP, _flat, _rel_l2

B, S = 8, 32
RULES = sharding.RULE_MODES
# the oracle of each rule: the reference's fsdp_tp step for the rules that
# split the model axis (the reference's students are equal between
# fsdp_tp and tp_only), the port's one-device step for those that do not
ORACLE = {"fsdp_tp": "ref", "tp_only": "ref", "fsdp_only": "one",
          "dp_only": "one"}
# model -> (arch, config overrides, batch kind)
MODELS = {"nemotron": ("nemotron-nano-9b-sim", {}, "tokens"),
          "rgemma": ("recurrentgemma-2b", {}, "tokens")}
# (model, rules, planted fault, method) of each port case
CASES = {**{f"{m}/{r}": (m, r, None, "qad") for m in MODELS for r in RULES},
         "rgemma/fault": ("rgemma", "fsdp_tp", "gates", "qad")}
# limits read on this CPU (the tests print the readings): the loss, KL and
# CE relative; top-1 absolute (a token is 1/256); the first moment's and
# the update's largest relative L2 over the leaves.  The sound readings
# (fsdp_tp against the reference's mesh step): nemotron 3.8e-4, 1/256,
# 0.058 (lm_head), 0.28 (blocks/attn/wg); recurrentgemma 2.0e-4, 2/256,
# 0.135 (rem/wg), 0.394 (rem/wd), the port's one-device step as far from
# it; the planted gate fault 1.0 on w_a's moment and update
TOL = {"nemotron": {"scalar": 1e-3, "top1": 2 / (B * S), "moment": 0.1,
                    "update": 0.4},
       "rgemma": {"scalar": 1e-3, "top1": 3 / (B * S), "moment": 0.2,
                  "update": 0.5}}
# one RG-LRU layer's gradient on a (1, 2) mesh against one device: each
# leaf's relative L2
GRAD_TOL = 1e-2
# train_on_mesh's runs of the checkpoint test: 2 steps, an eval (and a
# checkpoint) after each
RUN = dict(steps=2, batch=B, seq=S, eval_every=1, lr=LR)
CKPT_ARCH = "recurrentgemma-2b"
# C.11: the arctic smoke layer's ops against the reference's (the largest
# share of elements that may part, each by at most one bf16 ulp)
C11_SHARE = 1e-3


# ---------------------------------------------------------------------------
# batches, the reference, the port's setup (shared with
# test_torch_train_mesh_slab.py)
# ---------------------------------------------------------------------------


def cfg_of(models: dict, name: str, get_smoke):
    arch, over, _ = models[name]
    return dataclasses.replace(get_smoke(arch), **over)


def batch_np(cfg, kind: str) -> dict:
    """The global batch as numpy: tokens, labels, mask and a family's
    extras (an encoder's ``enc_frames``; a VLM's ``pos3``, ``vis_mask``
    and ``vis_embeds``, a 2 x 3 patch grid a sequence at 2 + its row)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(4, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "mask": np.ones((B, S), np.float32)}
    if kind == "enc":
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if kind == "vlm":
        pos3 = np.zeros((B, S, 3), np.int32)
        mask = np.zeros((B, S), bool)
        for i in range(B):
            start = 2 + i
            mask[i, start:start + 6] = True
            g = np.arange(6)
            pos3[i, :start] = np.arange(start)[:, None]
            pos3[i, start:start + 6] = np.stack(
                [np.full(6, start), start + g // 3, start + g % 3], 1)
            pos3[i, start + 6:] = (np.arange(S - start - 6) + start + 3)[:, None]
        out.update(pos3=pos3, vis_mask=mask, vis_embeds=rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
    return out


def qad_config(method: str):
    """The reference's or the port's ``QADConfig`` of a method: "qad", or
    "chunked" (the chunked KL in 15 vocabulary chunks: an odd vocabulary
    of 495 divides into them)."""
    return dict(loss="kl", use_chunked_loss=method == "chunked",
                loss_chunks=15)


def run_reference(out_path: str, params_path: str, models: dict,
                  ref_cases: list, c11: bool = False) -> None:
    """The reference's mesh steps (runs in the JAX subprocess, 4 devices)
    on the port's seed-0 draw (``params_path``): each (model, method) of
    ``ref_cases`` under fsdp_tp; with ``c11`` the arctic layer's ops
    (``_c11_reference``)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core import qad as jqad
    from repro.distributed import ctx as jctx
    from repro.distributed import sharding as jshd
    from repro.launch import specs as jspecs
    from repro.launch.mesh import _make_mesh
    from repro.models import get_model as jget_model
    from repro.optim import AdamW as JAdamW
    from repro.optim import warmup_cosine as jwarmup

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    res = {}
    mesh = _make_mesh(SHAPE, ("data", "model"))
    rules = jshd.make_rules(mesh, "fsdp_tp")
    with np.load(params_path) as z:
        drawn = dict(z)
    for name in models:
        cfg = cfg_of(models, name, jconfigs.get_smoke)
        model = jget_model(cfg)

        def fill(spec, path):
            if isinstance(spec, dict):
                return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
            return jnp.asarray(drawn[f"{name}/params/{path[:-1]}"],
                               dtype=spec.dtype)
        params = fill(model.param_specs(cfg), "")
        opt = JAdamW(lr=jwarmup(LR, WARMUP, TOTAL), clip_norm=1.0)
        state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=params,
                                teacher=jax.tree.map(jnp.copy, params),
                                opt_state=opt.init(params))
        batch = {k: jnp.asarray(v) for k, v in
                 batch_np(cfg, models[name][2]).items()}
        shard_p = jshd.tree_shardings(model.param_specs(cfg), mesh, rules)
        for m, method in ref_cases:
            if m != name:
                continue
            step = jqad.make_train_step(
                model, cfg, jspecs.recipe_qconfig(cfg), opt,
                jqad.QADConfig(**qad_config(method)))
            with jctx.use(mesh, rules):
                st = jqad.TrainState(
                    step=state.step,
                    student=jax.device_put(state.student, shard_p),
                    teacher=jax.device_put(state.teacher, shard_p),
                    opt_state=state.opt_state)
                new, met = jax.jit(step)(st, batch)
            key = f"{name}/{method}"
            for k in METRICS:
                if k in met:            # the chunked KL's are the loss and KL
                    res[f"{key}/{k}"] = f32(met[k])
            for k, v in _flat(new.student).items():
                res[f"{key}/student/{k}"] = f32(v)
            for k, v in _flat(new.opt_state.m).items():
                res[f"{key}/m/{k}"] = f32(v)
    if c11:
        res.update(_c11_reference())
    np.savez(out_path, **res)


def start_reference(module: str, out: str,
                    params_path: str) -> subprocess.Popen:
    """``module``'s ``_reference(out, params_path)`` in a JAX subprocess:
    four host devices, excess precision off."""
    here = os.path.dirname(os.path.abspath(__file__))
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=4"
             " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.path.join(here, "..", "src"))
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import {module} as t; t._reference({out!r}, {params_path!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def draw_params(models: dict) -> dict:
    """The port's seed-0 draw of every model's parameters, f32 numpy
    (bf16 values, exact), keyed "model/params/path": both packages step
    from them."""
    out = {}
    for name in models:
        cfg = cfg_of(models, name, configs.get_smoke)
        params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                            "cpu")
        for k, v in _flat(params).items():
            out[f"{name}/params/{k}"] = v.float().numpy()
    return out


def finish_reference(proc: subprocess.Popen, out: str) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=900)
    except BaseException:
        proc.kill()
        raise
    assert proc.returncode == 0, stderr[-4000:]
    print(stdout)
    with np.load(out) as data:
        return dict(data)


def setup(models: dict, params_np: dict, name: str, method: str = "qad"):
    """(cfg, model, qcfg, opt, whole state, batch, method config) on the
    CPU from the reference's parameters of model ``name``."""
    cfg = cfg_of(models, name, configs.get_smoke)
    model = get_model(cfg)

    def fill(spec, path):
        if isinstance(spec, dict):
            return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
        return params_np[f"{name}/params/{path[:-1]}"]
    params = params_from_numpy(fill(model.param_specs(cfg), ""), "cpu")
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=params,
                           teacher=tree_map(torch.clone, params),
                           opt_state=opt.init(params))
    batch = {}
    for k, v in batch_np(cfg, models[name][2]).items():
        t = torch.from_numpy(v)
        batch[k] = t.long() if v.dtype == np.int32 else t
    return (cfg, model, specs.recipe_qconfig(cfg), opt, state, batch,
            qad.QADConfig(**qad_config(method)))


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------


def _gates_forward_only(x, tp, dim=-1):
    """The RG-LRU gates' reduce-scatter with no backward: the partial
    pre-activations reach the gates, no gradient comes back."""
    return tp.reduce_scatter(x.detach(), dim)


def _receptance_forward_only(r):
    """RWKV6's receptance gather with no backward, as it was before this
    path trained on a mesh."""
    if ctx.tp_size() == 1:
        return r
    return ctx.current().all_gather(r.detach(), -1)


@contextlib.contextmanager
def planted(fault: str | None):
    """A planted fault for the duration: "gates" (``ctx.
    scatter_from_model`` forward-only; only RG-LRU's gates call it) or
    "receptance" (``rwkv6._gather_receptance`` forward-only)."""
    if fault is None:
        yield
        return
    owner, attr, fn = {"gates": (ctx, "scatter_from_model",
                                 _gates_forward_only),
                       "receptance": (rwkv6, "_gather_receptance",
                                      _receptance_forward_only)}[fault]
    keep = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, keep)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def run_cases(mesh, models: dict, cases: dict, params_np: dict) -> dict:
    """Every case on this rank: the metrics, this rank's stored shards and
    moments, the stored bytes and their share and, on rank 0, the whole
    updated student and first moment."""
    out = {}
    for key, (name, rule, fault, method) in cases.items():
        cfg, model, qcfg, opt, whole, batch, qc = setup(models, params_np,
                                                        name, method)
        rules = sharding.make_rules(rule)
        state = qad.shard_state(whole, model, cfg, mesh, rules)
        with planted(fault):
            new, m = qad.make_train_step(model, cfg, qcfg, opt, qc, mesh=mesh,
                                         rules=rules)(state, batch)
        full = qad.gather_params(new.student, model, cfg, mesh, rules)
        full_m = qad.gather_params(new.opt_state.m, model, cfg, mesh, rules)
        sp = model.param_specs(cfg)
        places = sharding.placements(sp, mesh.shape, rules)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        out[key] = {
            "metrics": {k: float(m[k]) for k in METRICS if k in m},
            "shards": {k: v.float().numpy() for k, v in
                       _flat(new.student).items()},
            "moments": {k: v.numpy() for k, v in
                        _flat(new.opt_state.m).items()},
            "bytes": [sharding.stored_share(t, sp, places, heads, mesh.shape)
                      for t in (new.student, new.opt_state.m)],
            "student": ({k: v.float().numpy() for k, v in _flat(full).items()}
                        if mesh.rank == 0 else None),
            "m": ({k: v.numpy() for k, v in _flat(full_m).items()}
                  if mesh.rank == 0 else None)}
    return out


def drawn_equal(mesh, models: dict, params_np: dict) -> dict:
    """Each rank's shards of the seed's draw on the mesh against its
    slices of the one-device draw, by model and rule."""
    out = {}
    for name in models:
        cfg, model, _, opt, *_ = setup(models, params_np, name)
        for rule in RULES:
            rules = sharding.make_rules(rule)
            drawn = qad.init_state_on_mesh(
                model, cfg, torch.Generator().manual_seed(0), opt, mesh,
                rules)
            whole = qad.init_state(model, cfg,
                                   torch.Generator().manual_seed(0), opt,
                                   device="cpu")
            cut = qad.shard_state(whole, model, cfg, mesh, rules)
            out[f"{name}/{rule}"] = all(
                torch.equal(a, b) for tree in ("student", "teacher")
                for a, b in zip(_flat(getattr(drawn, tree)).values(),
                                _flat(getattr(cut, tree)).values()))
    return out


def one_device_steps(models: dict, params_np: dict, methods=("qad",)) -> dict:
    """The port's one-device step of every model (and method): the
    metrics, the updated student and first moment."""
    out = {}
    for name in models:
        for method in methods:
            cfg, model, qcfg, opt, state, batch, qc = setup(models, params_np,
                                                            name, method)
            new, m = qad.make_train_step(model, cfg, qcfg, opt, qc)(state,
                                                                     batch)
            out[f"{name}/{method}"] = {
                "metrics": {k: float(m[k]) for k in METRICS if k in m},
                "student": {k: v.float().numpy()
                            for k, v in _flat(new.student).items()},
                "m": {k: v.numpy() for k, v in _flat(new.opt_state.m).items()}}
    return out


def pair_mesh(mesh):
    """A (1, 2) mesh of this rank's model group (the data group of one)."""
    one = TP(group=None, rank=0, size=1, device=mesh.device)
    return dataclasses.replace(mesh, shape={"data": 1, "model": 2},
                               rank=mesh.model.rank, data=one,
                               world=mesh.model)


def layer_grads(mesh, cfg, layer_specs, params, x, g, qcfg, block,
                fault=None) -> dict:
    """Each leaf's gradient of sum(block(params, x) * g), and x's, on
    ``mesh`` (this rank's model tiles of the layer, the step's amax table)
    or, with ``mesh`` None, on one device."""
    holder = type("Layer", (), {"param_specs": staticmethod(
        lambda c: layer_specs)})
    rules = sharding.make_rules("fsdp_tp")
    if mesh is not None:
        params = sharding.tree_shards(params, layer_specs, mesh, rules,
                                      (cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim))
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    if mesh is not None:
        # the amax table keyed by the leaves the block is given
        plan = qad._mesh_plan(holder, cfg, mesh, rules)
        use = ctx.use_mesh(mesh, rules, qad._tile_amaxes(leaves, plan, qcfg,
                                                         mesh, rules))
    else:
        use = contextlib.nullcontext()
    xl = x.clone().requires_grad_(True)
    with use, planted(fault), torch.enable_grad():
        y = block(leaves, xl)
        (y.float() * g.float()).sum().backward()
    out = {k: torch.zeros(v.shape) if v.grad is None else v.grad.float()
           for k, v in _flat(leaves).items()}
    out["x"] = xl.grad.float()
    return out


def grad_readings(mesh, cfg, layer_specs, params, x, g, qcfg, block,
                  faults=(None,)) -> dict:
    """Each leaf's gradient relative L2 between the (1, 2) mesh's (this
    rank's tiles against its slices of one device's) and one device's,
    for each fault."""
    pm = pair_mesh(mesh)
    rules = sharding.make_rules("fsdp_tp")
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    want = layer_grads(None, cfg, layer_specs, params, x, g, qcfg, block)
    sp = _flat(layer_specs)
    out = {}
    for fault in faults:
        got = layer_grads(pm, cfg, layer_specs, params, x, g, qcfg, block,
                          fault)
        rel = {}
        for k, v in got.items():
            w = want[k]
            if k != "x":
                w = sharding.shard_tensor(sp[k], w, pm, rules, k.replace(
                    "/", "."), heads)
            rel[k] = _rel_l2(v.numpy(), w.numpy())
        out[fault] = rel
    return out


def _rglru_layer(cfg, qcfg):
    from repro_torch.models import rglru

    def block(p, x):
        return rglru._rec_block(qcfg, cfg, p, x, "train", None)[0]
    return rglru._rec_layer_specs(cfg), block


def _port_rank(mesh, params_np: dict, dirs: dict) -> dict:
    torch.set_num_threads(1)
    out = run_cases(mesh, MODELS, CASES, params_np)
    out["drawn_equal"] = drawn_equal(mesh, MODELS, params_np)
    # one RG-LRU layer's gradient on a (1, 2) mesh, every rank alike
    cfg = configs.get_smoke("recurrentgemma-2b")
    qcfg = BF16
    layer_specs, block = _rglru_layer(cfg, qcfg)
    gen = torch.Generator().manual_seed(11)
    params = common.init_params(layer_specs, gen, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen).to(torch.bfloat16)
    g = torch.randn((2, 16, cfg.d_model), generator=gen).to(torch.bfloat16)
    out["grads"] = grad_readings(mesh, cfg, layer_specs, params, x, g, qcfg,
                                 block, (None, "gates"))
    out["runs"] = _mesh_runs(mesh, dirs)
    out["one"] = one_device_steps(MODELS, params_np) if mesh.rank == 0 else None
    out["coords"] = mesh.coords
    return out


def _mesh_runs(mesh, dirs: dict) -> dict:
    """``train_on_mesh`` (fsdp_tp, ``RUN``) on recurrentgemma smoke: with a
    checkpoint after each step (``dirs["a"]``); for 1 step, then resumed
    for the second (``dirs["b"]``); resumed from the one-device
    checkpoint of step 1 (``dirs["one"]``) with nothing left to run.
    Each rank's final shards, the report's bytes and, on rank 0, the
    whole state of run a gathered to the host."""
    cfg = configs.get_smoke(CKPT_ARCH)
    model, rules = get_model(cfg), sharding.make_rules("fsdp_tp")
    quiet = lambda msg: None
    a, _, rep = train.train_on_mesh(mesh, cfg, "fsdp_tp", **RUN, log=quiet,
                                    ckpt_dir=dirs["a"])
    train.train_on_mesh(mesh, cfg, "fsdp_tp", **{**RUN, "steps": 1},
                        log=quiet, ckpt_dir=dirs["b"])
    b, _, rep_b = train.train_on_mesh(mesh, cfg, "fsdp_tp", **RUN, log=quiet,
                                      ckpt_dir=dirs["b"])
    one, _, rep_one = train.train_on_mesh(mesh, cfg, "fsdp_tp",
                                          **{**RUN, "steps": 1}, log=quiet,
                                          ckpt_dir=dirs["one"])
    opt = AdamW(lr=warmup_cosine(LR, 0, 1), clip_norm=1.0)
    like = qad.init_state(model, cfg, torch.Generator().manual_seed(0), opt,
                          device="cpu")
    whole = CheckpointManager(dirs["one"]).restore(1, like)
    cut = qad.shard_state(whole, model, cfg, mesh, rules)
    leaves = lambda st: {f"{t}/{k}": v.float().numpy() for t, tree in (
        ("student", st.student), ("teacher", st.teacher),
        ("m", st.opt_state.m), ("v", st.opt_state.v))
        for k, v in _flat(tree).items()}
    gathered = qad.gather_state(a, model, cfg, mesh, rules, mesh.rank == 0)
    return {"a": leaves(a), "b": leaves(b), "starts": (
                rep["start"], rep_b["start"], rep_one["start"]),
            "steps": (int(a.step), int(b.step), int(one.step)),
            "one": leaves(one), "one_cut": leaves(cut), "bytes": rep["bytes"],
            "gathered": None if gathered is None else leaves(gathered)}


# ---------------------------------------------------------------------------
# C.11: the BF16 attention against the jitted reference, op by op
# ---------------------------------------------------------------------------

C11_ARCH = ("arctic-480b", {"moe_shard": "tp"})


def _c11_reference() -> dict:
    """arctic-480b smoke's first layer in the reference, each op jitted on
    the reference's own inputs (the student's ``moe_hybrid`` policy:
    attention BF16): the norms, the QKV product, RoPE, the blockwise
    attention, ``wo``, the FFN, the layer, and the attention's gradient
    against a fixed cotangent; XLA's mean square and rsqrt of every row."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import specs as jspecs
    from repro.models import attention as jattn
    from repro.models import decoder as jdec
    from repro.models import get_model as jget_model
    from repro.models import layers as jlayers

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    cfg = dataclasses.replace(jconfigs.get_smoke(C11_ARCH[0]), **C11_ARCH[1])
    q = jspecs.recipe_qconfig(cfg)
    params = jget_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    p0 = jax.tree.map(lambda a: a[0], params["layers"])
    rng = np.random.default_rng(5)
    toks = rng.integers(4, cfg.vocab_size, (B, S + 1)).astype(np.int32)[:, :-1]
    g = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    res = {f"c11/params/{k}": f32(v) for k, v in _flat(p0).items()}
    res["c11/g"] = g
    x0 = jax.jit(lambda t: params["embed"][t])(jnp.asarray(toks))
    res["c11/x0"] = f32(x0)
    norm = jax.jit(lambda w, x: jdec.run_norm(cfg, {"w": w}, x))
    h = norm(p0["ln1"]["w"], x0)
    ms = jax.jit(lambda x: jnp.mean(jnp.square(x.astype(jnp.float32)), -1))(x0)
    res["c11/ms"], res["c11/rs"] = f32(ms), f32(jax.jit(
        lambda m: jax.lax.rsqrt(m + 1e-6))(ms))
    qkv = jax.jit(lambda w, h: jlayers.qdense(q, "attn", h, w,
                                              parallelism="column"))(
        p0["wqkv"], h)

    def rope(qkv):
        a, b, c = jnp.split(qkv, [nh * hd, (nh + nkv) * hd], axis=-1)
        return (jdec._rope(cfg, jattn.split_heads(a, nh, hd), pos),
                jdec._rope(cfg, jattn.split_heads(b, nkv, hd), pos),
                jattn.split_heads(c, nkv, hd))
    qq, kk, vv = jax.jit(rope)(qkv)
    o = jax.jit(lambda a, b, c: jattn.blockwise_attention(
        a, b, c, causal=True, window=cfg.window))(qq, kk, vv)
    y = jax.jit(lambda w, o: jlayers.qdense(q, "attn", o.reshape(B, S, -1), w,
                                            parallelism="row"))(p0["wo"], o)
    x1 = x0 + y
    h2 = norm(p0["ln2"]["w"], x1)
    ffn = jax.jit(lambda p, h: jdec._ffn(q, cfg, p, h)[0])(p0, h2)

    def block(p, x):
        out = jdec._block(q, cfg, p, x, pos, "train", None, None)
        return out[0] if isinstance(out, tuple) else out
    blk = jax.jit(block)(p0, x0)

    def att_loss(p, h):
        a = jdec._attention(q, cfg, p, h, pos, "train", None, None)
        a = a[0] if isinstance(a, tuple) else a
        return jnp.sum(a.astype(jnp.float32) * gb.astype(jnp.float32))
    gp, gh = jax.jit(jax.grad(att_loss, argnums=(0, 1)))(p0, h)
    for k, v in (("h", h), ("qkv", qkv), ("q", qq), ("k", kk), ("v", vv),
                 ("o", o), ("y", y), ("x1", x1), ("h2", h2), ("ffn", ffn),
                 ("block", blk), ("dh", gh), ("dwqkv", gp["wqkv"]),
                 ("dwo", gp["wo"])):
        res[f"c11/{k}"] = f32(v)
    return res


def _reference(out_path: str, params_path: str) -> None:
    """This module's reference run (the JAX subprocess)."""
    run_reference(out_path, params_path, MODELS,
                  [(m, "qad") for m in MODELS], c11=True)


# ---------------------------------------------------------------------------
# fixtures and readings (shared with test_torch_train_mesh_slab.py)
# ---------------------------------------------------------------------------


def spawn_with_reference(module: str, models: dict, tmp_path_factory,
                         rank_fn, dirs=None, before=None):
    """The port's seed-0 draw written for the reference, the reference
    started on it (a subprocess), ``before()`` run (say, a one-device run
    writing a checkpoint) and the port's one spawn while it runs, then
    the reference's results: (reference arrays with the draw, the ranks'
    results, the draw)."""
    root = tmp_path_factory.mktemp(module)
    out, params_path = str(root / "ref.npz"), str(root / "params.npz")
    params_np = draw_params(models)
    np.savez(params_path, **params_np)
    proc = start_reference(module, out, params_path)
    try:
        if before is not None:
            before()
        args = (params_np,) if dirs is None else (params_np, dirs)
        ranks = launch_mesh.spawn_mesh(rank_fn, SHAPE, *args, device="cpu",
                                       timeout=900)
        ref = finish_reference(proc, out)
    except BaseException:
        proc.kill()
        raise
    return {**ref, **params_np}, ranks, params_np


def errors(got: dict, want: dict, init: dict) -> dict:
    """A case's readings against an oracle's (``want``: its metrics, or
    the reference's arrays under a prefix, its student and first moment):
    each scalar's relative error, top-1's absolute, each leaf's moment and
    update (new - initial) relative L2, the largest of each kind."""
    scal = {k: abs(got["metrics"][k] - want["metrics"][k])
            / max(abs(want["metrics"][k]), 1e-30)
            for k in want["metrics"] if k != "top1_agree"}
    top1 = (abs(got["metrics"]["top1_agree"] - want["metrics"]["top1_agree"])
            if "top1_agree" in want["metrics"] else 0.0)
    upd = {k: _rel_l2(got["student"][k] - init[k],
                      want["student"][k] - init[k]) for k in got["student"]}
    mom = {k: _rel_l2(got["m"][k], want["m"][k]) for k in got["m"]}
    return {"scalar": max(scal.values()), "top1": top1,
            "moment": max(mom.values()), "update": max(upd.values()),
            "scalars": scal, "worst_update": max(upd, key=upd.get),
            "worst_moment": max(mom, key=mom.get)}


def ref_oracle(ref: dict, key: str) -> dict:
    """The reference's mesh step ``key`` ("model/method") as an oracle."""
    pre = f"{key}/"
    return {"metrics": {k: float(ref[pre + k]) for k in METRICS
                        if pre + k in ref},
            "student": {k[len(pre) + 8:]: v for k, v in ref.items()
                        if k.startswith(pre + "student/")},
            "m": {k[len(pre) + 2:]: v for k, v in ref.items()
                  if k.startswith(pre + "m/")}}


def case_errors(ref: dict, ranks: list, one: dict, cases: dict, key: str,
                oracle: str | None = None) -> dict:
    name, rule, _, method = cases[key]
    oracle = oracle or ORACLE[rule]
    want = (ref_oracle(ref, f"{name}/{method}") if oracle == "ref"
            else one[f"{name}/{method}"])
    init = {k[len(name) + 8:]: v for k, v in ref.items()
            if k.startswith(f"{name}/params/")}
    return errors(ranks[0][key], want, init)


def check_replicas(ranks: list, models: dict, cases: dict, key: str) -> None:
    """Bitwise: every rank's metrics equal; each leaf's stored shard and
    first moment equal on the ranks that hold the same piece of it; the
    stored bytes the partition factors' share."""
    name, rule, *_ = cases[key]
    cfg = cfg_of(models, name, configs.get_smoke)
    places = _flat(sharding.placements(get_model(cfg).param_specs(cfg),
                                       dict(zip(("data", "model"), SHAPE)),
                                       sharding.make_rules(rule)))
    for r in ranks:
        assert r[key]["metrics"] == ranks[0][key]["metrics"]
        for held, share in r[key]["bytes"]:
            assert held == share, (key, held, share)
    for leaf, pl in places.items():
        pieces = {}
        for r in ranks:
            k = (r["coords"]["data"] if pl.data_dim is not None else None,
                 r["coords"]["model"] if pl.model_dim is not None else None)
            pieces.setdefault(k, []).append(r)
        assert len(pieces) == pl.factor
        for group in pieces.values():
            for r in group[1:]:
                for part in ("shards", "moments"):
                    np.testing.assert_array_equal(r[key][part][leaf],
                                                  group[0][key][part][leaf])


def one_by_one(models: dict, params_np: dict, name: str,
               method: str = "qad") -> None:
    """Bitwise: a (1, 1) mesh takes the same step as one device under
    every rule (the student, the moments, every metric), and its eval
    step the same results."""
    torch.set_num_threads(1)
    cfg, model, qcfg, opt, state, batch, qc = setup(models, params_np, name,
                                                    method)
    want, wm = qad.make_train_step(model, cfg, qcfg, opt, qc)(state, batch)
    mesh = ctx.local_mesh("cpu")
    for rule in RULES:
        rules = sharding.make_rules(rule)
        got, gm = qad.make_train_step(model, cfg, qcfg, opt, qc, mesh=mesh,
                                      rules=rules)(
            qad.shard_state(state, model, cfg, mesh, rules), batch)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), (rule, k)
        for a, b in ((got.student, want.student),
                     (got.opt_state.m, want.opt_state.m),
                     (got.opt_state.v, want.opt_state.v)):
            for k, v in _flat(b).items():
                assert torch.equal(_flat(a)[k], v), (rule, k)
    ev = qad.make_eval_step(model, cfg, qcfg, mesh=mesh, rules=rules)(got,
                                                                       batch)
    ew = qad.make_eval_step(model, cfg, qcfg)(want, batch)
    assert all(torch.equal(ev[k], ew[k]) for k in ew)


def check_rule_step(spawned: dict, cases: dict, tol: dict, key: str,
                    tag: str) -> None:
    """The rule's step against its oracle within the model's limits; the
    port's one-device step against the reference's mesh step printed
    beside it (the two oracles' own gap)."""
    name, _, _, method = cases[key]
    one = spawned["ranks"][0]["one"]
    e = case_errors(spawned["ref"], spawned["ranks"], one, cases, key)
    print_errors(tag, key, e)
    base = errors(one[f"{name}/{method}"],
                  ref_oracle(spawned["ref"], f"{name}/{method}"),
                  {k[len(name) + 8:]: v for k, v in spawned["ref"].items()
                   if k.startswith(f"{name}/params/")})
    print_errors(tag, f"{name}/{method}: one device against the reference's "
                 "mesh step", base)
    for k in ("scalar", "top1", "moment", "update"):
        assert e[k] <= tol[name][k], (k, e)


def print_errors(tag: str, key: str, e: dict) -> None:
    print(f"[{tag}] {key}: scalars {e['scalars']}, top-1 {e['top1']:.4g}; "
          f"largest moment rel L2 {e['moment']:.4g} ({e['worst_moment']}), "
          f"update rel L2 {e['update']:.4g} ({e['worst_update']})")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("rglru_ckpt")
    dirs = {k: str(root / k) for k in ("a", "b", "one")}

    def before():
        torch.set_num_threads(1)
        train.train(CKPT_ARCH, **{**RUN, "steps": 1}, ckpt_dir=dirs["one"],
                    device="cpu", log=lambda msg: None)
    ref, ranks, params_np = spawn_with_reference(
        "test_torch_train_mesh_rglru", MODELS, tmp_path_factory, _port_rank,
        dirs, before)
    return dict(ref=ref, ranks=ranks, params=params_np, dirs=dirs)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [k for k, c in CASES.items() if not c[2]])
def test_rglru_rule_step_matches_oracle(spawned, key):
    """Tolerance: the rule's (2, 2) step against the reference's (2, 2)
    fsdp_tp step (fsdp_tp, tp_only) or the port's one-device step
    (fsdp_only, dp_only): loss, KL, CE and top-1, the first moment and
    every leaf's update within the model's limits."""
    check_rule_step(spawned, CASES, TOL, key, "mesh-rglru")


def test_rglru_planted_gate_fault_parts(spawned):
    """Planted fault: recurrentgemma's gates' reduce-scatter forward-only
    under fsdp_tp leaves the loss where the sound step has it and parts
    from the reference's mesh step beyond the limits on the first moment
    and the update."""
    e = case_errors(spawned["ref"], spawned["ranks"],
                    spawned["ranks"][0]["one"], CASES, "rgemma/fault")
    print_errors("mesh-rglru", "planted fault", e)
    assert e["scalar"] <= TOL["rgemma"]["scalar"]
    assert e["moment"] > TOL["rgemma"]["moment"]
    assert e["update"] > TOL["rgemma"]["update"]


@pytest.mark.parametrize("key", list(CASES))
def test_rglru_replicated_leaves_and_metrics_equal_across_ranks(spawned,
                                                                key):
    """Bitwise: every rank's metrics equal; each leaf's stored shard and
    first moment equal on the ranks that hold the same piece of it; the
    stored bytes each rank holds its partition factors' share (an MQA
    tile's KV head counted whole on every model rank)."""
    check_replicas(spawned["ranks"], MODELS, CASES, key)


@pytest.mark.parametrize("rule", ["fsdp_tp", "tp_only"])
def test_mqa_kv_rows_equal_on_every_model_rank(spawned, rule):
    """Bitwise: recurrentgemma's one KV head, held whole in every model
    rank's fused QKV tile, is the same in the updated student and in both
    moments' stored shards on every model rank of a data rank (its
    gradient summed over the model group); and its gathered whole leaf is
    rank 0's copy."""
    cfg = configs.get_smoke("recurrentgemma-2b")
    qh, kh = sharding.local_heads(cfg.n_heads, cfg.n_kv_heads, SHAPE[1])
    cols = slice(qh * cfg.head_dim, (qh + 2 * kh) * cfg.head_dim)
    key = f"rgemma/{rule}"
    ranks = spawned["ranks"]
    leaf = "blocks/attn/wqkv"
    for r in ranks:
        mate = next(o for o in ranks if o["coords"]["data"] ==
                    r["coords"]["data"])
        for part in ("shards", "moments"):
            np.testing.assert_array_equal(r[key][part][leaf][..., cols],
                                          mate[key][part][leaf][..., cols])
    assert ranks[0][key]["shards"][leaf].shape[-1] == (qh + 2 * kh) * \
        cfg.head_dim


@pytest.mark.parametrize("key", [f"{m}/{r}" for m in MODELS for r in RULES])
def test_rglru_mesh_draw_equals_slices_of_one_device_draw(spawned, key):
    """Bitwise: each rank's shards drawn from the seed on the mesh (the
    twice-stacked recurrent leaves, the MQA tile among them) equal its
    shards of the one-device draw."""
    assert all(r["drawn_equal"][key] for r in spawned["ranks"])


@pytest.mark.parametrize("name", list(MODELS))
def test_rglru_one_by_one_mesh_equals_one_device_step(spawned, name):
    """Bitwise: a (1, 1) mesh takes the same step as one device under
    every rule; the eval step gives the same results."""
    one_by_one(MODELS, spawned["params"], name)


def test_rglru_layer_gradient_on_a_one_by_two_mesh(spawned):
    """Gradient: one recurrentgemma RG-LRU layer (BF16 GEMMs) on a (1, 2)
    mesh: every leaf's gradient on each rank's tile
    (``w_a`` and ``w_i`` split on their input dim, their partial
    pre-activations reduce-scattered) and the input's within GRAD_TOL
    relative L2 of its slice of one device's; with the gates'
    reduce-scatter forward-only, ``w_a``, ``w_i`` and the input part
    beyond it."""
    for r in spawned["ranks"]:
        sound, fault = r["grads"][None], r["grads"]["gates"]
        print(f"[mesh-rglru] rank {r['coords']} layer gradient rel L2: "
              f"{ {k: round(v, 6) for k, v in sound.items()} }; gates "
              f"forward-only: { {k: round(v, 4) for k, v in fault.items()} }")
        assert max(sound.values()) <= GRAD_TOL, sound
        for k in ("w_a", "w_i", "x"):
            assert fault[k] > GRAD_TOL, (k, fault)


def test_rglru_mesh_resume_is_the_uninterrupted_run(spawned):
    """Bitwise: a (2, 2) fsdp_tp run of recurrentgemma for 2 steps, saved
    after step 1 and resumed for step 2, leaves every rank's shards of the
    student, the teacher and both moments equal to the uninterrupted
    run's; its stored bytes are the partition factors' share."""
    for r in spawned["ranks"]:
        runs = r["runs"]
        assert runs["starts"] == (0, 1, 1) and runs["steps"] == (2, 2, 1)
        for k, v in runs["a"].items():
            np.testing.assert_array_equal(runs["b"][k], v, err_msg=k)
        for held, share in runs["bytes"].values():
            assert held == share


def test_rglru_mesh_checkpoint_restores_on_one_device(spawned):
    """Bitwise: the recurrentgemma mesh's checkpoint of step 2, restored by
    the one-device ``train()`` (nothing left to run), equals the whole
    state gathered from the ranks' shards (the KV head taken once)."""
    torch.set_num_threads(1)
    state, _ = train.train(CKPT_ARCH, **RUN, ckpt_dir=spawned["dirs"]["a"],
                           device="cpu", log=lambda msg: None)
    assert int(state.step) == RUN["steps"]
    want = spawned["ranks"][0]["runs"]["gathered"]
    for t, tree in (("student", state.student), ("teacher", state.teacher),
                    ("m", state.opt_state.m), ("v", state.opt_state.v)):
        for k, v in _flat(tree).items():
            np.testing.assert_array_equal(v.float().numpy(),
                                          want[f"{t}/{k}"], err_msg=k)


def test_one_device_checkpoint_restores_on_rglru_mesh(spawned):
    """Bitwise: a one-device recurrentgemma checkpoint of step 1 restored
    on the mesh gives each rank its own shards of it."""
    for r in spawned["ranks"]:
        runs = r["runs"]
        for k, v in runs["one_cut"].items():
            np.testing.assert_array_equal(runs["one"][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# C.11
# ---------------------------------------------------------------------------


def _c11_port(ref: dict):
    """(cfg, the student's policy, the first layer's parameters) of the
    C.11 model, the reference's bridged."""
    cfg = dataclasses.replace(configs.get_smoke(C11_ARCH[0]), **C11_ARCH[1])

    def fill(spec, path):
        if isinstance(spec, dict):
            return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
        return ref[f"c11/params/{path[:-1]}"]
    layer = get_model(cfg).param_specs(cfg)["layers"]
    return cfg, specs.recipe_qconfig(cfg), params_from_numpy(fill(layer, ""),
                                                             "cpu")


def _ulps_apart(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each element's distance in bf16 ulps (the larger magnitude's)."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


def test_c11_bf16_attention_ops_match_the_jitted_reference(spawned):
    """Bitwise and tolerance (C.11): arctic-480b smoke's first layer under
    ``moe_hybrid`` (attention BF16), each op on the reference's own
    inputs: the QKV product, RoPE on q and k, the blockwise attention
    (scores, softmax, PV) and ``wo`` part from the jitted reference's at
    no more than C11_SHARE of their elements, each by at most one bf16
    ulp (the f32 sums of two BF16 products in another order); the
    attention's gradient (the input's, ``wqkv``'s and ``wo``'s) within
    1e-4 relative L2; the FFN on the reference's normed input the same.
    So the BF16 attention is the reference's."""
    from repro_torch.models import attention as attn
    from repro_torch.models import decoder, layers
    ref = spawned["ref"]
    torch.set_num_threads(1)
    cfg, q, p0 = _c11_port(ref)
    bf = lambda k: torch.from_numpy(ref[f"c11/{k}"]).to(torch.bfloat16)
    pos = torch.arange(S).expand(B, S)
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    qkv = layers.qdense(q, "attn", bf("h"), p0["wqkv"], parallelism="column")
    a, b, c = torch.split(bf("qkv"), [nh * hd, nkv * hd, nkv * hd], -1)
    ops = {
        "qkv": qkv,
        "q": decoder._rope(cfg, attn.split_heads(a, nh, hd), pos),
        "k": decoder._rope(cfg, attn.split_heads(b, nkv, hd), pos),
        "o": attn.blockwise_attention(bf("q"), bf("k"), bf("v"), causal=True,
                                      window=cfg.window),
        "y": layers.qdense(q, "attn", bf("o").reshape(B, S, -1), p0["wo"],
                           parallelism="row"),
        "ffn": decoder._ffn(q, cfg, p0, bf("h2"))[0]}
    for k, v in ops.items():
        ulps = _ulps_apart(v.float().numpy(), ref[f"c11/{k}"])
        share = float(np.mean(ulps > 0))
        print(f"[c11] {k}: {int((ulps > 0).sum())} of {ulps.size} elements "
              f"part, at most {ulps.max():.3g} bf16 ulp")
        assert share <= C11_SHARE and ulps.max() <= 1.0, (k, share)
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), p0)
    h = bf("h").requires_grad_(True)
    with torch.enable_grad():
        out = decoder._attention(q, cfg, leaves, h, pos, "train", None, None)
        (out.float() * torch.from_numpy(ref["c11/g"]).to(torch.bfloat16)
         .float()).sum().backward()
    for k, got in (("dh", h.grad), ("dwqkv", leaves["wqkv"].grad),
                   ("dwo", leaves["wo"].grad)):
        rel = _rel_l2(got.float().numpy(), ref[f"c11/{k}"])
        print(f"[c11] attention gradient {k}: rel L2 {rel:.3g}")
        assert rel <= 1e-4, (k, rel)


def test_c11_gap_is_the_references_norm_at_bf16_ties(spawned):
    """Tolerance (C.11): the port's RMSNorm parts from the jitted
    reference's only where the program as written, in f32 (``x *
    rsqrt(mean(x^2) + eps) * w``, each op correctly rounded), lands on a
    bf16 rounding tie: XLA's mean of the row parts from it by its order of
    summation and its rsqrt is not correctly rounded, so its f32 product
    falls on the other side of the tie.  Composed from the reference's
    norms, the first layer's output is the reference's (at most one bf16
    ulp at C11_SHARE of its elements); from the port's own, the MoE's
    routing carries a tie's ulp far (1.5e-2 relative L2 at the layer's
    output): where the step's 5.6e-3 in the loss starts
    (``test_torch_train_mesh_moe.py``), the reference's numerics, not
    the port's attention (ROADMAP C.11)."""
    from repro_torch.models import decoder, layers
    ref = spawned["ref"]
    torch.set_num_threads(1)
    cfg, q, p0 = _c11_port(ref)
    x0 = torch.from_numpy(ref["c11/x0"]).to(torch.bfloat16)
    h = layers.rmsnorm(x0, p0["ln1"]["w"]).float().numpy()
    apart = np.argwhere(h != ref["c11/h"])
    assert len(apart) > 0
    w = ref["c11/params/ln1/w"]
    for bi, si, di in apart:
        xf = torch.from_numpy(ref["c11/x0"][bi, si])
        y = float(xf[di] * torch.rsqrt(torch.mean(xf * xf) + 1e-6)
                  * float(w[di]))
        lo, hi = sorted(float(torch.tensor(v).to(torch.bfloat16))
                        for v in (np.nextafter(np.float32(y), np.float32(-np.inf)),
                                  np.nextafter(np.float32(y), np.float32(np.inf))))
        mid = (lo + hi) / 2
        xla = float(np.float32(ref["c11/x0"][bi, si, di])
                    * np.float32(ref["c11/rs"][bi, si]) * np.float32(w[di]))
        exact_rs = float(1.0 / np.sqrt(np.float64(np.float32(
            ref["c11/ms"][bi, si])) + np.float64(np.float32(1e-6))))
        print(f"[c11] norm element {(bi, si, di)}: port {h[bi, si, di]}, "
              f"reference {ref['c11/h'][bi, si, di]}; the program in f32 "
              f"{y!r} (a bf16 tie at {mid!r}), XLA's {xla!r}; XLA's rsqrt "
              f"{float(ref['c11/rs'][bi, si])!r}, of its mean correctly "
              f"rounded {np.float32(exact_rs)!r}")
        assert y == mid and lo != hi
        assert np.sign(xla - mid) != 0 and abs(xla - mid) < abs(mid) * 2 ** -20
        assert float(torch.tensor(y).to(torch.bfloat16)) == h[bi, si, di]
    # the layer composed from the reference's norms, and from the port's
    att = decoder._out_proj(q, p0, torch.from_numpy(ref["c11/o"]).to(
        torch.bfloat16))
    from_ref = (torch.from_numpy(ref["c11/x0"]).to(torch.bfloat16) + att) + \
        decoder._ffn(q, cfg, p0, torch.from_numpy(ref["c11/h2"]).to(
            torch.bfloat16))[0]
    ulps = _ulps_apart(from_ref.float().numpy(), ref["c11/block"])
    own = decoder._block(q, cfg, p0, x0, torch.arange(S).expand(B, S),
                         "train", None, None)
    own_rel = _rel_l2(own.float().numpy(), ref["c11/block"])
    print(f"[c11] layer from the reference's norms: {int((ulps > 0).sum())} "
          f"of {ulps.size} elements part, at most {ulps.max():.3g} ulp; from "
          f"the port's own: rel L2 {own_rel:.3g}")
    assert np.mean(ulps > 0) <= C11_SHARE and ulps.max() <= 1.0
    assert own_rel > 10 * _rel_l2(from_ref.float().numpy(), ref["c11/block"])
