"""MoE QAD on a data x model mesh, the port against the reference's own
mesh step, on the CPU.

As ``test_torch_train_mesh.py`` does for the dense decoder: the reference
runs once per module in a subprocess on four emulated host devices with
excess precision off, its jitted ``make_train_step`` on one device and on
a (2, 2) mesh made by ``repro.launch.mesh._make_mesh``; the port's four
ranks are gloo processes on the CPU, every case in one spawn.  Two smoke
configs, a batch of 8 x 32, the reference's weights bridged:

  * ``qwen2-moe-a2.7b`` smoke: 6 experts, top-2, split on E over the
    model group (``moe_shard="ep"``), one global capacity domain of
    capacity factor 1.25 (tokens drop), a shared expert behind a sigmoid
    gate;
  * ``arctic-480b`` smoke with ``moe_shard="tp"`` set in both packages:
    8 experts split on their FFN dim (24 of 48 a rank: the hidden's
    blocks cross the cut, so it is gathered and quantized whole), the
    dense residual, the ``moe_hybrid`` recipe (attention BF16).

The reference's mesh step parts from its own one-device step (its
``_einsum`` accumulates in f32 under any mesh).  Its four rules give the
same loss to every digit, but its updated students are equal only
between the two rules that split the model axis (``fsdp_tp``,
``tp_only``) and between the two that do not (``fsdp_only``,
``dp_only``): the pairs part by 0.10 (qwen2-moe) and 0.041 (arctic)
relative L2 of the update, read on this CPU.  So the reference runs
``fsdp_tp`` and ``fsdp_only``, each the oracle of its pair
(``REF_OF``).  Parity levels, as each test names them:

  * **tolerance**, each rule's step against the reference's mesh step:
    loss, KL, CE and top-1 within ``SCALAR_RTOL``, the gathered first
    moment within ``MOMENT_TOL`` and every leaf's update (new - initial)
    within ``UPDATE_TOL`` relative L2, limits read on this CPU and
    printed by each test; a planted fault, each rank's own expert-stack
    weight amax (no maximum over the model group), parts beyond them;
  * **bitwise**, a (1, 1) mesh against the port's one-device MoE step;
    every rank's metrics equal; each leaf a group replicates equal on its
    ranks; each rank's shards of the seed's draw (the expert stacks
    among them) its slices of the one-device draw;
  * **bitwise** across ranks and **tolerance** against one device: the
    MoE layer's aux metrics (``moe_dropped_frac``, ``moe_router_entropy``)
    of every rule's forward on each rank.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import qad
from repro_torch.distributed import ctx, sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import specs
from repro_torch.models import common, get_model, layers
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_train_mesh import (B, LR, METRICS, S, SHAPE, TOTAL, WARMUP,
                                   _flat, _rel_l2)
from repro_torch.bridge import params_from_numpy

ARCHS = {"qwen2-moe": ("qwen2-moe-a2.7b", {}),
         "arctic": ("arctic-480b", {"moe_shard": "tp"})}
RULES = sharding.RULE_MODES
# the reference's oracle of each rule: its step under the rule of the same
# model split (its four rules give one loss; its students are equal
# between fsdp_tp and tp_only, and between fsdp_only and dp_only)
REF_OF = {"fsdp_tp": "fsdp_tp", "tp_only": "fsdp_tp",
          "fsdp_only": "fsdp_only", "dp_only": "fsdp_only"}
REF_RULES = ("fsdp_tp", "fsdp_only")
# (model, rules, planted fault) of each port case
CASES = {**{f"{m}/{r}": (m, r, False) for m in ARCHS for r in RULES},
         **{f"{m}/fault": (m, "fsdp_tp", True) for m in ARCHS}}
# limits by model, read on this CPU (the tests print the readings): the
# loss, KL and CE relative; top-1 absolute (a token is 1/256); the first
# moment's and the update's largest relative L2 over the leaves
TOL = {"qwen2-moe": {"scalar": 1e-3, "top1": 2 / (B * S), "moment": 0.03,
                     "update": 0.4},
       "arctic": {"scalar": 1e-2, "top1": 2 / (B * S), "moment": 0.2,
                  "update": 0.5}}
AUX_RTOL = 1e-2


def _cfg(model: str, get_smoke):
    arch, over = ARCHS[model]
    return dataclasses.replace(get_smoke(arch), **over)


def _batch_np(vocab: int):
    rng = np.random.default_rng(5)
    toks = rng.integers(4, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:], np.ones((B, S), np.float32)


def _reference(out_path: str) -> None:
    """The reference's steps (runs in the JAX subprocess, 4 devices)."""
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
    for name in ARCHS:
        cfg = _cfg(name, jconfigs.get_smoke)
        model = jget_model(cfg)
        qc = jspecs.recipe_qconfig(cfg)
        opt = JAdamW(lr=jwarmup(LR, WARMUP, TOTAL), clip_norm=1.0)
        params = model.init_params(cfg, jax.random.PRNGKey(0))
        state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=params,
                                teacher=jax.tree.map(jnp.copy, params),
                                opt_state=opt.init(params))
        step = jqad.make_train_step(model, cfg, qc, opt)
        for k, v in _flat(params).items():
            res[f"{name}/params/{k}"] = f32(v)
        toks, labels, m = _batch_np(cfg.vocab_size)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                 "mask": jnp.asarray(m)}

        def record(key, new, met):
            for k in METRICS:
                res[f"{key}/{k}"] = f32(met[k])
            for k, v in _flat(new.student).items():
                res[f"{key}/student/{k}"] = f32(v)
            for k, v in _flat(new.opt_state.m).items():
                res[f"{key}/m/{k}"] = f32(v)

        record(f"{name}/single", *jax.jit(step)(state, batch))
        for rule in REF_RULES:
            rules = jshd.make_rules(mesh, rule)
            shard_p = jshd.tree_shardings(model.param_specs(cfg), mesh, rules)
            with jctx.use(mesh, rules):
                st = jqad.TrainState(
                    step=state.step,
                    student=jax.device_put(state.student, shard_p),
                    teacher=jax.device_put(state.teacher, shard_p),
                    opt_state=state.opt_state)
                record(f"{name}/{rule}", *jax.jit(step)(st, batch))
        # the rules' steps against each other (printed)
        for rule in REF_RULES[1:]:
            worst = max(_rel_l2(res[f"{name}/{rule}/student/{k}"]
                                - res[f"{name}/params/{k}"],
                                res[f"{name}/{REF_RULES[0]}/student/{k}"]
                                - res[f"{name}/params/{k}"])
                        for k in _flat(params))
            print(f"[ref] {name}: {rule} against {REF_RULES[0]}: loss "
                  f"{float(res[f'{name}/{rule}/loss']):.9g} "
                  f"({float(res[f'{name}/{REF_RULES[0]}/loss']):.9g}), "
                  f"largest update rel L2 {worst:.3g}", flush=True)
    np.savez(out_path, **res)


def _run_reference(out: str):
    here = os.path.dirname(os.path.abspath(__file__))
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=4"
             " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.path.join(here, "..", "src"))
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_train_mesh_moe as t; t._reference({out!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _setup(params_np: dict, name: str):
    """(cfg, model, qcfg, opt, whole state, batch) on the CPU from the
    reference's parameters of model ``name``."""
    cfg = _cfg(name, configs.get_smoke)
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
    toks, labels, m = _batch_np(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(m)}
    return cfg, model, specs.recipe_qconfig(cfg), opt, state, batch


def own_expert_amax(tile_amaxes):
    """The planted fault: ``qad._tile_amaxes`` whose expert-stack entries
    hold each rank's own tile's amax (no maximum over the model group)."""
    def faulty(tiles, plan, qcfg, mesh, rules):
        table = tile_amaxes(tiles, plan, qcfg, mesh, rules)
        for name in sharding.EXPERT_STACKS:
            t = tiles["layers"][name]
            for i in range(t.shape[0]):
                key = ctx.tile_key(t[i])
                if key in table:
                    table[key] = torch.amax(torch.abs(t[i].float()))
        return table
    return faulty


def _aux(mesh, cfg, model, qcfg, state, batch, rules, lean) -> dict:
    """The first MoE layer's aux metrics of a forward on this rank's
    tiles and rows: its input the tokens' embeddings plus ``lean`` (a
    [d] direction that favours one expert, so that its capacity drops
    tokens)."""
    plan = qad._mesh_plan(model, cfg, mesh, rules)
    with torch.no_grad():
        tiles = sharding.gather_tiles(state.student, plan.places, mesh)
        amaxes = qad._tile_amaxes(tiles, plan, qcfg, mesh, rules)
        with ctx.use_mesh(mesh, rules, amaxes):
            rows = sharding.batch_rows(batch, mesh)
            p0 = common.layer_slice(tiles["layers"], 0)
            from repro_torch.models import decoder
            x = decoder.embed_tokens(cfg, tiles, rows["tokens"]) + lean
            _, aux = layers.moe_ffn(qcfg, cfg, x, p0["router"], p0["moe_wg"],
                                    p0["moe_wu"], p0["moe_wd"])
    return {k: float(v) for k, v in aux.items()}


def _lean(params_np: dict, name: str) -> torch.Tensor:
    """A bf16 [d] direction along the first layer's router column of
    expert 0: added to every token, it sends most choices there."""
    w = params_np[f"{name}/params/layers/router"][0][:, 0]
    return torch.from_numpy(2.0 * w / np.square(w).sum()).to(torch.bfloat16)


def _port_rank(mesh, params_np: dict) -> dict:
    """Every case on one rank: the metrics, this rank's stored shards, the
    aux and, on rank 0, the whole updated student and first moment."""
    torch.set_num_threads(1)
    out = {}
    for key, (name, rule, fault) in CASES.items():
        cfg, model, qcfg, opt, whole, batch = _setup(params_np, name)
        rules = sharding.make_rules(rule)
        state = qad.shard_state(whole, model, cfg, mesh, rules)
        keep = qad._tile_amaxes
        if fault:
            qad._tile_amaxes = own_expert_amax(keep)
        try:
            new, m = qad.make_train_step(model, cfg, qcfg, opt, mesh=mesh,
                                         rules=rules)(state, batch)
        finally:
            qad._tile_amaxes = keep
        full = qad.gather_params(new.student, model, cfg, mesh, rules)
        full_m = qad.gather_params(new.opt_state.m, model, cfg, mesh, rules)
        out[key] = {
            "metrics": {k: float(m[k]) for k in METRICS},
            "shards": {k: v.float().numpy() for k, v in
                       _flat(new.student).items()},
            "moments": {k: v.numpy() for k, v in _flat(new.opt_state.m).items()},
            "aux": (None if fault else
                    _aux(mesh, cfg, model, qcfg, state, batch, rules,
                         _lean(params_np, name))),
            "student": ({k: v.float().numpy() for k, v in _flat(full).items()}
                        if mesh.rank == 0 else None),
            "m": ({k: v.numpy() for k, v in _flat(full_m).items()}
                  if mesh.rank == 0 else None)}
    # the seed's draw on the mesh against slices of the one-device draw
    out["drawn_equal"] = {}
    for name in ARCHS:
        cfg, model, _, opt, _, _ = _setup(params_np, name)
        for rule in RULES:
            rules = sharding.make_rules(rule)
            drawn = qad.init_state_on_mesh(
                model, cfg, torch.Generator().manual_seed(0), opt, mesh,
                rules)
            whole = qad.init_state(model, cfg, torch.Generator().manual_seed(0),
                                   opt, device="cpu")
            cut = qad.shard_state(whole, model, cfg, mesh, rules)
            out["drawn_equal"][f"{name}/{rule}"] = all(
                torch.equal(a, b) for tree in ("student", "teacher")
                for a, b in zip(_flat(getattr(drawn, tree)).values(),
                                _flat(getattr(cut, tree)).values()))
    out["coords"] = mesh.coords
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (a subprocess), then the port's one spawn on the
    reference's parameters, and the port's one-device aux."""
    out = str(tmp_path_factory.mktemp("jax_mesh_moe") / "ref.npz")
    proc = _run_reference(out)
    try:
        stdout, stderr = proc.communicate(timeout=900)
    except BaseException:
        proc.kill()
        raise
    assert proc.returncode == 0, stderr[-4000:]
    print(stdout)
    with np.load(out) as data:
        ref = dict(data)
    params_np = {k: v for k, v in ref.items() if "/params/" in k}
    port = launch_mesh.spawn_mesh(_port_rank, SHAPE, params_np, device="cpu",
                                  timeout=900)
    one = {}
    torch.set_num_threads(1)
    for name in ARCHS:
        cfg, model, qcfg, _, state, batch = _setup(params_np, name)
        one[name] = _aux(ctx.local_mesh("cpu"), cfg, model, qcfg, state,
                         batch, sharding.make_rules("dp_only"),
                         _lean(params_np, name))
    return dict(ref=ref, port=port, one=one, params=params_np)


def _errors(runs, key: str, ref_key: str) -> dict:
    ref = runs["ref"]
    got = runs["port"][0][key]
    scal = {k: abs(got["metrics"][k] - float(ref[f"{ref_key}/{k}"]))
            / max(abs(float(ref[f"{ref_key}/{k}"])), 1e-30)
            for k in METRICS if k != "top1_agree"}
    top1 = abs(got["metrics"]["top1_agree"]
               - float(ref[f"{ref_key}/top1_agree"]))
    name = key.split("/")[0]
    init = {k: ref[f"{name}/params/{k}"] for k in got["student"]}
    upd = {k: _rel_l2(got["student"][k] - init[k],
                      ref[f"{ref_key}/student/{k}"] - init[k])
           for k in got["student"]}
    mom = {k: _rel_l2(got["m"][k], ref[f"{ref_key}/m/{k}"]) for k in got["m"]}
    return {"scalar": max(scal.values()), "top1": top1,
            "moment": max(mom.values()), "update": max(upd.values()),
            "scalars": scal, "worst_update": max(upd, key=upd.get),
            "worst_moment": max(mom, key=mom.get)}


@pytest.mark.parametrize("key", [k for k, c in CASES.items() if not c[2]])
def test_moe_rule_step_matches_reference_mesh_step(runs, key):
    """Tolerance: the rule's (2, 2) MoE step on the port's four ranks
    against the reference's (2, 2) mesh step under the rule of the same
    model split (``REF_OF``): loss, KL, CE and top-1 within SCALAR_RTOL,
    the gathered first moment within MOMENT_TOL and every leaf's update
    within UPDATE_TOL relative L2."""
    name, rule, _ = CASES[key]
    e = _errors(runs, key, f"{name}/{REF_OF[rule]}")
    print(f"[mesh-moe] {key}: scalars {e['scalars']}, top-1 {e['top1']:.4g}; "
          f"largest moment rel L2 {e['moment']:.4g} ({e['worst_moment']}), "
          f"update rel L2 {e['update']:.4g} ({e['worst_update']})")
    for k in ("scalar", "top1", "moment", "update"):
        assert e[k] <= TOL[name][k], (k, e)


@pytest.mark.parametrize("name", list(ARCHS))
def test_moe_planted_expert_amax_fault_parts(runs, name):
    """Planted fault: each rank's own expert-stack weight amax under
    fsdp_tp parts from the reference's mesh step beyond the tolerances
    the sound steps meet (the update and the moment)."""
    e = _errors(runs, f"{name}/fault", f"{name}/fsdp_tp")
    print(f"[mesh-moe] {name} planted fault: scalars {e['scalars']}, top-1 "
          f"{e['top1']:.4g}; largest moment rel L2 {e['moment']:.4g} "
          f"({e['worst_moment']}), update rel L2 {e['update']:.4g} "
          f"({e['worst_update']})")
    assert e["moment"] > TOL[name]["moment"]
    assert e["update"] > TOL[name]["update"]


@pytest.mark.parametrize("key", list(CASES))
def test_moe_replicated_leaves_and_metrics_equal_across_ranks(runs, key):
    """Bitwise: every rank's metrics and aux equal; each leaf's stored
    shard (and first moment) equal on the ranks that hold the same piece
    of it."""
    port = runs["port"]
    name, rule, _ = CASES[key]
    cfg = _cfg(name, configs.get_smoke)
    places = _flat(sharding.placements(get_model(cfg).param_specs(cfg),
                                       dict(zip(("data", "model"), SHAPE)),
                                       sharding.make_rules(rule)))
    for r in port:
        assert r[key]["metrics"] == port[0][key]["metrics"]
        assert r[key]["aux"] == port[0][key]["aux"]
    for leaf, pl in places.items():
        pieces = {}
        for r in port:
            k = (r["coords"]["data"] if pl.data_dim is not None else None,
                 r["coords"]["model"] if pl.model_dim is not None else None)
            pieces.setdefault(k, []).append(r)
        assert len(pieces) == pl.factor
        for group in pieces.values():
            for r in group[1:]:
                for part in ("shards", "moments"):
                    np.testing.assert_array_equal(r[key][part][leaf],
                                                  group[0][key][part][leaf])


@pytest.mark.parametrize("key", [k for k, c in CASES.items() if not c[2]])
def test_moe_aux_matches_one_device(runs, key):
    """Tolerance: the first MoE layer's dropped fraction and router
    entropy on the mesh (the whole batch's, one capacity domain over
    every data rank's tokens) within AUX_RTOL of one device's, on inputs
    that make qwen2-moe's capacity drop tokens."""
    got = runs["port"][0][key]["aux"]
    want = runs["one"][key.split("/")[0]]
    print(f"[mesh-moe] {key} aux {got} (one device {want})")
    for k, v in want.items():
        assert abs(got[k] - v) <= AUX_RTOL * max(abs(v), 1e-6), (k, got, want)
    if key.startswith("qwen2-moe"):                  # arctic's capacity: 8
        assert want["moe_dropped_frac"] > 0            # tokens drop


@pytest.mark.parametrize("key", [f"{m}/{r}" for m in ARCHS for r in RULES])
def test_moe_mesh_draw_equals_slices_of_one_device_draw(runs, key):
    """Bitwise: each rank's shards drawn from the seed on the mesh (the
    router and the expert stacks among them) equal its shards of the
    one-device draw."""
    assert all(r["drawn_equal"][key] for r in runs["port"])


@pytest.mark.parametrize("name", list(ARCHS))
def test_moe_one_by_one_mesh_equals_one_device_step(runs, name):
    """Bitwise: a (1, 1) mesh takes the same MoE step as one device under
    every rule: the updated student, the moments and every metric."""
    torch.set_num_threads(1)
    cfg, model, qcfg, opt, state, batch = _setup(runs["params"], name)
    want, wm = qad.make_train_step(model, cfg, qcfg, opt)(state, batch)
    mesh = ctx.local_mesh("cpu")
    for rule in RULES:
        rules = sharding.make_rules(rule)
        got, gm = qad.make_train_step(model, cfg, qcfg, opt, mesh=mesh,
                                      rules=rules)(
            qad.shard_state(state, model, cfg, mesh, rules), batch)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), (rule, k)
        for a, b in ((got.student, want.student),
                     (got.opt_state.m, want.opt_state.m),
                     (got.opt_state.v, want.opt_state.v)):
            for k, v in _flat(b).items():
                assert torch.equal(_flat(a)[k], v), (rule, k)
