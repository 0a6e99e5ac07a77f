"""QAD on a data x model mesh for RWKV6, Whisper and the VLM, the port
against the reference's own mesh step, on the CPU.

As ``test_torch_train_mesh_rglru.py`` does (its helpers are shared): the
reference runs once in a subprocess (``Popen``, while the port's ranks
run) on four emulated host devices with excess precision off, its jitted
``make_train_step`` on a (2, 2) mesh made by ``repro.launch.mesh.
_make_mesh`` under ``fsdp_tp``, one compile a case (its one-device step
is left out: each family's ``test_qad_step_matches_reference``, in
``test_torch_rwkv6.py``, ``test_torch_whisper.py`` and
``test_torch_mrope.py``, holds the port's one-device step to it); the
port's four ranks are gloo processes on the CPU, one intra-op thread
each, every case in one spawn.  Smoke configs, a batch of 8 x 32, the port's seed-0 draw
given to both packages:

  * ``rwkv6-3b``: one head a model rank; the channel mix's receptance
    all-gathered (``ctx.gather_from_model``), the decay LoRA's hidden
    through ``ctx.copy_to_model`` before ``dec_w2``'s column tile;
  * ``whisper-tiny`` on token batches with ``enc_frames``: the encoder,
    the self- and cross-attention regrouped by head, the biases of the
    row sites added once;
  * ``qwen2-vl-2b`` on VLM batches: ``pos3`` (M-RoPE; a 2 x 3 patch grid
    a sequence) and ``vis_embeds`` spliced where ``vis_mask`` is set;
  * ``whisper-tiny`` with an odd vocabulary of 495 (set by
    ``dataclasses.replace`` in both packages, as full whisper-tiny's
    51865) under the chunked KL: the vocabulary stays whole on the model
    group and the log-sum-exps are not combined over it.

Parity levels, as each test names them:

  * **tolerance**, each rule's step: ``fsdp_tp`` and ``tp_only`` against
    the reference's mesh step, ``fsdp_only`` and ``dp_only`` against the
    port's one-device step: loss, KL, CE and top-1, the gathered first
    moment and each leaf's update (new - initial) relative L2, within
    limits read on this CPU and printed by each test; a planted fault,
    RWKV6's receptance gather forward-only, parts beyond them on the
    update and the moment, not on the loss;
  * **gradient**, one RWKV6 layer on a (1, 2) mesh against one device,
    leaf by leaf, and the planted fault beyond the limit;
  * **bitwise**, a (1, 1) mesh against the port's one-device step; every
    rank's metrics equal; each leaf a group replicates equal on its
    ranks; each rank's shards of the seed's draw its slices of the
    one-device draw; the stored bytes the partition factors' share;
  * **bitwise and tolerance**, the numerics probes of an RWKV6 (2, 2)
    step: the same bits on every rank, within ``NUMERICS_RTOL`` of one
    device's, and ``train_on_mesh --numerics``' summary the same on
    every rank.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import qad
from repro_torch.core.qconfig import BF16
from repro_torch.distributed import sharding
from repro_torch.launch import train
from repro_torch.models import common, rwkv6
from test_torch_train_mesh import _flat, _numpy_tree
from test_torch_train_mesh_rglru import (
    B, METRICS, RULES, S, case_errors, check_replicas,
    check_rule_step, drawn_equal, grad_readings, one_by_one,
    one_device_steps, print_errors, run_cases, run_reference, setup,
    spawn_with_reference)

# model -> (arch, config overrides, batch kind)
MODELS = {"rwkv6": ("rwkv6-3b", {}, "tokens"),
          "whisper": ("whisper-tiny", {}, "enc"),
          "qwen2vl": ("qwen2-vl-2b", {}, "vlm"),
          "odd": ("whisper-tiny", {"vocab_size": 495}, "enc")}
# (model, rules, planted fault, method) of each port case
CASES = {**{f"{m}/{r}": (m, r, None, "qad")
            for m in ("rwkv6", "whisper", "qwen2vl") for r in RULES},
         "rwkv6/fault": ("rwkv6", "fsdp_tp", "receptance", "qad"),
         "odd/fsdp_tp": ("odd", "fsdp_tp", None, "chunked"),
         "odd/dp_only": ("odd", "dp_only", None, "chunked")}
# limits read on this CPU (the tests print the readings): the loss, KL and
# CE relative; top-1 absolute (a token is 1/256); the first moment's and
# the update's largest relative L2 over the leaves.  The sound readings
# (fsdp_tp against the reference's mesh step; the port's one-device step
# about as far from it): rwkv6 1.9e-5, 0, 0.016 (mu), 0.17 (ln1/b);
# whisper 8.9e-5, 0, 0.023 (dec bqkv), 0.36 (dec bqkv); qwen2-vl 5.1e-6,
# 0, 0.013 (bqkv), 0.22 (bqkv); the odd vocabulary's chunked KL 8.3e-5,
# 0.026, 0.37 (x_bqkv); the planted receptance fault 1.0 on cm_wr's
# moment and update
TOL = {"rwkv6": {"scalar": 1e-4, "top1": 2 / (B * S), "moment": 0.05,
                 "update": 0.4},
       "whisper": {"scalar": 5e-4, "top1": 2 / (B * S), "moment": 0.05,
                   "update": 0.5},
       "qwen2vl": {"scalar": 1e-4, "top1": 2 / (B * S), "moment": 0.05,
                   "update": 0.4},
       "odd": {"scalar": 5e-4, "top1": 2 / (B * S), "moment": 0.05,
               "update": 0.5}}
# the numerics probes against one device, relative: the limits
# test_torch_numerics.py holds the port's one-card probes to the
# reference's by (the per-layer gradient norms 1e-2, read 5.1e-3 here:
# the mesh's gradient parts from one device's as its first moment does)
NUMERICS_RTOL = {"grad_norm": 1e-2, "other": 1e-3}
# one RWKV6 layer's gradient on a (1, 2) mesh against one device: each
# leaf's relative L2
GRAD_TOL = 1e-2
# train_on_mesh's run of the numerics test: one step and its eval
RUN = dict(steps=1, batch=B, seq=S, eval_every=1, lr=1e-3)


def _reference(out_path: str, params_path: str) -> None:
    """This module's reference run (the JAX subprocess)."""
    run_reference(out_path, params_path, MODELS,
                  [(m, "qad") for m in ("rwkv6", "whisper", "qwen2vl")]
                  + [("odd", "chunked")])


def _port_rank(mesh, params_np: dict) -> dict:
    torch.set_num_threads(1)
    out = run_cases(mesh, MODELS, CASES, params_np)
    out["drawn_equal"] = drawn_equal(mesh, MODELS, params_np)
    # one RWKV6 layer's gradient on a (1, 2) mesh, every rank alike
    cfg = configs.get_smoke("rwkv6-3b")
    qcfg = BF16
    layer_specs = rwkv6._layer_specs(cfg)
    gen = torch.Generator().manual_seed(11)
    params = common.init_params(layer_specs, gen, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen).to(torch.bfloat16)
    g = torch.randn((2, 16, cfg.d_model), generator=gen).to(torch.bfloat16)
    out["grads"] = grad_readings(
        mesh, cfg, layer_specs, params, x, g, qcfg,
        lambda p, x: rwkv6._block(qcfg, cfg, p, x, None, "train")[0],
        (None, "receptance"))
    # the numerics probes of one fsdp_tp step, and train_on_mesh's summary
    cfg, model, qcfg, opt, whole, batch, qc = setup(MODELS, params_np,
                                                    "rwkv6")
    rules = sharding.make_rules("fsdp_tp")
    new, m = qad.make_train_step(model, cfg, dataclasses.replace(
        qcfg, numerics=True), opt, qc, mesh=mesh, rules=rules)(
        qad.shard_state(whole, model, cfg, mesh, rules), batch)
    _, _, rep = train.train_on_mesh(mesh, cfg, "fsdp_tp", **RUN,
                                    numerics=True, log=lambda msg: None)
    out["numerics"] = {"probes": _numpy_tree(m["numerics"]),
                       "metrics": {k: float(m[k]) for k in METRICS},
                       "shards": {k: v.float().numpy() for k, v in
                                  _flat(new.student).items()},
                       "summary": rep["numerics"]}
    if mesh.rank == 0:
        plain = {k: MODELS[k] for k in ("rwkv6", "whisper", "qwen2vl")}
        out["one"] = {**one_device_steps(plain, params_np),
                      **one_device_steps({"odd": MODELS["odd"]}, params_np,
                                         ("chunked",))}
    else:
        out["one"] = None
    out["coords"] = mesh.coords
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    ref, ranks, params_np = spawn_with_reference(
        "test_torch_train_mesh_slab", MODELS, tmp_path_factory, _port_rank)
    return dict(ref=ref, ranks=ranks, params=params_np)


@pytest.mark.parametrize("key", [k for k, c in CASES.items() if not c[2]])
def test_slab_rule_step_matches_oracle(spawned, key):
    """Tolerance: the rule's (2, 2) step against the reference's (2, 2)
    fsdp_tp step (fsdp_tp, tp_only; the odd vocabulary's chunked KL) or
    the port's one-device step (fsdp_only, dp_only): loss, KL, CE and
    top-1, the first moment and every leaf's update within the model's
    limits."""
    check_rule_step(spawned, CASES, TOL, key, "mesh-slab")


def test_rwkv6_planted_receptance_fault_parts(spawned):
    """Planted fault: RWKV6's receptance gather forward-only under fsdp_tp
    leaves the loss where the sound step has it and parts from the
    reference's mesh step beyond the limits on the first moment and the
    update."""
    e = case_errors(spawned["ref"], spawned["ranks"],
                    spawned["ranks"][0]["one"], CASES, "rwkv6/fault")
    print_errors("mesh-slab", "planted fault", e)
    assert e["scalar"] <= TOL["rwkv6"]["scalar"]
    assert e["moment"] > TOL["rwkv6"]["moment"]
    assert e["update"] > TOL["rwkv6"]["update"]


@pytest.mark.parametrize("key", list(CASES))
def test_slab_replicated_leaves_and_metrics_equal_across_ranks(spawned, key):
    """Bitwise: every rank's metrics equal; each leaf's stored shard and
    first moment equal on the ranks that hold the same piece of it; the
    stored bytes each rank holds its partition factors' share."""
    check_replicas(spawned["ranks"], MODELS, CASES, key)


@pytest.mark.parametrize("key", [f"{m}/{r}" for m in MODELS for r in RULES])
def test_slab_mesh_draw_equals_slices_of_one_device_draw(spawned, key):
    """Bitwise: each rank's shards drawn from the seed on the mesh equal
    its shards of the one-device draw."""
    assert all(r["drawn_equal"][key] for r in spawned["ranks"])


@pytest.mark.parametrize("name", ["rwkv6", "whisper", "qwen2vl"])
def test_slab_one_by_one_mesh_equals_one_device_step(spawned, name):
    """Bitwise: a (1, 1) mesh takes the same step as one device under
    every rule (the family's batch extras among the rows it keeps); the
    eval step gives the same results."""
    one_by_one(MODELS, spawned["params"], name)


def test_rwkv6_layer_gradient_on_a_one_by_two_mesh(spawned):
    """Gradient: one RWKV6 layer (BF16 GEMMs) on a (1, 2) mesh: every leaf's gradient on each rank's tile and the input's
    within GRAD_TOL relative L2 of its slice of one device's; with the
    receptance's gather forward-only, ``cm_wr`` and the input part beyond
    it."""
    for r in spawned["ranks"]:
        sound, fault = r["grads"][None], r["grads"]["receptance"]
        print(f"[mesh-slab] rank {r['coords']} layer gradient rel L2: "
              f"{ {k: round(v, 6) for k, v in sound.items()} }; receptance "
              f"forward-only: { {k: round(v, 4) for k, v in fault.items()} }")
        assert max(sound.values()) <= GRAD_TOL, sound
        for k in ("cm_wr", "x"):
            assert fault[k] > GRAD_TOL, (k, fault)


def test_rwkv6_mesh_numerics_match_one_device_and_every_rank(spawned):
    """Bitwise across ranks and tolerance against one device: the probes
    of an RWKV6 (2, 2) fsdp_tp step are the same bits on every rank and
    within NUMERICS_RTOL of the port's one-device step's; the state is
    bitwise the probes-off step's; ``train_on_mesh``'s numerics summary
    is the same on every rank."""
    torch.set_num_threads(1)
    cfg, model, qcfg, opt, state, batch, qc = setup(MODELS, spawned["params"],
                                                    "rwkv6")
    _, m = qad.make_train_step(model, cfg, dataclasses.replace(
        qcfg, numerics=True), opt, qc)(state, batch)
    want = _numpy_tree(m["numerics"])
    ranks = spawned["ranks"]
    got = ranks[0]["numerics"]["probes"]
    assert sorted(got) == sorted(want)
    worst = {}
    for site, stats in want.items():
        assert sorted(got[site]) == sorted(stats), site
        for k, v in stats.items():
            g = got[site][k]
            assert np.array_equal(np.isnan(g), np.isnan(v)), (site, k)
            fin = ~np.isnan(v)
            err = np.abs(g[fin] - v[fin]) / np.maximum(np.abs(v[fin]), 1e-30)
            worst[f"{site}/{k}"] = float(err.max()) if err.size else 0.0
    for kind, lim in NUMERICS_RTOL.items():
        mine = {k: v for k, v in worst.items()
                if (k.endswith("/grad_norm")) == (kind == "grad_norm")}
        print(f"[mesh-slab] rwkv6 numerics against one device, {kind}: "
              f"largest {max(mine.values()):.3g} ({max(mine, key=mine.get)})")
        assert max(mine.values()) <= lim, mine
    for r in ranks:
        for site, stats in got.items():
            for k, v in stats.items():
                np.testing.assert_array_equal(
                    r["numerics"]["probes"][site][k], v)
        assert r["numerics"]["metrics"] == r["rwkv6/fsdp_tp"]["metrics"]
        for k, v in r["numerics"]["shards"].items():
            np.testing.assert_array_equal(v, r["rwkv6/fsdp_tp"]["shards"][k])
        assert r["numerics"]["summary"] == ranks[0]["numerics"]["summary"]
    assert ranks[0]["numerics"]["summary"]


def test_check_mesh_takes_every_family():
    """``check_mesh`` refuses none of the five configs at smoke or full
    size on a (2, 2) mesh under any rule, and still refuses unknown
    rules."""
    for arch in ("nemotron-nano-9b-sim", "recurrentgemma-2b", "rwkv6-3b",
                 "whisper-tiny", "qwen2-vl-2b"):
        for cfg in (configs.get_smoke(arch), configs.get_config(arch)):
            for rule in RULES:
                assert train.check_mesh(cfg, rule, (2, 2)) is None
    with pytest.raises(ValueError, match="unknown sharding rules"):
        train.check_mesh(configs.get_smoke("rwkv6-3b"), "zero3")
