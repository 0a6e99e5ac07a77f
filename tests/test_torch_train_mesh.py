"""QAD training on a data x model mesh, the port against the reference's
own mesh step, on the CPU.

The reference runs once per module in a subprocess on four emulated host
devices (``--xla_force_host_platform_device_count=4``) with excess
precision off (see ``test_torch_serve.py``): its jitted ``make_train_step``
on one device, then on a (2, 2) mesh made by ``repro.launch.mesh.
_make_mesh`` (Auto axes; ``jax.make_mesh``'s Explicit axes fail its
embedding gather, ROADMAP C.3) under each of the four rules, the student
and teacher placed by ``tree_shardings``, as ``tests/test_sharding.py``
places them.  The port's four ranks are gloo processes on the CPU
(``launch.mesh.spawn_mesh``), one intra-op thread each, every case in one
spawn.  Smoke olmo-1b, a batch of 8 x 32, the reference's weights bridged
and cut to each rank's shards.  Parity levels, as each test names them:

  * **tolerance**, each rule's step against the reference's mesh step:
    loss, KL, CE and top-1 within ``SCALAR_RTOL``; the gathered AdamW
    first moment (the clipped gradient, continuous in it) within
    ``MOMENT_TOL`` relative L2; the gathered updated student within one
    bf16 ulp plus 2 lr of each element (as ``test_torch_train.py``) and
    each leaf's update (new - initial) within ``UPDATE_TOL`` relative L2.
    The limits were read on this CPU (printed by each test): the KL is a
    small difference of logsumexps, and the port's own one-device step
    parts from the reference's by 2.45e-5 at this batch (the reference's
    mesh step from its one-device step by 1.7e-5), the (2, 2) steps by
    0.8e-5 to 3.5e-5; step 1 of Adam moves a weight by about lr sign(g),
    a bf16 ulp of the weight is a quarter of lr, so a rounding tie or a
    tiny gradient's sign flips an element's update: the port's one-device
    update parts from the reference's by 0.057 relative L2, the
    reference's mesh from its one device by 0.056, the (2, 2) steps by
    0.065 to 0.076; their moments by 0.0053 to 0.0077.  The planted fault
    reads 1.8e-2 (KL), 0.62 (moment) and 0.89 (update);
  * **bitwise**, a (1, 1) mesh against the port's one-device step;
  * **tolerance**, a mask that differs between the data ranks against
    the reference's mesh step on it (a mean of per-rank means parts);
  * **planted fault**: each rank's own activation amax, with no maximum
    over the data group, parts from the reference beyond the tolerance;
  * **bitwise**, every leaf a group replicates equal on its ranks, and
    every rank's metrics equal;
  * **bitwise**, each rank's shards of the seed's draw on the mesh equal
    its slices of the one-device draw.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import qad
from repro_torch.distributed import ctx, sharding
from repro_torch.distributed.ctx import TP
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import specs, train
from repro_torch.models import get_model
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, warmup_cosine

ARCH = "olmo-1b"
RULES = sharding.RULE_MODES
SHAPE = (2, 2)
B, S = 8, 32
LR, WARMUP, TOTAL = 1e-3, 0, 10
SCALAR_RTOL = 1e-4
MOMENT_TOL = 1e-2
UPDATE_TOL = 0.1
METRICS = ("loss", "kl", "ce", "top1_agree")
# (rules, mask, planted fault) of each port case
CASES = {**{r: (r, "ones", False) for r in RULES},
         "ragged": ("fsdp_tp", "ragged", False),
         "fault": ("fsdp_tp", "ones", True)}


def _batch_np(vocab: int, mask: str):
    rng = np.random.default_rng(3)
    toks = rng.integers(4, vocab, (B, S + 1)).astype(np.int32)
    m = np.ones((B, S), np.float32)
    if mask == "ragged":
        # data rank 1's rows (4..7) keep fewer tokens than rank 0's
        m[B // 2:, S // 4:] = 0.0
        m[1, -3:] = 0.0
    return toks[:, :-1], toks[:, 1:], m


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


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

    cfg = jconfigs.get_smoke(ARCH)
    model = jget_model(cfg)
    qc = jspecs.recipe_qconfig(cfg)
    opt = JAdamW(lr=jwarmup(LR, WARMUP, TOTAL), clip_norm=1.0)
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=params,
                            teacher=jax.tree.map(jnp.copy, params),
                            opt_state=opt.init(params))
    step = jqad.make_train_step(model, cfg, qc, opt)
    res = {f"params/{k}": f32(v) for k, v in _flat(params).items()}

    def record(name, new, m):
        for k in METRICS:
            res[f"{name}/{k}"] = f32(m[k])
        for k, v in _flat(new.student).items():
            res[f"{name}/student/{k}"] = f32(v)
        for k, v in _flat(new.opt_state.m).items():
            res[f"{name}/m/{k}"] = f32(v)

    def batch(mask):
        toks, labels, m = _batch_np(cfg.vocab_size, mask)
        return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                "mask": jnp.asarray(m)}

    record("single", *jax.jit(step)(state, batch("ones")))
    mesh = _make_mesh(SHAPE, ("data", "model"))
    for name, (rule, mask, fault) in CASES.items():
        if fault:
            continue
        rules = jshd.make_rules(mesh, rule)
        shard_p = jshd.tree_shardings(model.param_specs(cfg), mesh, rules)
        with jctx.use(mesh, rules):
            st = jqad.TrainState(
                step=state.step,
                student=jax.device_put(state.student, shard_p),
                teacher=jax.device_put(state.teacher, shard_p),
                opt_state=state.opt_state)
            record(name, *jax.jit(step)(st, batch(mask)))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_mesh_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=4"
             " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.path.join(here, "..", "src"))
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_train_mesh as t; t._reference({out!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _setup(params_np: dict, mask: str):
    """(cfg, model, qcfg, opt, whole state, batch) on the CPU from the
    reference's parameters."""
    cfg = configs.get_smoke(ARCH)
    model = get_model(cfg)

    def fill(spec, path):
        if isinstance(spec, dict):
            return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
        return params_np[f"params/{path[:-1]}"]
    params = params_from_numpy(fill(model.param_specs(cfg), ""), "cpu")
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=params,
                           teacher=tree_map(torch.clone, params),
                           opt_state=opt.init(params))
    toks, labels, m = _batch_np(cfg.vocab_size, mask)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(m)}
    return cfg, model, specs.recipe_qconfig(cfg), opt, state, batch


def local_amax(mesh):
    """The planted fault: ``mesh`` whose data group's max all-reduce
    returns each rank's own value (every other collective as it was)."""
    class Local(TP):
        def all_reduce(self, x, op="sum"):
            return x if op == "max" else super().all_reduce(x, op)
    d = mesh.data
    return dataclasses.replace(mesh, data=Local(
        group=d.group, rank=d.rank, size=d.size, device=d.device))


def _port_rank(mesh, params_np: dict) -> dict:
    """Every case on one rank: the metrics, this rank's stored shards and,
    on rank 0, the whole updated student."""
    torch.set_num_threads(1)
    out = {}
    for name, (rule, mask, fault) in CASES.items():
        cfg, model, qcfg, opt, whole, batch = _setup(params_np, mask)
        rules = sharding.make_rules(rule)
        state = qad.shard_state(whole, model, cfg, mesh, rules)
        step = qad.make_train_step(model, cfg, qcfg, opt, mesh=(
            local_amax(mesh) if fault else mesh), rules=rules)
        new, m = step(state, batch)
        full = qad.gather_params(new.student, model, cfg, mesh, rules)
        full_m = qad.gather_params(new.opt_state.m, model, cfg, mesh, rules)
        out[name] = {
            "metrics": {k: float(m[k]) for k in METRICS},
            "shards": {k: v.float().numpy() for k, v in
                       _flat(new.student).items()},
            "moments": {k: v.numpy() for k, v in _flat(new.opt_state.m).items()},
            "student": ({k: v.float().numpy() for k, v in _flat(full).items()}
                        if mesh.rank == 0 else None),
            "m": ({k: v.numpy() for k, v in _flat(full_m).items()}
                  if mesh.rank == 0 else None)}
    # the seed's draw on the mesh, leaf by leaf, against slices of the
    # one-device draw
    cfg, model, _, opt, _, _ = _setup(params_np, "ones")
    out["drawn_equal"] = {}
    for rule in RULES:
        rules = sharding.make_rules(rule)
        drawn = qad.init_state_on_mesh(model, cfg,
                                       torch.Generator().manual_seed(0), opt,
                                       mesh, rules)
        whole = qad.init_state(model, cfg, torch.Generator().manual_seed(0),
                               opt, device="cpu")
        cut = qad.shard_state(whole, model, cfg, mesh, rules)
        out["drawn_equal"][rule] = all(
            torch.equal(a, b) for tree in ("student", "teacher")
            for a, b in zip(_flat(getattr(drawn, tree)).values(),
                            _flat(getattr(cut, tree)).values()))
    out["coords"] = mesh.coords
    return out


@pytest.fixture(scope="module")
def port(jref):
    params_np = {k: v for k, v in jref.items() if k.startswith("params/")}
    return launch_mesh.spawn_mesh(_port_rank, SHAPE, params_np, device="cpu",
                                  timeout=600)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _errors(port, jref, name: str, ref_name: str | None = None) -> dict:
    """The case's readings against the reference's mesh step: each
    scalar's relative error, and each leaf's moment and update (new -
    initial) relative L2, the largest of each kind."""
    ref_name = ref_name or name
    got = port[0][name]
    scal = {k: abs(got["metrics"][k] - float(jref[f"{ref_name}/{k}"]))
            / max(abs(float(jref[f"{ref_name}/{k}"])), 1e-30) for k in METRICS}
    init = {k: jref[f"params/{k}"] for k in got["student"]}
    upd = {k: _rel_l2(got["student"][k] - init[k],
                      jref[f"{ref_name}/student/{k}"] - init[k])
           for k in got["student"]}
    mom = {k: _rel_l2(got["m"][k], jref[f"{ref_name}/m/{k}"])
           for k in got["m"]}
    return {"scalar": max(scal.values()), "moment": max(mom.values()),
            "update": max(upd.values()), "scalars": scal}


def _assert_sound(port, jref, name: str) -> None:
    e = _errors(port, jref, name)
    print(f"[mesh] {name}: scalars {e['scalars']}; largest moment rel L2 "
          f"{e['moment']:.4g}, update rel L2 {e['update']:.4g}")
    assert e["scalar"] <= SCALAR_RTOL, e
    assert e["moment"] <= MOMENT_TOL, e
    assert e["update"] <= UPDATE_TOL, e
    got = port[0][name]["student"]
    for k, v in got.items():
        want = jref[f"{name}/student/{k}"]
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(v), np.abs(want)), 2.0 ** -126))) - 7)
        assert np.all(np.abs(v - want) <= ulp + 2 * LR), k


@pytest.mark.parametrize("rule", RULES)
def test_rule_step_matches_reference_mesh_step(port, jref, rule):
    """Tolerance: the rule's (2, 2) step on the port's four ranks against
    the reference's (2, 2) mesh step: loss, KL, CE and top-1 within
    SCALAR_RTOL; the first moment within MOMENT_TOL, every leaf's update
    within UPDATE_TOL relative L2, each updated element within one bf16
    ulp plus 2 lr."""
    _assert_sound(port, jref, rule)


def test_ragged_mask_matches_reference_mesh_step(port, jref):
    """Tolerance: a mask whose data ranks keep 125 and 32 tokens, under
    fsdp_tp, against the reference's mesh step on it (the tolerances of
    the rules' test): the port's means are global, where a mean of the
    two ranks' means would weigh a token of rank 1 twice rank 0's."""
    _, _, m = _batch_np(configs.get_smoke(ARCH).vocab_size, "ragged")
    counts = m.reshape(SHAPE[0], -1).sum(1)
    assert counts[0] != counts[1]
    _assert_sound(port, jref, "ragged")


def test_planted_local_amax_fault_parts(port, jref):
    """Planted fault: each rank's own activation amax (no maximum over the
    data group) under fsdp_tp parts from the reference's mesh step beyond
    every tolerance the sound step meets."""
    e = _errors(port, jref, "fault", "fsdp_tp")
    print(f"[mesh] planted fault: scalars {e['scalars']}; largest moment "
          f"rel L2 {e['moment']:.4g}, update rel L2 {e['update']:.4g}")
    assert e["scalar"] > SCALAR_RTOL
    assert e["moment"] > MOMENT_TOL
    assert e["update"] > UPDATE_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_and_metrics_equal_across_ranks(port, name):
    """Bitwise: every rank's metrics equal; each leaf's stored shard equal
    on the ranks that hold the same piece of it (the same coordinate on
    each axis that splits it), the AdamW moments too."""
    rule = CASES[name][0]
    cfg = configs.get_smoke(ARCH)
    places = _flat(sharding.placements(get_model(cfg).param_specs(cfg),
                                       dict(zip(("data", "model"), SHAPE)),
                                       sharding.make_rules(rule)))
    for r in port:
        assert r[name]["metrics"] == port[0][name]["metrics"]
    for leaf, pl in places.items():
        pieces = {}
        for r in port:
            key = (r["coords"]["data"] if pl.data_dim is not None else None,
                   r["coords"]["model"] if pl.model_dim is not None else None)
            pieces.setdefault(key, []).append(r)
        assert len(pieces) == pl.factor
        for group in pieces.values():
            for r in group[1:]:
                for part in ("shards", "moments"):
                    np.testing.assert_array_equal(r[name][part][leaf],
                                                  group[0][name][part][leaf])


@pytest.mark.parametrize("rule", RULES)
def test_mesh_draw_equals_slices_of_one_device_draw(port, rule):
    """Bitwise: each rank's shards drawn from the seed leaf by leaf on the
    mesh (``init_state_on_mesh``) equal its shards of the one-device draw
    (``init_state``, then ``shard_state``)."""
    assert all(r["drawn_equal"][rule] for r in port)


def test_one_by_one_mesh_equals_one_device_step(jref):
    """Bitwise: a (1, 1) mesh (``ctx.local_mesh``: no process group) takes
    the same step as one device under every rule: the updated student,
    the moments and every metric."""
    params_np = {k: v for k, v in jref.items() if k.startswith("params/")}
    cfg, model, qcfg, opt, state, batch = _setup(params_np, "ragged")
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
        ev = qad.make_eval_step(model, cfg, qcfg, mesh=mesh, rules=rules)(
            got, batch)
        ew = qad.make_eval_step(model, cfg, qcfg)(want, batch)
        assert all(torch.equal(ev[k], ew[k]) for k in ew)


@pytest.mark.parametrize("kwargs,match", [
    (dict(arch="qwen2-moe-a2.7b"), "dense decoder only"),
    (dict(arch="rwkv6-3b"), "dense decoder only"),
    (dict(arch="qwen2-vl-2b"), "dense decoder only"),
    (dict(ckpt_dir="ckpt"), "checkpoint resume"),
    (dict(numerics=True), "numerics probes"),
    (dict(metrics_out="m.json"), "numerics probes"),
    (dict(method="qad_chunked"), "chunked KL")])
def test_mesh_refuses_what_waits_for_later_slices(kwargs, match):
    """A mesh run refuses the other families, checkpoint resume, the
    numerics probes and the chunked loss with one line naming ROADMAP
    A.4c, before any rank starts; the CLI prints it and exits 1."""
    args = {"arch": "olmo-1b", "steps": 1, "device": "cpu", "mesh": SHAPE,
            **kwargs}
    with pytest.raises(NotImplementedError, match=match) as err:
        train.train(**args)
    assert "ROADMAP A.4c" in str(err.value) and "\n" not in str(err.value)
    with pytest.raises(ValueError, match="unknown sharding rules"):
        train.train("olmo-1b", device="cpu", mesh=SHAPE, rules="zero3")


def test_cli_mesh_refusal_is_one_line(capsys):
    with pytest.raises(SystemExit) as err:
        train.main(["--device", "cpu", "--mesh", "2x2", "--arch", "rwkv6-3b"])
    assert err.value.code == 1
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("[train] unsupported:")
