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
    its slices of the one-device draw;
  * **tolerance**, ``qad_chunked`` under ``fsdp_tp`` and ``tp_only`` (the
    vocabulary split over the model group) against the reference's mesh
    ``qad_chunked`` step and the port's own mesh ``qad`` step;
  * **bitwise** across ranks and **tolerance** against one device, the
    numerics probes of a (2, 2) step (``NUMERICS_RTOL``), the state
    bitwise the probes-off step's; the ``--metrics-out`` snapshot valid;
  * **bitwise**, checkpoint resume through ``train_on_mesh``: a run
    resumed after step 1 equals the uninterrupted one; the mesh's
    checkpoint restored by the one-device ``train()`` equals the gathered
    shards; a one-device checkpoint restored on the mesh gives each rank
    its slices.
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import qad
from repro_torch.distributed import ctx, sharding
from repro_torch.distributed.ctx import TP
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import specs, train
from repro_torch.models import get_model
from repro_torch.models.common import tree_map
from repro_torch.obs import validate
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
# the chunked KL (``qad_chunked``) where the unembedding's vocabulary
# splits over the model group, against the reference's mesh step on it
CHUNKED = {f"chunked/{r}": r for r in ("fsdp_tp", "tp_only")}
# the numerics probes' limits against one device, relative, read on this
# CPU: the probes' sums run in other orders (sound up to 4.8e-5, the
# hidden MSE); the gradient norms are those of the mesh's gradient, which
# parts from one device's as the first moment does (sound 1.3e-4)
NUMERICS_RTOL = {"grad_norm": 1e-3, "other": 1e-4}
# train_on_mesh's runs of the checkpoint and probe tests: 2 steps, an
# eval (and a checkpoint) after each
RUN = dict(steps=2, batch=B, seq=S, eval_every=1, lr=LR)


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
            if k in m:
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
    chunked = jqad.make_train_step(model, cfg, qc, opt, jqad.QADConfig(
        loss="kl", use_chunked_loss=True))
    for name, rule in CHUNKED.items():
        rules = jshd.make_rules(mesh, rule)
        shard_p = jshd.tree_shardings(model.param_specs(cfg), mesh, rules)
        with jctx.use(mesh, rules):
            st = jqad.TrainState(
                step=state.step,
                student=jax.device_put(state.student, shard_p),
                teacher=jax.device_put(state.teacher, shard_p),
                opt_state=state.opt_state)
            record(name, *jax.jit(chunked)(st, batch("ones")))
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


def _numpy_tree(tree) -> dict:
    """{site: {stat: f32 numpy}} of a ``metrics["numerics"]`` dict."""
    return {site: {k: v.float().numpy() for k, v in st.items()}
            for site, st in tree.items()}


def _mesh_runs(mesh, dirs: dict) -> dict:
    """``train_on_mesh`` (fsdp_tp, ``RUN``) three times: with the probes on
    and a checkpoint after each step (``dirs["a"]``, rank 0 writing the
    snapshot ``dirs["metrics"]``); without the probes for 1 step, then
    resumed for the second (``dirs["b"]``); resumed from the one-device
    checkpoint of step 1 (``dirs["one"]``) with nothing left to run.
    Each rank's final shards, its report's numerics and, on rank 0, the
    whole state of run a gathered to the host."""
    cfg = configs.get_smoke(ARCH)
    model, rules = get_model(cfg), sharding.make_rules("fsdp_tp")
    quiet = lambda msg: None
    a, _, rep = train.train_on_mesh(mesh, cfg, "fsdp_tp", **RUN, log=quiet,
                                    ckpt_dir=dirs["a"], numerics=True,
                                    metrics_out=dirs["metrics"])
    train.train_on_mesh(mesh, cfg, "fsdp_tp", **{**RUN, "steps": 1},
                        log=quiet, ckpt_dir=dirs["b"])
    b, _, rep_b = train.train_on_mesh(mesh, cfg, "fsdp_tp", **RUN, log=quiet,
                                      ckpt_dir=dirs["b"])
    one, _, rep_one = train.train_on_mesh(mesh, cfg, "fsdp_tp",
                                          **{**RUN, "steps": 1}, log=quiet,
                                          ckpt_dir=dirs["one"])
    # the one-device checkpoint, cut on this rank, for the comparison
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
            "one": leaves(one), "one_cut": leaves(cut),
            "numerics": rep["numerics"],
            "gathered": None if gathered is None else leaves(gathered)}


def _port_rank(mesh, params_np: dict, dirs: dict) -> dict:
    """Every case on one rank: the metrics, this rank's stored shards and,
    on rank 0, the whole updated student."""
    torch.set_num_threads(1)
    out = {}
    for name, (rule, mask, fault) in {
            **CASES, **{k: (r, "ones", False) for k, r in CHUNKED.items()}
            }.items():
        cfg, model, qcfg, opt, whole, batch = _setup(params_np, mask)
        rules = sharding.make_rules(rule)
        state = qad.shard_state(whole, model, cfg, mesh, rules)
        method = qad.QADConfig(loss="kl", use_chunked_loss=name in CHUNKED)
        step = qad.make_train_step(model, cfg, qcfg, opt, method, mesh=(
            local_amax(mesh) if fault else mesh), rules=rules)
        new, m = step(state, batch)
        full = qad.gather_params(new.student, model, cfg, mesh, rules)
        full_m = qad.gather_params(new.opt_state.m, model, cfg, mesh, rules)
        out[name] = {
            "metrics": {k: float(m[k]) for k in METRICS if k in m},
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
    # the numerics probes on one fsdp_tp step, and the state beside them
    cfg, model, qcfg, opt, whole, batch = _setup(params_np, "ones")
    rules = sharding.make_rules("fsdp_tp")
    state = qad.shard_state(whole, model, cfg, mesh, rules)
    new, m = qad.make_train_step(model, cfg, dataclasses.replace(
        qcfg, numerics=True), opt, mesh=mesh, rules=rules)(state, batch)
    out["numerics"] = {"probes": _numpy_tree(m["numerics"]),
                       "metrics": {k: float(m[k]) for k in METRICS},
                       "shards": {k: v.float().numpy() for k, v in
                                  _flat(new.student).items()}}
    out["runs"] = _mesh_runs(mesh, dirs)
    out["coords"] = mesh.coords
    return out


@pytest.fixture(scope="module")
def spawned(jref, tmp_path_factory):
    """The port's one spawn, after a one-device run has written its
    checkpoint of step 1; the ranks' results and the directories."""
    params_np = {k: v for k, v in jref.items() if k.startswith("params/")}
    root = tmp_path_factory.mktemp("mesh_ckpt")
    dirs = {k: str(root / k) for k in ("a", "b", "one")}
    dirs["metrics"] = str(root / "m.json")
    train.train(ARCH, **{**RUN, "steps": 1}, ckpt_dir=dirs["one"],
                device="cpu", log=lambda msg: None)
    ranks = launch_mesh.spawn_mesh(_port_rank, SHAPE, params_np, dirs,
                                   device="cpu", timeout=600)
    return ranks, dirs


@pytest.fixture(scope="module")
def port(spawned):
    return spawned[0]


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


@pytest.mark.parametrize("rule", list(CHUNKED.values()))
def test_chunked_kl_step_matches_reference_mesh_step(port, jref, rule):
    """Tolerance: ``qad_chunked`` under a rule that splits the vocabulary
    over the model group (the log-sum-exps combined over it, the global
    denominator) against the reference's mesh ``qad_chunked`` step: the
    loss within SCALAR_RTOL, the first moment within MOMENT_TOL and each
    leaf's update within UPDATE_TOL; and against the port's own mesh
    ``qad`` step under the rule (the KL kernel's): the loss within
    SCALAR_RTOL."""
    name = f"chunked/{rule}"
    got = port[0][name]
    e = {k: abs(got["metrics"][k] - float(jref[f"{name}/{k}"]))
         / abs(float(jref[f"{name}/{k}"])) for k in ("loss", "kl")}
    init = {k: jref[f"params/{k}"] for k in got["student"]}
    upd = max(_rel_l2(got["student"][k] - init[k],
                      jref[f"{name}/student/{k}"] - init[k])
              for k in got["student"])
    mom = max(_rel_l2(got["m"][k], jref[f"{name}/m/{k}"]) for k in got["m"])
    plain = (abs(got["metrics"]["loss"] - port[0][rule]["metrics"]["loss"])
             / abs(port[0][rule]["metrics"]["loss"]))
    print(f"[mesh] {name}: {e}; moment {mom:.4g}, update {upd:.4g}; "
          f"against the port's qad step {plain:.3g}")
    assert max(e.values()) <= SCALAR_RTOL
    assert mom <= MOMENT_TOL and upd <= UPDATE_TOL
    assert plain <= SCALAR_RTOL
    for r in port:
        assert r[name]["metrics"] == got["metrics"]


def _one_device_numerics(jref) -> dict:
    params_np = {k: v for k, v in jref.items() if k.startswith("params/")}
    cfg, model, qcfg, opt, state, batch = _setup(params_np, "ones")
    _, m = qad.make_train_step(model, cfg, dataclasses.replace(
        qcfg, numerics=True), opt)(state, batch)
    return {site: {k: v.float().numpy() for k, v in st.items()}
            for site, st in m["numerics"].items()}


def test_mesh_numerics_match_one_device_and_every_rank(port, jref):
    """Bitwise across ranks and tolerance against one device: the probes
    of a (2, 2) fsdp_tp step (every site's SQNR, amax, clip fraction and
    scale use by layer, the hidden cosine and MSE, the per-layer gradient
    norms) are the same bits on every rank, and within NUMERICS_RTOL of
    the port's one-device step on the same global batch (held to the
    reference's in ``test_torch_numerics.py``); the state is bitwise the
    state of the same step with the probes off."""
    want = _one_device_numerics(jref)
    got = port[0]["numerics"]["probes"]
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
        print(f"[mesh] numerics against one device, {kind}: largest "
              f"{max(mine.values()):.3g} ({max(mine, key=mine.get)})")
        assert max(mine.values()) <= lim, mine
    for r in port:
        for site, stats in got.items():
            for k, v in stats.items():
                np.testing.assert_array_equal(
                    r["numerics"]["probes"][site][k], v)
        assert r["numerics"]["metrics"] == r["fsdp_tp"]["metrics"]
        for k, v in r["numerics"]["shards"].items():
            np.testing.assert_array_equal(v, r["fsdp_tp"]["shards"][k])


def test_mesh_snapshot_valid_and_the_same_on_every_rank(spawned):
    """Bitwise across ranks: ``train_on_mesh``'s numerics summary (the
    snapshot's ``numerics`` section) at its last eval; rank 0's
    ``--metrics-out`` snapshot and its ``.prom`` pass the validator."""
    ranks, dirs = spawned
    summary = ranks[0]["runs"]["numerics"]
    assert summary["sampled_records"] == RUN["steps"]
    assert summary["per_layer"]
    for r in ranks:
        assert r["runs"]["numerics"] == summary
    import json
    with open(dirs["metrics"]) as f:
        snap = json.load(f)
    assert validate.check_metrics(snap) == []
    assert snap["numerics"] == json.loads(json.dumps(summary))
    with open(dirs["metrics"].rsplit(".", 1)[0] + ".prom") as f:
        assert validate.check_prometheus(f.read()) == []


def test_mesh_resume_is_the_uninterrupted_run(port):
    """Bitwise: a (2, 2) fsdp_tp run of 2 steps with the probes off, saved
    after step 1 and resumed for step 2, leaves every rank's shards of the
    student, the teacher and both moments equal to those of the
    uninterrupted run with the probes on (so neither the resume nor the
    probes moves a bit)."""
    for r in port:
        runs = r["runs"]
        assert runs["starts"] == (0, 1, 1) and runs["steps"] == (2, 2, 1)
        assert sorted(runs["a"]) == sorted(runs["b"])
        for k, v in runs["a"].items():
            np.testing.assert_array_equal(runs["b"][k], v, err_msg=k)


def test_mesh_checkpoint_restores_on_one_device(spawned):
    """Bitwise: the mesh's checkpoint of step 2, restored by the
    one-device ``train()`` (nothing left to run), equals the whole state
    gathered from the ranks' shards."""
    ranks, dirs = spawned
    torch.set_num_threads(1)
    state, _ = train.train(ARCH, **RUN, ckpt_dir=dirs["a"], device="cpu",
                           log=lambda msg: None)
    assert int(state.step) == RUN["steps"]
    want = ranks[0]["runs"]["gathered"]
    for t, tree in (("student", state.student), ("teacher", state.teacher),
                    ("m", state.opt_state.m), ("v", state.opt_state.v)):
        for k, v in _flat(tree).items():
            np.testing.assert_array_equal(v.float().numpy(),
                                          want[f"{t}/{k}"], err_msg=k)


def test_one_device_checkpoint_restores_on_mesh(port):
    """Bitwise: a one-device checkpoint of step 1 restored on the mesh
    gives each rank its own shards of it (the student, the teacher and
    both moments)."""
    for r in port:
        runs = r["runs"]
        for k, v in runs["one_cut"].items():
            np.testing.assert_array_equal(runs["one"][k], v, err_msg=k)


def test_weight_tile_amax_lookup_refuses_a_narrowed_view():
    """Planted fault: a narrowed view of a weight tile the step's amax
    table holds (here a layer's slice of a stacked tile) raises under
    ``ctx.use_mesh`` instead of taking its own amax; the slice itself and
    its transpose (the tied unembedding's ``embed.T``: the same elements)
    take the table's amax, bitwise the QDQ with that amax; a weight the
    table does not hold takes its own."""
    from repro_torch.core.qconfig import NVFP4_ALL, _fq_axis
    gen = torch.Generator().manual_seed(7)
    stack = torch.randn((2, 32, 48), generator=gen).to(torch.bfloat16)
    amax = torch.tensor(9.0)
    table = {ctx.tile_key(stack[i]): amax for i in range(2)}
    mesh, rules = ctx.local_mesh("cpu"), sharding.make_rules("fsdp_tp")
    other = torch.randn((32, 48), generator=gen).to(torch.bfloat16)
    with ctx.use_mesh(mesh, rules, table):
        got = NVFP4_ALL.q_weight(stack[1], "mlp", 0)
        assert torch.equal(got, _fq_axis(stack[1], 0, amax))
        got_t = NVFP4_ALL.q_weight(stack[1].T, "mlp", 1)
        assert torch.equal(got_t, _fq_axis(stack[1].T, 1, amax))
        assert torch.equal(NVFP4_ALL.q_weight(other, "mlp", 0),
                           _fq_axis(other, 0))
        with pytest.raises(ValueError, match="narrowed or offset"):
            NVFP4_ALL.q_weight(stack[1][:, :16], "mlp", 0)
        with pytest.raises(ValueError, match="narrowed or offset"):
            NVFP4_ALL.q_weight(stack[1][16:], "mlp", 0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(arch="qwen2.5-14b"), "5 query and 1 KV heads do not split"),
    (dict(arch="qwen2.5-14b", rules="tp_only"), "do not split over 2")])
def test_mesh_refuses_what_waits_for_later_slices(kwargs, match):
    """A mesh run refuses, with one line before any rank starts, a config
    whose heads do not split over the model group under a rule that
    splits over it (qwen2.5-14b smoke's 5 query heads; every family
    trains on the mesh otherwise, ``test_torch_train_mesh_slab.py``), and
    rules it does not know; the CLI prints the first and exits 1."""
    args = {"arch": "olmo-1b", "steps": 1, "device": "cpu", "mesh": SHAPE,
            **kwargs}
    with pytest.raises(NotImplementedError, match=match) as err:
        train.train(**args)
    assert "\n" not in str(err.value)
    with pytest.raises(ValueError, match="unknown sharding rules"):
        train.train("olmo-1b", device="cpu", mesh=SHAPE, rules="zero3")


def test_cli_mesh_refusal_is_one_line(capsys):
    with pytest.raises(SystemExit) as err:
        train.main(["--device", "cpu", "--mesh", "2x2", "--arch",
                    "qwen2.5-14b"])
    assert err.value.code == 1
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("[train] unsupported:")
