"""The training mesh's arithmetic in the port against the JAX package, on
the CPU, with no process group: the sharding rules, ``resolve`` and
``resolve_packed`` over named mesh shapes, ``partition_factor``, the rest
of ``distributed/fault.py`` and ``optim/compression.py``.

Parity levels, as each test names them:

  * **bitwise**, the four rules tables (with and without a "pod" axis),
    every ``ParamSpec`` of every arch's full config resolved under each
    rule on ``ShapeOnlyMesh`` (2, 2), (16, 16) and (2, 16, 16), dense and
    packed (``PartitionSpec`` entries as tuples), and the partition factor
    of each;
  * **bitwise**, ``replan``, ``host_batch_slices`` and ``Heartbeat`` over
    sampled inputs (the ``hypothesis`` stub's deterministic examples);
  * **bitwise**, ``Int8Compressor`` over 20 roundtrips against the
    reference run op by op (its own test's form), f32 and bf16 gradients,
    with and without error feedback; against the jitted reference the
    dequantized values within one quantization step and the residuals
    within 1e-3 of one (XLA fuses the residual's subtraction: its f32
    rounding parts, by at most 1.6e-4 of a step over five seeds here);
  * **property**, the reference's: with error feedback the sum of 20
    dequantized roundtrips stays within two quantization steps of 20
    times the gradient.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.distributed import fault as jfault
from repro.distributed import sharding as jshd
from repro.models import get_model as jget_model
from repro.optim.compression import Int8Compressor as JInt8Compressor
from repro_torch import configs
from repro_torch.distributed import fault, sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import get_model
from repro_torch.optim import Int8Compressor

MESHES = {"2x2": {"data": 2, "model": 2}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("pod", [False, True])
@pytest.mark.parametrize("mode", sharding.RULE_MODES)
def test_rules_tables_match_reference(mode, pod):
    """Bitwise: each table, letter for letter; the data axes are
    ("pod", "data") on a mesh with a pod axis."""
    shape = MESHES["2x16x16" if pod else "2x2"]
    want = jshd.make_rules(jshd.ShapeOnlyMesh(shape), mode).table
    got = sharding.make_rules(mode, sharding.ShapeOnlyMesh(shape)).table
    assert got == dict(want)
    with pytest.raises(ValueError):
        sharding.make_rules("zero3")


def test_default_rules_are_tp_only_and_keep_serving_tiles():
    """The serving engine's ``make_rules()`` is the reference's tp_only
    table; the group-size form of ``resolve`` reads only its "model"
    entries, so every serving tile stays as it was cut."""
    assert sharding.make_rules().table == sharding.make_rules("tp_only").table
    cfg = configs.get_config("acereason-7b")
    specs = _flat_specs(get_model(cfg).param_specs(cfg))
    rules = sharding.make_rules()
    model_only = sharding.Rules({k: tuple(a for a in v if a == "model")
                                 for k, v in rules.table.items()})
    for path, spec in specs.items():
        assert (sharding.resolve(spec, 2, rules, path)
                == sharding.resolve(spec, 2, model_only, path))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", sharding.RULE_MODES)
def test_resolve_every_arch_matches_reference(mode, mesh_name):
    """Bitwise: ``resolve`` and ``resolve_packed`` of every ParamSpec of
    every arch's full config, and the partition factor of each, against
    the reference's on the same shape-only mesh."""
    shape = MESHES[mesh_name]
    jmesh = jshd.ShapeOnlyMesh(shape)
    pmesh = sharding.ShapeOnlyMesh(shape)
    jrules = jshd.make_rules(jmesh, mode)
    prules = sharding.make_rules(mode, pmesh)
    n = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for arch in configs.ALL_ARCHS:
            jcfg, pcfg = jconfigs.get_config(arch), configs.get_config(arch)
            jspecs = _flat_specs(jget_model(jcfg).param_specs(jcfg))
            pspecs = _flat_specs(get_model(pcfg).param_specs(pcfg))
            assert sorted(jspecs) == sorted(pspecs), arch
            for path, js in jspecs.items():
                ps = pspecs[path]
                assert (tuple(ps.shape), tuple(ps.axes)) == (
                    tuple(js.shape), tuple(js.axes)), (arch, path)
                want = tuple(jshd.resolve(js, jmesh, jrules, path))
                got = sharding.resolve(ps, pmesh, prules, path)
                assert got == want, (arch, path)
                assert (sharding.partition_factor(got, pmesh)
                        == jshd.partition_factor(jshd.resolve(
                            js, jmesh, jrules, path), jmesh))
                if len(js.shape) >= 2 and js.kind:
                    wp = tuple(tuple(p) for p in jshd.resolve_packed(
                        js, jmesh, jrules, path))
                    assert sharding.resolve_packed(ps, pmesh, prules,
                                                   path) == wp, (arch, path)
                n += 1
    assert n > 100


def test_production_mesh_shapes():
    """The reference's production meshes, as shapes: (16, 16) and
    (2, 16, 16) with the reference's axis names."""
    one = launch_mesh.make_production_mesh()
    two = launch_mesh.make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16}
    assert two.axis_names == ("pod", "data", "model")
    assert two.shape == {"pod": 2, "data": 16, "model": 16}


def test_placements_cut_model_tiles_then_data_slices():
    """A runtime (2, 2) mesh's placements of full olmo-1b under fsdp_tp:
    every weight split four ways, on ``embed`` over data and on its
    tensor-parallel dim over model; under dp_only every rank holds it
    all."""
    cfg = configs.get_config("olmo-1b")
    specs = get_model(cfg).param_specs(cfg)
    shape = {"data": 2, "model": 2}
    places = sharding.placements(specs, shape, sharding.make_rules("fsdp_tp"))
    flat = _flat_specs(places)
    assert all(pl.factor == 4 and sharding.replication(pl, shape) == 1
               for pl in flat.values())
    assert flat["layers.wqkv"] == sharding.Placement(1, 2, 4)
    assert flat["layers.wo"] == sharding.Placement(2, 1, 4)
    assert flat["embed"] == sharding.Placement(1, 0, 4)
    dp = sharding.placements(specs, shape, sharding.make_rules("dp_only"))
    assert all(sharding.replication(pl, shape) == 4
               for pl in _flat_specs(dp).values())


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 8), st.integers(0, 255), st.integers(0, 2),
       st.integers(1, 4096))
def test_replan_matches_reference(total, failed_bits, mp_exp, batch):
    """Bitwise: ``replan``'s plan, or its refusal, for sampled fleets."""
    failed = [p for p in range(total) if failed_bits >> p & 1]
    chips = 256
    mp = 4 ** mp_exp
    args = (total, failed, chips, batch * total * (chips // mp), mp)
    try:
        want = jfault.replan(*args)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            fault.replan(*args)
        return
    assert dataclasses.asdict(fault.replan(*args)) == dataclasses.asdict(want)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 5000), st.integers(1, 64))
def test_host_batch_slices_match_reference(batch, hosts):
    """Bitwise: the deal of ``batch`` rows to ``hosts``."""
    assert fault.host_batch_slices(batch, hosts) == jfault.host_batch_slices(
        batch, hosts)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 120))
def test_heartbeat_matches_reference(seed, timeout):
    """Bitwise: the dead pods after sampled marks, at sampled times."""
    rng = np.random.default_rng(seed)
    mine, ref = fault.Heartbeat(float(timeout)), jfault.Heartbeat(float(timeout))
    for _ in range(30):
        pod, t = int(rng.integers(0, 8)), float(rng.uniform(0, 500))
        mine.mark(pod, t)
        ref.mark(pod, t)
        now = float(rng.uniform(0, 700))
        assert mine.dead(now) == ref.dead(now)


def _grads(seed: int, jdt, tdt):
    rng = np.random.default_rng(seed)
    g = {"w": (rng.standard_normal((64, 48)) * 0.1).astype(np.float32),
         "b": {"x": (rng.standard_normal((300,)) * 3).astype(np.float32)}}
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
    tg = {"w": torch.from_numpy(g["w"]).to(tdt),
          "b": {"x": torch.from_numpy(g["b"]["x"]).to(tdt)}}
    return jg, tg


def _leaves(tree) -> list:
    """A tree's leaves as f32 numpy, in sorted-key order (jax or torch)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy()]
    return [np.asarray(jnp.asarray(tree).astype(jnp.float32))]


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compressor_matches_reference(dtype, ef):
    """Bitwise: 20 roundtrips, each one's dequantized gradients and
    residuals, against the reference op by op."""
    jg, tg = _grads(7, getattr(jnp, dtype), getattr(torch, dtype))
    jc, tc = JInt8Compressor(error_feedback=ef), Int8Compressor(error_feedback=ef)
    js, ts = jc.init(jg), tc.init(tg)
    for _ in range(20):
        jd, js = jc.roundtrip(jg, js)
        td, ts = tc.roundtrip(tg, ts)
        for a, b in zip(_leaves(jd), _leaves(td)):
            np.testing.assert_array_equal(b, a)
        for a, b in zip(_leaves(js.residual), _leaves(ts.residual)):
            np.testing.assert_array_equal(b, a)
        assert td["w"].dtype == tg["w"].dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compressor_against_jitted_reference(seed):
    """Tolerance: against ``jax.jit`` of the reference's roundtrip, each
    dequantized value within one quantization step (amax / 127) and each
    residual within 1e-3 of one, over 20 roundtrips."""
    jg, tg = _grads(seed, jnp.float32, torch.float32)
    jc, tc = JInt8Compressor(), Int8Compressor()
    js, ts = jc.init(jg), tc.init(tg)
    rt = jax.jit(jc.roundtrip)
    for _ in range(20):
        steps = [float(np.abs(g + r).max()) / 127 for g, r in
                 zip(_leaves(tg), _leaves(ts.residual))]
        jd, js = rt(jg, js)
        td, ts = tc.roundtrip(tg, ts)
        for a, b, s in zip(_leaves(jd), _leaves(td), steps):
            assert np.abs(a - b).max() <= s
        for a, b, s in zip(_leaves(js.residual), _leaves(ts.residual), steps):
            assert np.abs(a - b).max() <= 1e-3 * s


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 1000))
def test_int8_error_feedback_telescopes(seed):
    """Property (the reference's own test): with error feedback the sum of
    20 dequantized roundtrips of one gradient stays within two
    quantization steps of 20 times it, and parts from it by the last
    residual alone (the bias telescopes)."""
    g = torch.from_numpy((np.random.default_rng(seed).standard_normal(64)
                          * 0.1).astype(np.float32))
    comp = Int8Compressor()
    state = comp.init({"g": g})
    tot = torch.zeros(64)
    for _ in range(20):
        dq, state = comp.roundtrip({"g": g}, state)
        tot = tot + dq["g"]
    err = float(torch.abs(tot - 20 * g).max())
    assert err < float(torch.abs(g).max()) * 0.02 * 2
    assert float(torch.abs(tot - 20 * g + state.residual["g"]).max()) < 1e-5
