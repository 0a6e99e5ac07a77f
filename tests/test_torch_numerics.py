"""The training numerics plane of the PyTorch port against the JAX package,
on the CPU: the probe tape, the quantization-error and divergence probes,
one QAD step's ``metrics["numerics"]``, the snapshot and its validators,
the drift gate and the trainer's ``--numerics`` / ``--metrics-out``.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (see ``test_torch_train.py``), its
probes jitted as its training step runs them.

Parity levels, as each test names them:

  * **bitwise**, the tape (scoping, dedup), and the step's state with
    probes on and off, under every remat mode;
  * **tolerance**, ``quant_error_stats`` on the same inputs: ``amax`` and
    ``clip_frac`` equal, ``sqnr_db`` and ``scale_util`` rtol 1e-5 (f32
    sums in another order); ``hidden_divergence`` rtol 1e-5;
  * **tolerance**, one QAD step's ``metrics["numerics"]``: the same sites
    and stats, each per-layer series within rtol 1e-3 (the student's
    activations agree with the reference's to bf16 rounding, see
    ``test_torch_train.py``), the per-layer gradient norms within rtol
    1e-2 (the gradients' level there);
  * **schema**, a port snapshot passes the port's validator and the
    reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import qad
from repro_torch.kernels import ops
from repro_torch.launch import specs, train
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.obs import compare, export, numerics, validate
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import AdamW, warmup_cosine
from test_torch_train import LR, TOTAL, WARMUP, _batch_np, _flat

ARCH = "olmo-1b"
# quant_error_stats cases: (name, shape, dtype, amax scope)
QES_CASES = [("tensor_f32", (4, 64), "f32", None),
             ("tensor_bf16", (3, 5, 48), "bf16", None),
             ("row", (3, 5, 48), "bf16", "row"),
             ("token", (3, 5, 48), "bf16", "token"),
             ("padded", (2, 40), "f32", None)]



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: these tests run long chains of small
    torch ops, which slow down many times over when the suite's parallel
    workers each spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _qes_x(i):
    name, shape, dt, _ = QES_CASES[i]
    r = np.random.default_rng(60 + i)
    x = (r.standard_normal(shape) * (1 + 4 * r.uniform(size=shape[-1:]))
         ).astype(np.float32)
    x.reshape(-1)[r.integers(0, x.size, 2)] *= 12.0           # outliers
    if dt == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _amax_np(x, scope):
    if scope == "row":
        return np.abs(x).max(axis=tuple(range(1, x.ndim)), keepdims=True)
    if scope == "token":
        return np.abs(x).max(axis=-1, keepdims=True)
    return None


def _hidden_np():
    r = np.random.default_rng(70)
    h_t = r.standard_normal((3, 2, 5, 16)).astype(np.float32)
    h_s = (h_t + 0.1 * r.standard_normal(h_t.shape)).astype(np.float32)
    mask = (r.uniform(size=(2, 5)) > 0.3).astype(np.float32)
    return h_t, h_s, mask


def _numerics_reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import qad as jqad
    from repro.launch import specs as jspecs
    from repro.models import get_model as jget_model
    from repro.obs import numerics as jnum
    from repro.optim import AdamW as JAdamW
    from repro.optim import warmup_cosine as jwarmup_cosine

    res = {}
    for i, (name, _, dt, scope) in enumerate(QES_CASES):
        x = jnp.asarray(_qes_x(i))
        if dt == "bf16":
            x = x.astype(jnp.bfloat16)
        amax = _amax_np(_qes_x(i), scope)
        st = jax.jit(lambda x, a: jnum.quant_error_stats(x, a))(
            x, None if amax is None else jnp.asarray(amax))
        for k, v in st.items():
            res[f"qes/{name}/{k}"] = np.asarray(v)
    h_t, h_s, mask = _hidden_np()
    for k, v in jax.jit(jnum.hidden_divergence)(h_t, h_s, mask).items():
        res[f"hidden/{k}"] = np.asarray(v)

    cfg = jconfigs.get_smoke(ARCH)
    model = jget_model(cfg)
    qc = dataclasses.replace(jspecs.recipe_qconfig(cfg), numerics=True)
    params = jax.jit(lambda k: model.init_params(cfg, k))(jax.random.PRNGKey(0))
    for k, v in _flat(params).items():
        res[f"params/{k}"] = np.asarray(v.astype(jnp.float32))
    toks, labels, mask = _batch_np(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "mask": jnp.asarray(mask)}
    opt = JAdamW(lr=jwarmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = jqad.TrainState(step=jnp.zeros((), jnp.int32), student=params,
                            teacher=jax.tree.map(jnp.copy, params),
                            opt_state=opt.init(params))
    _, m = jax.jit(jqad.make_train_step(model, cfg, qc, opt))(state, batch)
    for site, stats in m["numerics"].items():
        for k, v in stats.items():
            res[f"step/{site}/{k}"] = np.asarray(v, np.float32)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def nref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_numerics_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = f"import test_torch_numerics as t; t._numerics_reference({out!r})"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


# ---------------------------------------------------------------------------
# the tape and the probes
# ---------------------------------------------------------------------------


def test_tape_scoping_and_dedup():
    """Bitwise: the reference's tape semantics (``test_numerics_obs.py``)."""
    tape = numerics.Tape()
    with numerics.collecting(tape):
        assert numerics.active() is tape
        tape.put("a", {"x": 1.0})
        tape.put("a", {"x": 2.0})         # duplicate site -> "#2"
        tape.push_scope()
        tape.put("inner", {"y": 3.0})
        inner = tape.pop_scope()
        tape.put("a", {"x": 4.0})
        with numerics.collecting(None):
            assert numerics.active() is None
        assert numerics.active() is tape
    assert numerics.active() is None
    out = tape.drain()
    assert set(out) == {"a", "a#2", "a#3"}
    assert inner == {"inner": {"y": 3.0}}
    assert tape.drain() == {}             # drain clears


@pytest.mark.parametrize("i", range(len(QES_CASES)), ids=[c[0] for c in QES_CASES])
def test_quant_error_stats_matches_reference(nref, i):
    """Tolerance (module docstring): the probe on the same input and amax
    as the reference's jitted probe; no gradient, no K1 launch."""
    name, _, dt, scope = QES_CASES[i]
    x = torch.from_numpy(_qes_x(i))
    if dt == "bf16":
        x = x.to(torch.bfloat16)
    amax = _amax_np(_qes_x(i), scope)
    x.requires_grad_(True)
    ops.reset_launches()
    st = numerics.quant_error_stats(
        x, None if amax is None else torch.from_numpy(amax))
    assert sum(ops.launches.values()) == 0
    assert set(st) == {"sqnr_db", "amax", "clip_frac", "scale_util"}
    for k, v in st.items():
        assert v.dtype == torch.float32 and v.ndim == 0 and not v.requires_grad
        want = nref[f"qes/{name}/{k}"]
        if k in ("amax", "clip_frac"):
            assert float(v) == float(want), k
        else:
            np.testing.assert_allclose(float(v), want, rtol=1e-5, err_msg=k)
    assert 5.0 < float(st["sqnr_db"]) < 60.0


def test_hidden_divergence_matches_reference(nref):
    """Tolerance rtol 1e-5: per-layer masked cosine and MSE."""
    h_t, h_s, mask = (torch.from_numpy(a) for a in _hidden_np())
    got = numerics.hidden_divergence(h_t, h_s, mask)
    for k in ("hidden_cos", "hidden_mse"):
        assert got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), nref[f"hidden/{k}"],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# one QAD step with probes
# ---------------------------------------------------------------------------


def _numerics_step(nref=None, remat="none", on=True, arch=ARCH):
    """One QAD step of ``arch``'s smoke config with probes ``on``: from
    the reference's parameters (``nref``) or the port's seed-0 init."""
    cfg = dataclasses.replace(configs.get_smoke(arch), remat=remat)
    model = get_model(cfg)
    if nref is not None:
        def fill(spec, path):
            if isinstance(spec, dict):
                return {k: fill(v, f"{path}{k}/") for k, v in spec.items()}
            return nref[f"params/{path[:-1]}"]
        params = params_from_numpy(fill(model.param_specs(cfg), ""), "cpu")
    else:
        params = model.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    toks, labels, mask = _batch_np(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    opt = AdamW(lr=warmup_cosine(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = qad.TrainState(step=torch.zeros((), dtype=torch.int32),
                           student=params, teacher=tree_map(torch.clone, params),
                           opt_state=opt.init(params))
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), numerics=on)
    return qad.make_train_step(model, cfg, qc, opt)(state, batch), cfg


def test_step_numerics_matches_reference(nref):
    """Tolerance (module docstring): the same probe sites and stats as the
    reference's jitted step, every series [n_layers]."""
    (_, m), cfg = _numerics_step(nref)
    num = m["numerics"]
    want = {}
    for key, v in nref.items():
        if key.startswith("step/"):
            site, stat = key[len("step/"):].rsplit("/", 1)
            want.setdefault(site, {})[stat] = v
    assert sorted(num) == sorted(want)
    assert {"layers.hidden", "layers.grad", "layers.mlp.act#3",
            "layers.attn.w#2"} <= set(num)
    for site, stats in want.items():
        assert sorted(num[site]) == sorted(stats), site
        for stat, w in stats.items():
            got = num[site][stat].numpy()
            assert got.shape == (cfg.n_layers,) == w.shape, (site, stat)
            rtol = 1e-2 if site == "layers.grad" else 1e-3
            np.testing.assert_allclose(got, w, rtol=rtol, err_msg=f"{site} {stat}")


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_state_bitwise_with_probes_on_and_off(arch, remat):
    """Bitwise: the step's state and scalar metrics with probes on equal
    those with probes off; under rematerialization the probes record once
    (the same series as without remat)."""
    (s_off, m_off), cfg = _numerics_step(None, remat, False, arch)
    (s_on, m_on), _ = _numerics_step(None, remat, True, arch)
    assert "numerics" not in m_off
    for k in ("loss", "kl", "ce", "grad_norm", "update_norm"):
        assert torch.equal(m_off[k], m_on[k]), k
    for tree in ("student",):
        for a, b in zip(tree_leaves(getattr(s_off, tree)),
                        tree_leaves(getattr(s_on, tree))):
            assert torch.equal(a, b)
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(getattr(s_off.opt_state, part)),
                        tree_leaves(getattr(s_on.opt_state, part))):
            assert torch.equal(a, b), part
    num = m_on["numerics"]
    for site, stats in num.items():
        for stat, v in stats.items():
            assert v.shape == (cfg.n_layers,), (site, stat)
    if remat != "none":
        (_, m_plain), _ = _numerics_step(None, "none", True, arch)
        assert sorted(m_plain["numerics"]) == sorted(num)
        for site, stats in num.items():
            for stat, v in stats.items():
                assert torch.equal(v, m_plain["numerics"][site][stat]), site
    if cfg.n_experts:
        # the expert stacks' weight probes, in tensor scope over [E, ...]
        assert {"layers.mlp.w", "layers.router.w"} & set(num) == {"layers.mlp.w"}


# ---------------------------------------------------------------------------
# export, validation, the drift gate, the trainer
# ---------------------------------------------------------------------------


def _snapshot(values, step=10):
    registry = MetricsRegistry()
    rec = numerics.NumericsRecorder(registry)
    rec.record(values)
    rec.series_point("qad_train_kl", step, 0.003)
    return export.training_snapshot(step, registry, recorder=rec,
                                    tokens=1280, evals={"kl": 0.003}), registry


def test_snapshot_passes_both_validators():
    """Schema: a port training snapshot (labeled per-layer series from
    tensors) and its Prometheus text pass the port's validator and the
    reference's."""
    from repro.obs import validate as jvalidate

    snap, registry = _snapshot({
        "layers.mlp.act": {"sqnr_db": torch.tensor([20.0, float("nan")]),
                           "clip_frac": torch.tensor([0.01, 0.02])},
        "layers.hidden": {"hidden_cos": torch.tensor([0.99, 0.98])}})
    assert snap["engine"]["kind"] == "train"
    per = snap["numerics"]["per_layer"]
    assert per["layers.mlp.act.000"]["sqnr_db"] == 20.0
    assert "sqnr_db" not in per["layers.mlp.act.001"]     # NaN: not probed
    assert validate.check_metrics(snap) == []
    assert jvalidate.check_metrics(json.loads(json.dumps(snap))) == []
    prom = registry.to_prometheus()
    assert 'numerics_sqnr_db{layer="layers.mlp.act.000"}' in prom
    assert validate.check_prometheus(prom) == []
    assert jvalidate.check_prometheus(prom) == []
    assert validate.check_prometheus(export.to_prometheus(snap, registry)) == []


def test_validator_rejects_malformed_labeled_series():
    errs = validate._check_instruments(
        {"x": {"kind": "gauge", "labels": [
            {"labels": {"layer": "b"}, "value": 1.0},
            {"labels": {"layer": "a"}, "value": 2.0}]}})
    assert any("sorted" in e for e in errs)
    errs = validate._check_numerics(
        {"series": {"s": [[2, 1.0], [1, 2.0]]}, "per_layer": {}})
    assert any("non-decreasing" in e for e in errs)
    assert validate.check_metrics({"schema": "nope"})


def test_compare_gate_round_trip(tmp_path):
    """The drift gate: a snapshot against itself passes, against one with
    a lower SQNR, a lower hidden cosine and a higher KL fails on all
    three, from the CLI and from ``python -m repro_torch.obs.numerics``."""
    base, _ = _snapshot({"layers.mlp.act": {"sqnr_db": torch.tensor([20.0])},
                         "layers.hidden": {"hidden_cos": torch.tensor([0.99])}})
    worse, _ = _snapshot({"layers.mlp.act": {"sqnr_db": torch.tensor([17.0])},
                          "layers.hidden": {"hidden_cos": torch.tensor([0.9])}})
    worse["numerics"]["series"]["qad_live_kl"] = [[1, 0.2]]
    base["numerics"]["series"]["qad_live_kl"] = [[1, 0.01]]
    th = {"max_sqnr_drop_db": 1.0, "max_kl_increase": 0.05,
          "max_cos_drop": 0.02, "max_amax_rel": 0.1}
    assert compare.gate_violations(base, base, th) == []
    assert len(compare.gate_violations(base, worse, th)) == 3
    pb, pw = tmp_path / "b.json", tmp_path / "w.json"
    pb.write_text(json.dumps(base))
    pw.write_text(json.dumps(worse))
    assert compare.main([str(pb), str(pb), "--gate"]) == 0
    assert compare.main([str(pb), str(pw), "--gate"]) == 1
    assert numerics.main([str(pb), str(pb), "--gate"]) == 0
    rows = compare.diff(compare.load(str(pb)), compare.load(str(pw)))
    assert rows[0][:2] == ("layers.mlp.act.000", "sqnr_db")


def test_train_cli_numerics_writes_snapshot(tmp_path, capsys):
    """``train.main(["--device", "cpu", "--numerics", "--metrics-out", ...])``
    writes the document and its sibling ``.prom`` at every eval, both
    valid; the per-layer SQNR, divergence and gradient series are there;
    ``python -m repro_torch.obs.validate`` accepts them."""
    out = tmp_path / "m.json"
    hist = train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--numerics",
                       "--metrics-out", str(out)])
    assert [h["step"] for h in hist] == [2]
    assert "wrote" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    prom = tmp_path / "m.prom"
    assert prom.exists() and doc["engine"]["steps"] == 2
    assert doc["numerics"]["sampled_records"] == 1
    assert doc["numerics"]["series"]["qad_train_kl"][0][0] == 2
    n = configs.get_smoke(ARCH).n_layers
    per = doc["numerics"]["per_layer"]
    for site, stat in (("layers.attn.act", "sqnr_db"),
                       ("layers.hidden", "hidden_cos"),
                       ("layers.grad", "grad_norm")):
        assert all(stat in per[f"{site}.{i:03d}"] for i in range(n))
    assert validate.main(["--metrics", str(out), "--prom", str(prom)]) == 0
    # --metrics-out alone implies --numerics
    out2 = tmp_path / "only.json"
    train.main(["--device", "cpu", "--arch", ARCH, "--steps", "1", "--batch",
                "2", "--seq", "16", "--metrics-out", str(out2)])
    assert json.loads(out2.read_text())["numerics"]["per_layer"]
