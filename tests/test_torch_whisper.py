"""The encoder-decoder family (``models/whisper.py``), ``layers.gelu`` and
``layers.sinusoidal_pos`` in the PyTorch port against the JAX package, on
the CPU, at the ``whisper-tiny-smoke`` config (2 + 2 layers, d_model 64,
30 encoder frames), and through the engine's slab backend with
per-request encoder frames.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (``test_torch_rwkv6.run_reference``)
on numpy-seeded inputs and its own ``init_params``, bridged to the port.

Parity levels, as each test names them:

  * **bitwise**: ``layers.gelu`` against the jitted ``jax.nn.gelu`` on
    every finite bf16 value (subnormals flushed as XLA's CPU code flushes
    them), and ``gelu_mlp`` goes through it;
  * **tolerance** (f32): ``sinusoidal_pos`` within 2^-21 of the largest
    angle (XLA's sin and cos are not torch's; at 1500 x 384 they part by
    1.2e-4 where the angle reaches 1500, measured);
  * **tolerance**: ``encode``'s output, ``apply``, ``prefill`` and
    ``decode_step_slots`` logits, rtol = atol = 5e-2 (``test_torch_rglru.
    py``'s level);
  * **greedy tokens**: the port's slab engine, each request with its own
    ``enc_frames``, against the reference's ``serve_batch(extras=...)``
    (its packed GEMMs through the Pallas kernel); a request without
    ``enc_frames`` is refused at admission with the reference's message;
  * **tolerance**: one QAD step on batches with ``enc_frames``, at
    ``test_torch_rglru.py``'s levels but loss and KL within rtol 1e-2
    (the test's docstring says why).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import ptq, qconfig
from repro_torch.launch import serve, specs
from repro_torch.models import common, get_model, layers, whisper
from repro_torch.serve import Engine
from repro_torch.serve import state as state_mod
from test_torch_rwkv6 import (check_qad_step, jax_packed, jax_qad_step,
                              run_reference)
from test_torch_serve import _flat, _unflat
from test_torch_train import _batch_np

ARCH = "whisper-tiny"
TOL = 5e-2
APPLY_LEN = 12
SLOT_LEN = 9
N_SLOTS, S_ALLOC = 3, 24
ENGINE_LENS = [4, 11]
ENGINE_GEN = 6
PE_SHAPES = ((30, 64), (448, 384), (1500, 384))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(i):
    return np.random.default_rng(80 + i)


def _finite_bf16() -> np.ndarray:
    """Every finite bf16 value, as f32."""
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return x[np.isfinite(x)]


def _frames(cfg, n, i=0):
    return _rng(10 + i).standard_normal((n, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)


def _slot_inputs(cfg):
    """Two prompts with their frames prefilled into slots 0 and 1, then two
    slot decode steps: slot 0 alone, then slots 0 and 1 (slot 2 idle)."""
    rng = _rng(1)
    prompts = [rng.integers(4, cfg.vocab_size, (SLOT_LEN,)).astype(np.int32)
               for _ in range(2)]
    lens = np.asarray([[SLOT_LEN, SLOT_LEN, 0], [SLOT_LEN + 1, SLOT_LEN, 0]],
                      np.int32)
    active = np.asarray([[True, False, False], [True, True, False]])
    toks = rng.integers(4, cfg.vocab_size, (2, N_SLOTS, 1)).astype(np.int32)
    return prompts, _frames(cfg, 2, 1), lens, active, toks


def _engine_inputs(cfg):
    rng = _rng(8)
    prompts = [rng.integers(4, cfg.vocab_size, (n,)).astype(np.int32)
               for n in ENGINE_LENS]
    return prompts, _frames(cfg, len(prompts), 2)


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.qconfig import BF16
    from repro.launch import serve as jserve
    from repro.launch import specs as jspecs
    from repro.models import common as jcommon
    from repro.models import layers as jlayers
    from repro.models import whisper as jwhisper
    from repro.serve import state as jstate

    def f32(a):
        return np.asarray(a).astype(np.float32)

    res = {"gelu": f32(jax.jit(jax.nn.gelu)(
        jnp.asarray(_finite_bf16()).astype(jnp.bfloat16)))}
    for seq, d in PE_SHAPES:
        res[f"pe/{seq}x{d}"] = f32(jax.jit(
            lambda: jlayers.sinusoidal_pos(seq, d))())

    cfg = jconfigs.get_smoke(ARCH)
    dense = jax.jit(lambda r: jwhisper.init_params(cfg, r))(
        jax.random.PRNGKey(0))
    for k, v in _flat(dense).items():
        res[f"params/{k}"] = f32(v)
    frames = jnp.asarray(_frames(cfg, 2))
    toks = jnp.asarray(_rng(0).integers(4, cfg.vocab_size,
                                        (2, APPLY_LEN)).astype(np.int32))
    qc = jspecs.recipe_qconfig(cfg)
    res["encode"] = f32(jax.jit(lambda p, f: jwhisper.encode(cfg, p, f, qc))(
        dense, frames))
    for name, q in (("bf16", BF16), ("nvfp4", qc)):
        res[f"apply/{name}"] = f32(jax.jit(lambda p, t, f: jwhisper.apply(
            cfg, p, {"tokens": t, "enc_frames": f}, q))(dense, toks, frames))

    # the slab path over packed weights: prefill into slots through
    # slab_write, then two decode_step_slots steps
    params = jax_packed(ARCH, whisper, dense)
    sq = dataclasses.replace(qc, weight_format="packed",
                             quantize_weights=False, act_scope="row",
                             packed_backend="dequant")
    prompts, sframes, lens, active, dtoks = _slot_inputs(cfg)
    specs_ = jwhisper.slot_state_specs(cfg, N_SLOTS, S_ALLOC)
    data = jcommon.zeros_from_specs(specs_)
    pre = jax.jit(lambda p, t, f: jwhisper.prefill(
        cfg, p, {"tokens": t, "enc_frames": f}, sq, None))
    write = jax.jit(lambda d, c, slot: jstate.slab_write(specs_, d, c, slot))
    for slot, p in enumerate(prompts):
        lg, cache = pre(params, jnp.asarray(p[None]),
                        jnp.asarray(sframes[slot:slot + 1]))
        res[f"prefill/{slot}"] = f32(lg)
        cache = {k: v for k, v in cache.items() if k != "pos"}
        data = write(data, cache, jnp.asarray(slot, jnp.int32))
    step = jax.jit(lambda p, d, t, l, a: jwhisper.decode_step_slots(
        cfg, p, d, {"tokens": t}, l, a, sq))
    for i in range(2):
        lg, data = step(params, data, jnp.asarray(dtoks[i]),
                        jnp.asarray(lens[i]), jnp.asarray(active[i]))
        res[f"slots/{i}"] = f32(lg)

    # greedy tokens of single-request serve_batch with each request's
    # frames, the packed GEMMs through the Pallas kernel
    bq = dataclasses.replace(qc, weight_format="packed")
    eprompts, eframes = _engine_inputs(cfg)
    for i, p in enumerate(eprompts):
        out, _ = jserve.serve_batch(cfg, params, jnp.asarray(p[None]),
                                    ENGINE_GEN, qcfg=bq,
                                    extras={"enc_frames": eframes[i:i + 1]})
        res[f"serve_batch/{i}"] = np.asarray(out[0])

    toks, labels, mask = _batch_np(cfg.vocab_size)
    jax_qad_step(jwhisper, cfg, dense,
                 {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                  "mask": jnp.asarray(mask),
                  "enc_frames": jnp.asarray(_frames(cfg, 2, 3))}, res)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_whisper_ref") / "ref.npz")
    return run_reference("test_torch_whisper", out)


def _dense(ref):
    cfg = configs.get_smoke(ARCH)
    return cfg, params_from_numpy(_unflat(ref, "params/"), "cpu")


def _packed(ref):
    """(cfg, packed params, recipe qcfg, the engine's serving qcfg)."""
    cfg, dense = _dense(ref)
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format="packed")
    params = ptq.quantize_weights(dense, whisper.param_specs(cfg), qc)
    sq = dataclasses.replace(qc, quantize_weights=False, act_scope="row")
    return cfg, params, qc, sq


def _close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# bitwise: gelu; tolerance: the sinusoidal table
# ---------------------------------------------------------------------------


def test_gelu_bitwise_on_every_finite_bf16(ref):
    """Bitwise: ``layers.gelu`` is the jitted ``jax.nn.gelu`` on all 65280
    finite bf16 values, the signs of zeros included."""
    x = torch.from_numpy(_finite_bf16()).to(torch.bfloat16)
    got = layers.gelu(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  ref["gelu"].view(np.uint32))


def test_gelu_mlp_uses_gelu(monkeypatch):
    """``gelu_mlp`` applies ``layers.gelu`` (not ``F.gelu``) between its two
    GEMMs, bitwise as composed by hand."""
    rng = _rng(4)
    x, wi, wd = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(torch.bfloat16) for s in ((2, 3, 16), (16, 32), (32, 16)))
    want = layers.qdense(qconfig.BF16, "mlp",
                         layers.gelu(layers.qdense(qconfig.BF16, "mlp", x, wi)),
                         wd)
    calls = []
    gelu = layers.gelu
    monkeypatch.setattr(layers, "gelu", lambda t: calls.append(1) or gelu(t))
    got = layers.gelu_mlp(qconfig.BF16, x, wi, wd)
    assert calls == [1] and torch.equal(got, want)


@pytest.mark.parametrize("seq,d", PE_SHAPES)
def test_sinusoidal_pos_matches_reference(ref, seq, d):
    """Tolerance (f32): within 2^-21 of the largest angle (``seq``)."""
    got = layers.sinusoidal_pos(seq, d)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[f"pe/{seq}x{d}"], rtol=0,
                               atol=2.0 ** -21 * seq)


# ---------------------------------------------------------------------------
# tolerance: forwards against the jitted reference
# ---------------------------------------------------------------------------


def test_encode_matches_reference(ref):
    """Tolerance: the encoder's output on 30 frames under the NVFP4
    recipe (non-causal attention, sinusoidal positions on the frames)."""
    cfg, dense = _dense(ref)
    with torch.no_grad():
        got = whisper.encode(cfg, dense, torch.from_numpy(_frames(cfg, 2)),
                             specs.recipe_qconfig(cfg))
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    _close(got, ref["encode"])


@pytest.mark.parametrize("name", ["bf16", "nvfp4"])
def test_apply_logits_match(ref, name):
    """Tolerance: teacher-forcing logits, the BF16 teacher and the NVFP4
    student (fake-quantized at run time)."""
    cfg, dense = _dense(ref)
    qc = {"bf16": qconfig.BF16, "nvfp4": specs.recipe_qconfig(cfg)}[name]
    toks = torch.from_numpy(_rng(0).integers(4, cfg.vocab_size,
                                             (2, APPLY_LEN))).long()
    with torch.no_grad():
        got = whisper.apply(cfg, dense, {"tokens": toks, "enc_frames":
                                         torch.from_numpy(_frames(cfg, 2))}, qc)
    assert got.shape == (2, APPLY_LEN, cfg.vocab_size)
    _close(got, ref[f"apply/{name}"])


def test_prefill_and_slot_decode_logits_match(ref):
    """Tolerance: two prompts with their frames prefilled into slots 0 and
    1 through ``slab_write`` (the self-KV padded to the slab, ``enc_out``
    placed), then two slot decode steps; slot 2, idle, stays zero."""
    cfg, params, _, sq = _packed(ref)
    prompts, frames, lens, active, dtoks = _slot_inputs(cfg)
    sp = whisper.slot_state_specs(cfg, N_SLOTS, S_ALLOC)
    data = common.zeros_from_specs(sp, "cpu")
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            lg, cache = whisper.prefill(
                cfg, params, {"tokens": torch.from_numpy(p[None]).long(),
                              "enc_frames": torch.from_numpy(frames[slot:slot + 1])},
                sq)
            _close(lg, ref[f"prefill/{slot}"])
            cache.pop("pos")
            data = state_mod.slab_write(sp, data, cache, slot)
        for i in range(2):
            lg, data = whisper.decode_step_slots(
                cfg, params, data, {"tokens": torch.from_numpy(dtoks[i]).long()},
                torch.from_numpy(lens[i]), torch.from_numpy(active[i]), sq)
            rows = active[i]
            _close(lg[rows], ref[f"slots/{i}"][rows])
    for leaf, spec in zip(common.tree_leaves(data), common.tree_leaves(sp)):
        assert not leaf.narrow(spec.axes.index("batch"), 2, 1).any()


# ---------------------------------------------------------------------------
# greedy tokens: the slab engine with per-request frames
# ---------------------------------------------------------------------------


def test_slab_engine_matches_reference_serve_batch(ref):
    """Greedy tokens: two requests of 4 and 11 tokens, each with its own
    ``enc_frames``, the second arriving a step later, over 2 slots on the
    plan dense_kv + encoder_output (the slots at other positions in every
    decode step); each equals the reference's ``serve_batch(extras=...)``
    and the port's; every slot is released; a slot holds its self-KV and
    ``enc_out``."""
    cfg, params, qc, _ = _packed(ref)
    prompts, frames = _engine_inputs(cfg)
    eng = Engine(cfg, params, qc, n_slots=2, block_size=8,
                 max_blocks_per_slot=3, device="cpu")
    assert eng.state_plan == ("dense_kv", "encoder_output")
    assert eng.state.required_extras == ("enc_frames",)
    rids, outs = serve.run_workload(eng, prompts, ENGINE_GEN,
                                    [{"enc_frames": f} for f in frames])
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        np.testing.assert_array_equal(outs[rid], ref[f"serve_batch/{i}"])
        toks, _ = serve.serve_batch(cfg, params,
                                    torch.from_numpy(p[None]).long(),
                                    ENGINE_GEN, qcfg=qc,
                                    extras={"enc_frames": frames[i:i + 1]})
        np.testing.assert_array_equal(outs[rid], toks[0].numpy())
    st = eng.stats()
    assert eng.pool is None and not eng.state.leaked()
    assert st["state_dense_bound"] == 24
    assert st["state_bytes_per_slot"] == 2 * (
        2 * cfg.n_layers * 24 * cfg.n_kv_heads * cfg.head_dim
        + cfg.enc_seq * cfg.d_model)


def test_engine_refuses_a_request_without_frames(ref):
    """A request with no ``enc_frames`` is refused when it is submitted,
    with the reference's message; one with them is taken."""
    cfg, params, qc, _ = _packed(ref)
    eng = Engine(cfg, params, qc, n_slots=2, block_size=8,
                 max_blocks_per_slot=3, device="cpu")
    prompt = np.arange(4, 9, dtype=np.int32)
    for extras in (None, {"other": np.zeros(3)}):
        with pytest.raises(ValueError, match=r"request needs "
                           r"extras\['enc_frames'\] \(encoder-conditioned arch\)"):
            eng.submit(prompt, 4, extras=extras)
    eng.submit(prompt, 4, extras={"enc_frames": _frames(cfg, 1)[0]})
    eng.drain(max_steps=20)
    assert not eng.state.leaked() and len(eng.outputs()) == 1


# ---------------------------------------------------------------------------
# tolerance: one QAD step
# ---------------------------------------------------------------------------


def test_qad_step_matches_reference(ref):
    """Tolerance (``test_torch_rwkv6.check_qad_step``): one QAD step on
    the smoke config, each sequence with its encoder frames, loss and KL
    within rtol 1e-2.  The student's NVFP4 forward is bitwise the
    reference's here; the BF16 teacher's is not: its GEMMs sum bf16
    products in torch's order (one value in 3840 of the first encoder
    layer moves by an ulp, the logits by 0.0059 at most), and the KL
    between two nearly equal models (4.7e-4) moves by 1.3e-6, 2.8e-3 of
    itself (measured)."""
    cfg, dense = _dense(ref)
    assert get_model(cfg) is whisper
    toks, labels, mask = _batch_np(cfg.vocab_size)
    check_qad_step(cfg, dense, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long(),
        "mask": torch.from_numpy(mask),
        "enc_frames": torch.from_numpy(_frames(cfg, 2, 3))}, ref, kl_rtol=1e-2)
