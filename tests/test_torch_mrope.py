"""M-RoPE (Qwen2-VL) in the PyTorch port against the JAX package, on the
CPU: ``layers.apply_mrope``, the decoder's ``pos3`` positions and
``vis_embeds`` splice through ``apply``, ``prefill`` and ``decode_step``,
QAD on a VLM batch, and the engine's refusal.

The model tests run ``qwen2-vl-2b-smoke`` with ``d_head=32`` ("the
sectioned smoke config"): the smoke config's head of 16 has 8 frequency
slots, which its sections (8, 4, 4) fill with the t stream alone (the
reference's ``jnp.repeat(..., total_repeat_length=8)`` drops the rest),
so the h and w streams would never be read.  At 32 the 16 slots split
8 / 4 / 4.  The batches follow Qwen2-VL's layout: text before the image
at t = h = w = i, a 2 x 3 patch grid at t = start, h = start + row,
w = start + column, text after it from the largest position + 1.

The reference runs once in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false`` (``test_torch_rwkv6.run_reference``).

Parity levels, as each test names them:

  * **tolerance** (f32): ``apply_mrope`` with three different position
    streams, within 4 f32 ulps of |x| (XLA's sin and cos are not
    torch's), at sections filling 16 and 64 slots and truncated to 8;
    **bitwise** (port only): with three equal streams it is
    ``apply_rope``;
  * **tolerance**: ``apply`` logits (BF16 and NVFP4), then ``prefill`` of
    9 tokens and 3 ``decode_step``s with their ``pos3`` over packed
    weights (the reference's Pallas kernel), rtol = atol = 5e-2
    (``test_torch_rglru.py``'s level);
  * **tolerance**: NVFP4 activations at per-token scales over packed
    weights, a 48-token batch with a 4 x 4 grid: prefill of 40 and 8
    ``decode_step``s within 5e-2 relative L2 of the reference's, step by
    step; their gap to teacher-forcing ``apply`` (0.13-0.23 relative L2
    at this size) is the reference's own gap to within 0.02;
  * **tolerance**: one QAD step on VLM batches, at
    ``test_torch_rglru.py``'s levels;
  * the CLI's ``--engine`` refusal is one line naming ``vision_prefix``.
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
from repro_torch.core import ptq, qconfig
from repro_torch.launch import specs
from repro_torch.models import decoder, get_model, layers
from test_torch_rwkv6 import (check_qad_step, jax_packed, jax_qad_step,
                              run_reference)
from test_torch_serve import _flat, _unflat
from test_torch_train import _batch_np

ARCH = "qwen2-vl-2b"
TOL = 5e-2
SEQ, PROMPT = 12, 9
# the decode-against-teacher-forcing case: a 4 x 4 grid in 48 tokens,
# prefill of 40, then 8 decode steps
TF_SEQ, TF_PROMPT = 48, 40
ROPE_CASES = ((32, (8, 4, 4)), (128, (16, 24, 24)), (16, (8, 4, 4)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (long chains of small torch ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(i):
    return np.random.default_rng(90 + i)


def sectioned(cfg):
    """The smoke config with a head of 32, so that every section is read."""
    return dataclasses.replace(cfg, d_head=32)


def vlm_positions(n: int, start: int, rows: int, cols: int) -> np.ndarray:
    """Qwen2-VL's (t, h, w) ids [n, 3] for ``n`` tokens with a ``rows`` x
    ``cols`` patch grid at ``start``: text before it at t = h = w = i, the
    grid at t = start, h = start + row, w = start + col, text after it
    from the largest position + 1."""
    pos = np.zeros((n, 3), np.int32)
    pos[:start] = np.arange(start)[:, None]
    g = np.arange(rows * cols)
    pos[start:start + g.size] = np.stack(
        [np.full(g.size, start), start + g // cols, start + g % cols], 1)
    after = np.arange(n - start - g.size) + start + max(rows, cols)
    pos[start + g.size:] = after[:, None]
    return pos


def _batch(cfg, n=SEQ, b=2):
    """tokens, vis_mask, vis_embeds and pos3 of ``b`` sequences of ``n``
    tokens, one 2 x 3 grid each (at 2 and at 3)."""
    rng = _rng(n)
    toks = rng.integers(4, cfg.vocab_size, (b, n)).astype(np.int32)
    mask = np.zeros((b, n), bool)
    pos3 = np.zeros((b, n, 3), np.int32)
    for i in range(b):
        start = 2 + i
        mask[i, start:start + 6] = True
        pos3[i] = vlm_positions(n, start, 2, 3)
    vis = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
    return {"tokens": toks, "vis_mask": mask, "vis_embeds": vis, "pos3": pos3}


def _tf_batch(cfg, b=2):
    """``b`` sequences of TF_SEQ tokens, a 4 x 4 grid each (at 3 and 8)."""
    rng = _rng(TF_SEQ)
    toks = rng.integers(4, cfg.vocab_size, (b, TF_SEQ)).astype(np.int32)
    mask = np.zeros((b, TF_SEQ), bool)
    pos3 = np.zeros((b, TF_SEQ, 3), np.int32)
    for i in range(b):
        start = 3 + 5 * i
        mask[i, start:start + 16] = True
        pos3[i] = vlm_positions(TF_SEQ, start, 4, 4)
    vis = rng.standard_normal((b, TF_SEQ, cfg.d_model)).astype(np.float32)
    return {"tokens": toks, "vis_mask": mask, "vis_embeds": vis, "pos3": pos3}


def _rope_inputs(hd):
    rng = _rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos3 = np.stack([rng.integers(0, 50, (2, 7)), rng.integers(50, 90, (2, 7)),
                     rng.integers(90, 130, (2, 7))], -1).astype(np.int32)
    return x, pos3


def _reference(out_path: str) -> None:
    """Every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.qconfig import BF16
    from repro.launch import specs as jspecs
    from repro.models import decoder as jdecoder
    from repro.models import layers as jlayers

    def f32(a):
        return np.asarray(a).astype(np.float32)

    res = {}
    for hd, sec in ROPE_CASES:
        x, pos3 = _rope_inputs(hd)
        res[f"mrope/{hd}"] = f32(jax.jit(lambda a, p: jlayers.apply_mrope(
            a, p, 1e4, sec))(x, pos3))

    cfg = sectioned(jconfigs.get_smoke(ARCH))
    dense = jax.jit(lambda r: jdecoder.init_params(cfg, r))(
        jax.random.PRNGKey(0))
    for k, v in _flat(dense).items():
        res[f"params/{k}"] = f32(v)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    qc = jspecs.recipe_qconfig(cfg)
    for name, q in (("bf16", BF16), ("nvfp4", qc)):
        res[f"apply/{name}"] = f32(jax.jit(
            lambda p, b: jdecoder.apply(cfg, p, b, q))(dense, batch))

    # prefill of the first PROMPT tokens, then decode_step with pos3
    params = jax_packed(sectioned(configs.get_smoke(ARCH)), decoder, dense)
    sq = dataclasses.replace(qc, weight_format="packed",
                             quantize_weights=False)
    head = {k: v[:, :PROMPT] for k, v in batch.items()}
    lg, cache = jax.jit(lambda p, b: jdecoder.prefill(cfg, p, b, sq,
                                                      s_max=SEQ))(params, head)
    res["prefill"] = f32(lg)
    step = jax.jit(lambda p, c, b: jdecoder.decode_step(cfg, p, c, b, sq))
    for i in range(PROMPT, SEQ):
        lg, cache = step(params, cache, {"tokens": batch["tokens"][:, i:i + 1],
                                         "pos3": batch["pos3"][:, i:i + 1]})
        res[f"decode/{i}"] = f32(lg)

    # NVFP4 activations at per-token scales: apply against prefill + decode
    tq = dataclasses.replace(sq, act_scope="token")
    tb = {k: jnp.asarray(v) for k, v in _tf_batch(cfg).items()}
    res["tf/apply"] = f32(jax.jit(
        lambda p, b: jdecoder.apply(cfg, p, b, tq))(params, tb))
    lg, cache = jax.jit(lambda p, b: jdecoder.prefill(cfg, p, b, tq,
                                                      s_max=TF_SEQ))(
        params, {k: v[:, :TF_PROMPT] for k, v in tb.items()})
    step = jax.jit(lambda p, c, b: jdecoder.decode_step(cfg, p, c, b, tq))
    for i in range(TF_PROMPT, TF_SEQ):
        lg, cache = step(params, cache, {"tokens": tb["tokens"][:, i:i + 1],
                                         "pos3": tb["pos3"][:, i:i + 1]})
        res[f"tf/decode/{i}"] = f32(lg)

    toks, labels, mask = _batch_np(cfg.vocab_size)
    vb = _batch(cfg, toks.shape[1])
    jax_qad_step(jdecoder, cfg, dense,
                 {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                  "mask": jnp.asarray(mask),
                  **{k: jnp.asarray(vb[k])
                     for k in ("vis_mask", "vis_embeds", "pos3")}}, res)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_mrope_ref") / "ref.npz")
    return run_reference("test_torch_mrope", out)


def _dense(ref):
    cfg = sectioned(configs.get_smoke(ARCH))
    return cfg, params_from_numpy(_unflat(ref, "params/"), "cpu")


def _torch_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]).long(),
            "vis_mask": torch.from_numpy(b["vis_mask"]),
            "vis_embeds": torch.from_numpy(b["vis_embeds"]),
            "pos3": torch.from_numpy(b["pos3"]).long()}


def _close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# apply_mrope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,sections", ROPE_CASES)
def test_apply_mrope_matches_reference(ref, hd, sections):
    """Tolerance (f32): t, h and w streams in disjoint ranges, so a slot
    reading the wrong stream would be off by whole radians; within 4 f32
    ulps of |x| (sin and cos of angles up to 130)."""
    x, pos3 = _rope_inputs(hd)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e4, sections)
    want = ref[f"mrope/{hd}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -23 * 130 * np.abs(x).max())
    # the streams matter: rotating every slot by the t stream alone is far
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[..., 0]),
                             1e4)
    if hd != 16:       # 16: the sections' t part fills all 8 slots
        assert np.abs(rope.numpy() - want).max() > 0.1


def test_apply_mrope_with_equal_streams_is_rope():
    """Bitwise: with t = h = w M-RoPE is RoPE, at every section split."""
    x, pos3 = _rope_inputs(32)
    p = torch.from_numpy(pos3[..., 0]).long()
    for sections in ((8, 4, 4), (16, 0, 0), (2, 2, 12)):
        got = layers.apply_mrope(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.stack([p, p, p], -1), 1e4, sections)
        want = layers.apply_rope(torch.from_numpy(x).to(torch.bfloat16), p, 1e4)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the decoder with pos3 and vis_embeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bf16", "nvfp4"])
def test_apply_logits_match(ref, name):
    """Tolerance: teacher-forcing logits of two VLM sequences (the patch
    embeddings spliced over the grid's tokens, pos3 in Qwen2-VL's
    layout), the BF16 teacher and the NVFP4 student."""
    cfg, dense = _dense(ref)
    qc = {"bf16": qconfig.BF16, "nvfp4": specs.recipe_qconfig(cfg)}[name]
    with torch.no_grad():
        got = decoder.apply(cfg, dense, _torch_batch(_batch(cfg)), qc)
    assert got.shape == (2, SEQ, cfg.vocab_size)
    _close(got, ref[f"apply/{name}"])


def test_vis_embeds_are_spliced_where_the_mask_is_set(ref):
    """The embedding the layers see: the patch embedding under the mask,
    the token's elsewhere; without ``vis_embeds`` the tokens' alone."""
    cfg, dense = _dense(ref)
    b = _torch_batch(_batch(cfg))
    x = decoder._embed_inputs(cfg, dense, b)
    m = b["vis_mask"]
    assert torch.equal(x[m], b["vis_embeds"].to(torch.bfloat16)[m])
    assert torch.equal(x[~m], dense["embed"][b["tokens"]][~m])
    plain = {k: b[k] for k in ("tokens", "pos3")}
    assert torch.equal(decoder._embed_inputs(cfg, dense, plain),
                       dense["embed"][b["tokens"]])


def test_prefill_and_decode_with_pos3_match(ref):
    """Tolerance: over packed weights, ``prefill`` of the first 9 tokens
    (the grid inside them) and three ``decode_step``s fed their tokens and
    pos3 [B, 1, 3]."""
    cfg, dense = _dense(ref)
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format="packed")
    params = ptq.quantize_weights(dense, decoder.param_specs(cfg), qc)
    sq = dataclasses.replace(qc, quantize_weights=False)
    b = _torch_batch(_batch(cfg))
    with torch.inference_mode():
        lg, cache = decoder.prefill(cfg, params,
                                    {k: v[:, :PROMPT] for k, v in b.items()},
                                    sq, s_max=SEQ)
        _close(lg, ref["prefill"])
        for i in range(PROMPT, SEQ):
            lg, cache = decoder.decode_step(
                cfg, params, cache, {"tokens": b["tokens"][:, i:i + 1],
                                     "pos3": b["pos3"][:, i:i + 1]}, sq)
            _close(lg, ref[f"decode/{i}"])
    assert cache["pos"] == SEQ


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_nvfp4_decode_gap_to_teacher_forcing_is_the_references(ref):
    """ROADMAP C.1 (a): NVFP4 activations at per-token scales over packed
    weights.  The port's prefill + decode logits equal the reference's
    step by step (tolerance 5e-2 relative L2; measured 0 on the CPU), and
    the gap of each package's decode to its own teacher-forcing ``apply``
    is the same (within 0.02): the decode attention's other order of sums
    (one query against the cache, p normalised before its bf16 rounding)
    moves a few activations across an E2M1 rounding point, in both."""
    cfg, dense = _dense(ref)
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format="packed")
    params = ptq.quantize_weights(dense, decoder.param_specs(cfg), qc)
    tq = dataclasses.replace(qc, quantize_weights=False, act_scope="token")
    b = _torch_batch(_tf_batch(cfg))
    with torch.inference_mode():
        tf = decoder.apply(cfg, params, b, tq).float().numpy()
        _, cache = decoder.prefill(
            cfg, params, {k: v[:, :TF_PROMPT] for k, v in b.items()}, tq,
            s_max=TF_SEQ)
        gaps = []
        for i in range(TF_PROMPT, TF_SEQ):
            lg, cache = decoder.decode_step(
                cfg, params, cache, {"tokens": b["tokens"][:, i:i + 1],
                                     "pos3": b["pos3"][:, i:i + 1]}, tq)
            got, want = lg.float().numpy()[:, 0], ref[f"tf/decode/{i}"][:, 0]
            assert _rel(got, want) <= TOL, i
            gaps.append((_rel(got, tf[:, i]), _rel(want, ref["tf/apply"][:, i])))
    gaps = np.asarray(gaps)
    assert np.abs(gaps[:, 0] - gaps[:, 1]).max() <= 0.02, gaps
    assert gaps.max() < 0.5, gaps        # LOGIT_TOL["nvfp4"] in chip_smoke


def test_paged_forwards_refuse_pos3_less_positions():
    """The paged and slab forwards pass [B] or [B, S] positions, which an
    M-RoPE config refuses rather than rotating every slot by one stream."""
    cfg = sectioned(configs.get_smoke(ARCH))
    x = torch.zeros((1, 1, cfg.n_heads, cfg.head_dim))
    with pytest.raises(ValueError, match=r"pos3 \[B, S, 3\]"):
        decoder._rope(cfg, x, torch.zeros((1, 1), dtype=torch.long))


# ---------------------------------------------------------------------------
# QAD on the VLM, and the engine's refusal
# ---------------------------------------------------------------------------


def test_qad_step_matches_reference(ref):
    """Tolerance (``test_torch_rwkv6.check_qad_step``): one QAD step on
    VLM batches (pos3 and a patch grid per sequence)."""
    cfg, dense = _dense(ref)
    assert get_model(cfg) is decoder
    toks, labels, mask = _batch_np(cfg.vocab_size)
    vb = _torch_batch(_batch(cfg, toks.shape[1]))
    check_qad_step(cfg, dense, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long(),
        "mask": torch.from_numpy(mask),
        **{k: vb[k] for k in ("vis_mask", "vis_embeds", "pos3")}}, ref)


def test_cli_engine_refuses_in_one_line():
    """``--arch qwen2-vl-2b --engine`` exits 1 with one line on stderr,
    ``[serve] unsupported: ... vision_prefix``, and no traceback."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--weight-format", "packed", "--engine"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    err = proc.stderr.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("[serve] unsupported: "), err
    assert "vision_prefix" in err[0] and "Traceback" not in proc.stderr
