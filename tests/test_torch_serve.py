"""Serving slice of the PyTorch port against the JAX package, on the CPU.

The reference runs in a subprocess with ``XLA_FLAGS=
--xla_allow_excess_precision=false``: XLA then rounds every bf16 operation
as the reference's program is written.  With XLA's default the compiled
reference keeps some bf16 intermediates (the in-layer residual, a fused
activation ahead of its QDQ) in f32, a choice that depends on fusion; on a
random-init smoke model the NVFP4 rounding amplifies those few ulps until
greedy tokens part.  The port computes the program as written, including
the one rewrite XLA makes either way (a division by a constant becomes a
multiplication by its f32 reciprocal, see ``core/nvfp4.compute_scales``).

Parameters come from the reference's ``init_params`` through
``bridge.params_from_numpy``; the port quantizes them with its own PTQ
(bitwise equal to the reference's, ``test_torch_nvfp4.py``).

Parity levels: **tolerance** for logits, rtol = atol = 1e-2 (the
reference's own cross-path tolerance, ``tests/test_packed_serve.py``):
bf16 rounding and f32 summation order may differ (the packed matmul's plain
version sums in another order than the Pallas kernel); **greedy tokens**
equal for ``serve_batch`` in both weight formats.
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
from repro_torch.core import nvfp4, ptq, qconfig
from repro_torch.kernels import ops
from repro_torch.launch import serve, specs
from repro_torch.models import get_model

ARCHS = ["qwen1.5-0.5b", "acereason-7b"]
RTOL = ATOL = 1e-2
N_DECODE = 3
# JAX packed serving: qwen through the Pallas kernel (interpret mode),
# acereason through the dequant backend, which is cheaper on the CPU
PACKED_BACKEND = {"qwen1.5-0.5b": "auto", "acereason-7b": "dequant"}
GEN = {"qdq": 6, "packed": 4}


def _apply_tokens(vocab):
    return np.random.default_rng(1).integers(4, vocab, (2, 16)).astype(np.int32)


def _prompts(vocab):
    return np.random.default_rng(2).integers(4, vocab, (2, 8)).astype(np.int32)


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


def _reference(out_path: str) -> None:
    """Compute every reference output (runs in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import qconfig as jq
    from repro.launch import serve as jserve
    from repro.launch import specs as jspecs
    from repro.models import get_model as jget_model

    res = {}
    for arch in ARCHS:
        cfg = jconfigs.get_smoke(arch)
        model = jget_model(cfg)
        dense = model.init_params(cfg, jax.random.PRNGKey(0))
        for k, v in _flat(dense).items():
            res[f"{arch}/params/{k}"] = np.asarray(v.astype(jnp.float32))
        toks = jnp.asarray(_apply_tokens(cfg.vocab_size))
        for name, qc in (("bf16", jq.BF16), ("nvfp4", jq.NVFP4_ALL)):
            fwd = jax.jit(lambda p, t: model.apply(cfg, p, {"tokens": t}, qc))
            res[f"{arch}/apply/{name}"] = np.asarray(
                fwd(dense, toks).astype(jnp.float32))
        prompts = jnp.asarray(_prompts(cfg.vocab_size))
        for fmt in ("qdq", "packed"):
            params, _ = jserve.load_quantized(cfg, jax.random.PRNGKey(0), fmt)
            sq = jspecs.serve_qconfig(cfg)
            if fmt == "packed":
                sq = dataclasses.replace(sq, packed_backend=PACKED_BACKEND[arch])
            logits, cache = jax.jit(lambda p, b: model.prefill(
                cfg, p, b, sq, s_max=12))(params, {"tokens": prompts})
            step = jax.jit(lambda p, c, b: model.decode_step(cfg, p, c, b, sq))
            steps = [logits]
            for _ in range(N_DECODE):
                nxt = jnp.argmax(steps[-1][:, -1:], -1).astype(jnp.int32)
                logits, cache = step(params, cache, {"tokens": nxt})
                steps.append(logits)
            res[f"{arch}/steps/{fmt}"] = np.stack(
                [np.asarray(s.astype(jnp.float32)) for s in steps])
            toks_out, _ = jserve.serve_batch(cfg, params, prompts, GEN[fmt],
                                             qcfg=sq)
            res[f"{arch}/tokens/{fmt}"] = np.asarray(toks_out)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    out = str(tmp_path_factory.mktemp("jax_ref") / "ref.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(here, "..", "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_serve as t; t._reference({out!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _port(ref, arch, fmt=None):
    """(cfg, params): the reference's init bridged, then the port's PTQ."""
    cfg = configs.get_smoke(arch)
    dense = params_from_numpy(_unflat(ref, f"{arch}/params/"), "cpu")
    if fmt is None:
        return cfg, dense
    qc = dataclasses.replace(specs.recipe_qconfig(cfg), weight_format=fmt)
    return cfg, ptq.quantize_weights(dense, get_model(cfg).param_specs(cfg), qc)


def _close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["bf16", "nvfp4"])
def test_apply_logits_match(ref, arch, name):
    """Teacher-forcing logits: the BF16 teacher and the NVFP4 student
    (weights and activations fake-quantized at run time)."""
    cfg, dense = _port(ref, arch)
    qc = {"bf16": qconfig.BF16, "nvfp4": qconfig.NVFP4_ALL}[name]
    toks = torch.from_numpy(_apply_tokens(cfg.vocab_size)).long()
    with torch.no_grad():
        got = get_model(cfg).apply(cfg, dense, {"tokens": toks}, qc)
    assert got.dtype == torch.bfloat16
    _close(got, ref[f"{arch}/apply/{name}"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", ["qdq", "packed"])
def test_prefill_decode_logits_match(ref, arch, fmt):
    """prefill + decode_step logits, fed the reference's greedy tokens."""
    cfg, params = _port(ref, arch, fmt)
    model = get_model(cfg)
    sq = specs.serve_qconfig(cfg)
    want = ref[f"{arch}/steps/{fmt}"]
    prompts = torch.from_numpy(_prompts(cfg.vocab_size)).long()
    with torch.inference_mode():
        logits, cache = model.prefill(cfg, params, {"tokens": prompts}, sq,
                                      s_max=12)
        _close(logits, want[0])
        for i in range(N_DECODE):
            nxt = torch.from_numpy(want[i][:, -1:].argmax(-1)).long()
            logits, cache = model.decode_step(cfg, params, cache,
                                              {"tokens": nxt}, sq)
            _close(logits, want[i + 1])
    assert cache["pos"] == 8 + N_DECODE


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", ["qdq", "packed"])
def test_serve_batch_tokens_equal(ref, arch, fmt):
    """The acceptance path: greedy tokens equal to the reference's."""
    cfg, params = _port(ref, arch, fmt)
    prompts = torch.from_numpy(_prompts(cfg.vocab_size)).long()
    toks, stats = serve.serve_batch(cfg, params, prompts, GEN[fmt])
    np.testing.assert_array_equal(toks.numpy(), ref[f"{arch}/tokens/{fmt}"])
    assert stats["decode_steps"] == GEN[fmt] - 1
    if fmt == "packed":
        wr = serve.weight_report(params)
        assert abs(wr["q_bytes_per_param"] - nvfp4.BYTES_PER_ELEM) < 0.02


def test_serve_cli_packed_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` (smoke): packed
    and QDQ weights from one seed give the same greedy tokens."""
    ops.reset_launches()
    res = serve.main(["--arch", "acereason-7b", "--device", "cpu",
                      "--weight-format", "packed", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    assert res["tokens_match_qdq"] is True
    assert tuple(res["tokens"].shape) == (2, 4)
    assert "AGREE" in capsys.readouterr().out
    # the CPU path runs the plain versions: no kernel was launched
    assert ops.launches == {"nvfp4_qdq": 0, "nvfp4_matmul": 0}


def test_serve_cli_flags_parse():
    args = serve.build_parser().parse_args(
        ["--no-smoke", "--arch", "acereason-7b", "--weight-format", "packed"])
    assert (args.smoke, args.device, args.weight_format) == (False, "cuda",
                                                             "packed")
