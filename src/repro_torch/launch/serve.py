"""Batched greedy serving over NVFP4 weights (port of
``repro.launch.serve``'s static-batch path).

Offline weight PTQ (fake-quantized BF16 or true-packed 4-bit) + prefill +
greedy decode.  With ``--weight-format packed`` every 2-D quantized GEMM
runs the ``nvfp4_matmul`` CUDA kernel and every GEMM input the
``nvfp4_qdq`` kernel.  Full size on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
        --arch acereason-7b --weight-format packed

In packed mode the CLI also replays the batch over the QDQ weights made
from the same seed and reports whether the greedy tokens agree
(``--no-parity`` skips it).  ``--device cpu`` runs the plain versions of
the kernels, at smoke size.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs
from ..core import ptq
from ..models import common, get_model
from . import specs


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_quantized(cfg, seed: int = 0, weight_format: str = "qdq",
                   device="cuda"):
    """Deploy-time weights: random BF16 init from ``seed``, then one-shot
    PTQ.  Returns (params, qcfg)."""
    device = resolve_device(device)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    qcfg = dataclasses.replace(specs.recipe_qconfig(cfg),
                               weight_format=weight_format)
    with torch.no_grad():
        params = model.init_params(cfg, gen, device)
        return ptq.quantize_weights(params, model.param_specs(cfg), qcfg), qcfg


def serve_batch(cfg, params, prompts: torch.Tensor, n_gen: int, qcfg=None):
    """Prefill + greedy decode ``n_gen`` tokens for a [B, P] prompt batch.

    ``qcfg`` overrides the recipe's serving config; serving never
    fake-quantizes weights at run time (they are quantized offline).
    Returns (tokens [B, n_gen], stats).
    """
    device = resolve_device(prompts.device)
    model = get_model(cfg)
    sq = (dataclasses.replace(qcfg, quantize_weights=False)
          if qcfg is not None else specs.serve_qconfig(cfg))
    s_max = prompts.shape[1] + n_gen
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(cfg, params, {"tokens": prompts}, sq,
                                      s_max=s_max)
        out = [torch.argmax(logits[:, -1:], -1)]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_gen - 1):
            logits, cache = model.decode_step(cfg, params, cache,
                                              {"tokens": out[-1]}, sq)
            out.append(torch.argmax(logits[:, -1:], -1))
        _sync(device)
        t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, 1)
    # n_gen tokens come back; the first is taken from the prefill logits, so
    # decode_tok_s rates the n_gen - 1 decode steps alone
    b = prompts.shape[0]
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode,
                    "decode_steps": n_gen - 1, "n_tokens": b * n_gen,
                    "decode_tok_s": b * (n_gen - 1) / max(t_decode, 1e-9),
                    "e2e_tok_s": b * n_gen / max(t_prefill + t_decode, 1e-9)}


def weight_report(params) -> dict:
    """Deployed weight footprint; packed GEMM weights cost 0.5625 B/param."""
    st = common.weight_stats(params)
    st["q_bytes_per_param"] = (st["q_bytes"] / st["q_params"]
                               if st["q_params"] else 0.0)
    return st


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (--no-smoke = full size)")
    ap.add_argument("--weight-format", choices=("qdq", "packed"),
                    default="qdq")
    ap.add_argument("--parity", action=argparse.BooleanOptionalAction,
                    default=None, help="packed mode: also serve the QDQ "
                    "weights and compare greedy tokens (default: on)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    params, _ = load_quantized(cfg, args.seed, args.weight_format, device)
    wr = weight_report(params)
    if wr["q_params"]:
        print(f"[serve] weights: total={wr['total_bytes']/2**20:.2f}MiB  "
              f"quantized-gemm={wr['q_bytes']/2**20:.2f}MiB over "
              f"{wr['q_params']/1e6:.2f}M params "
              f"({wr['q_bytes_per_param']:.4f} B/param; bf16 would be 2.0)")
    else:
        print(f"[serve] weights: total={wr['total_bytes']/2**20:.2f}MiB, "
              f"all dense (qdq stores quantized values as BF16, 2 B/param)")

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(4, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    toks, stats = serve_batch(cfg, params, prompts, args.gen)
    print(f"[serve] arch={cfg.name} device={device} batch={args.batch} "
          f"format={args.weight_format} "
          f"prefill={stats['prefill_s']*1e3:.1f}ms "
          f"decode={stats['decode_tok_s']:.1f} tok/s "
          f"e2e={stats['e2e_tok_s']:.1f} tok/s")
    print("[serve] sample:", toks[0, :12].tolist())

    result = {"tokens": toks, "stats": stats, "weights": wr}
    parity = (args.weight_format == "packed"
              if args.parity is None else args.parity)
    if parity and args.weight_format != "packed":
        print("[serve] --parity only applies to --weight-format packed; "
              "nothing to compare")
    elif parity:
        del params
        qdq_params, _ = load_quantized(cfg, args.seed, "qdq", device)
        ref_toks, _ = serve_batch(cfg, qdq_params, prompts, args.gen)
        match = bool(torch.equal(toks, ref_toks))
        print(f"[serve] packed-vs-qdq greedy tokens "
              f"{'AGREE' if match else 'DISAGREE'}")
        result["tokens_match_qdq"] = match
    return result


if __name__ == "__main__":
    main()
