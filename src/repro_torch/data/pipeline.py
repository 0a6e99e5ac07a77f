"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

The same multi-domain corpus as the reference, with the same disjoint
sub-vocabularies and the same laws:

  * ``math``  - arithmetic progressions with a per-sequence stride,
  * ``code``  - tokens that follow a clipped random-walk depth,
  * ``prose`` - a bigram chain re-seeded per sequence,
  * ``random``- uniform tokens,

each position following its law with probability ``structure`` and
domain noise otherwise.  Every batch is a pure function of
``(seed, step, host_slice)``.  The random numbers come from a
``torch.Generator`` on the CPU seeded from that tuple, and the batch is
then moved to the device; ``jax.random`` streams cannot be reproduced, so
the values differ from the reference's while the structure is the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DOMAINS = ("math", "code", "prose")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    domains: tuple = DOMAINS           # which domains this run draws from
    # fraction of positions that follow the domain's law; the rest is noise
    structure: float = 0.75


def _domain_spans(vocab: int) -> dict:
    """Disjoint sub-vocabularies per domain (tokens 0..3 are special)."""
    usable = vocab - 4
    third = usable // 3
    return {"math": (4, 4 + third),
            "code": (4 + third, 4 + 2 * third),
            "prose": (4 + 2 * third, 4 + usable)}


def _generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of integers."""
    seed = int(np.random.SeedSequence([k & 0xFFFFFFFF for k in key]
                                      ).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed & (2 ** 63 - 1))


def _randint(gen, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen)


def _gen_domain(gen: torch.Generator, kind: str, b: int, s: int, vocab: int,
                structure: float) -> torch.Tensor:
    lo, hi = _domain_spans(vocab)[kind]
    width = hi - lo
    noise = _randint(gen, lo, hi, (b, s))
    t = torch.arange(s)[None, :]
    if kind == "math":
        # x_t = (x_0 + stride * t) mod width, stride revealed by the first
        # two tokens
        x0 = _randint(gen, 0, width, (b, 1))
        stride = _randint(gen, 1, 9, (b, 1))
        det = (x0 + stride * t) % width + lo
    elif kind == "code":
        # token_t = 7 depth_t mod width, depth a clipped random walk
        delta = _randint(gen, -1, 2, (b, s))
        depth = torch.clamp(torch.cumsum(delta, 1), 0, 31)
        det = (depth * 7) % width + lo
    else:
        # prose: x_t = (x_0 (5^(t mod 8) mod width) + 17 t) mod width
        x0 = _randint(gen, 0, width, (b, 1))
        det = (x0 * (5 ** (t % 8) % width) + 17 * t) % width + lo
    use_det = torch.rand((b, s), generator=gen) < structure
    return torch.where(use_det, det, noise)


def make_batch(cfg: DataConfig, step: int, host_slice: tuple | None = None,
               domain_mix: dict | None = None, device="cpu") -> dict:
    """The batch at ``step`` (optionally just this host's rows), on
    ``device``: {tokens, labels, mask, domain_id}; labels are the tokens
    shifted by one, the first token is BOS (1), the mask is all ones."""
    b = cfg.global_batch if host_slice is None else host_slice[1] - host_slice[0]
    key = (cfg.seed, step) if host_slice is None else (cfg.seed, step,
                                                      host_slice[0])
    mix = domain_mix or {d: 1.0 / len(cfg.domains) for d in cfg.domains}
    names = list(mix)
    probs = torch.tensor([mix[n] for n in names], dtype=torch.float64)
    dom_id = torch.multinomial(probs / probs.sum(), b, replacement=True,
                               generator=_generator(*key, 0))

    s = cfg.seq_len + 1
    streams = []
    for i, name in enumerate(names):
        gen = _generator(*key, 1, i)
        if name == "random":
            streams.append(_randint(gen, 4, cfg.vocab_size, (b, s)))
        else:
            streams.append(_gen_domain(gen, name, b, s, cfg.vocab_size,
                                       cfg.structure))
    toks = torch.stack(streams)[dom_id, torch.arange(b)]       # [b, s]
    toks[:, 0] = 1                                             # BOS
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((b, cfg.seq_len), dtype=torch.float32),
             "domain_id": dom_id}
    return {k: v.contiguous().to(device) for k, v in batch.items()}


def eval_batches(cfg: DataConfig, n: int, domain_mix: dict | None = None,
                 device="cpu") -> list:
    """Held-out batches (a step range disjoint from training)."""
    return [make_batch(cfg, step=10_000_000 + i, domain_mix=domain_mix,
                       device=device) for i in range(n)]


def domain_accuracy(logits: torch.Tensor, batch: dict) -> dict:
    """Per-domain next-token top-1 accuracy."""
    pred = torch.argmax(logits, -1)
    mask = batch["mask"]
    hit = (pred == batch["labels"]).to(torch.float32) * mask
    out = {}
    for i, d in enumerate(DOMAINS):
        sel = (batch["domain_id"] == i).to(torch.float32)[:, None]
        denom = torch.clamp_min(torch.sum(sel * mask), 1.0)
        out[d] = float(torch.sum(hit * sel) / denom)
    out["all"] = float(torch.sum(hit) / torch.clamp_min(torch.sum(mask), 1.0))
    return out
