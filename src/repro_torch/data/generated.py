"""Teacher-generated QAD data, paper §4.1, Table 5 rows 2-4 (port of
``repro.data.generated``).

``generate_tokens`` samples continuations from the BF16 teacher itself:
the "generated from RL prompts" and "generated from the BOS token" data
sources, which make QAD data-free (only the teacher is needed).

Randomness: the reference draws token ``j`` with a ``jax.random`` key
folded from its key and ``j``.  Here draw ``j`` takes a ``torch.Generator``
seeded from ``(seed, j)`` as ``serve.sampling.request_generator`` makes
it, and the Gumbel-max draw that ``jax.random.categorical`` uses: the
streams are deterministic but not ``jax.random``'s, so sampled tokens
differ from the reference's.  At a temperature near 0 the draw is the
argmax, and the tokens equal the reference's.
"""
from __future__ import annotations

import torch

from ..core.qconfig import BF16
from ..serve.sampling import request_generator


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` as written: exp(x - max) / sum."""
    e = torch.exp(x - torch.amax(x, -1, keepdim=True))
    return e / torch.sum(e, -1, keepdim=True)


def top_p_logits(lg: torch.Tensor, temperature: float = 1.0,
                 top_p: float = 1.0) -> torch.Tensor:
    """The last position's logits [B, S, V] -> the f32 logits [B, V] a
    draw takes: divided by the temperature (floored at 1e-6), and with
    ``top_p < 1`` every logit below the nucleus cutoff set to -1e30.  The
    cutoff is the reference's: logits sorted descending, softmax, cumsum,
    the count of cumulative probabilities below ``top_p`` as the index of
    the cutoff logit (a count of V keeps every logit, as the reference's
    out-of-range gather does)."""
    lg = lg[:, -1].to(torch.float32) / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_lg = torch.flip(torch.sort(lg, -1).values, [-1])
        csum = torch.cumsum(_softmax(sorted_lg), -1)
        cutoff_idx = torch.sum(csum < top_p, -1, keepdim=True)
        v = lg.shape[-1]
        cutoff = torch.take_along_dim(sorted_lg,
                                      torch.clamp_max(cutoff_idx, v - 1), -1)
        cutoff = torch.where(cutoff_idx < v, cutoff,
                             torch.full_like(cutoff, -torch.inf))
        lg = torch.where(lg < cutoff, torch.full_like(lg, -1e30), lg)
    return lg


def sample(lg: torch.Tensor, gen: torch.Generator, temperature: float = 1.0,
           top_p: float = 1.0) -> torch.Tensor:
    """One token per row from the last position's logits [B, S, V]: a
    Gumbel-max draw over ``top_p_logits``, the noise from ``gen`` (a CPU
    generator, so the stream does not depend on the device) -> [B] int64."""
    lg = top_p_logits(lg, temperature, top_p)
    u = torch.rand(lg.shape, generator=gen, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(
        torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    return torch.argmax(lg + gumbel.to(lg.device), -1)


@torch.no_grad()
def generate_tokens(model, cfg, params, prompts: torch.Tensor, n_new: int,
                    seed: int = 0, temperature: float = 1.0,
                    top_p: float = 1.0) -> torch.Tensor:
    """Sample ``n_new`` tokens after ``prompts`` [B, P] from the teacher,
    under ``BF16``: one prefill into a dense cache of ``P + n_new``
    positions, then one-token ``decode_step``s.  Returns [B, P + n_new]
    int64 on the parameters' device (the prompts are moved there)."""
    dev = params["embed"].device
    prompts = prompts.to(dev, torch.long)
    p_len = prompts.shape[1]
    logits, cache = model.prefill(cfg, params, {"tokens": prompts}, BF16,
                                  s_max=p_len + n_new)
    toks = [prompts]
    for j in range(n_new):
        if j:
            logits, cache = model.decode_step(cfg, params, cache,
                                              {"tokens": toks[-1]}, BF16)
        nxt = sample(logits, request_generator(seed, j), temperature, top_p)
        toks.append(nxt[:, None])
    return torch.cat(toks, 1)


def bos_prompts(batch: int, bos_id: int = 1, device="cpu") -> torch.Tensor:
    """Single-BOS prompts: the fully data-free setting (Table 5 row 4)."""
    return torch.full((batch, 1), bos_id, dtype=torch.long, device=device)


def batch_from_generated(tokens: torch.Tensor, seq_len: int) -> dict:
    """Generated [B, >= seq_len + 1] token ids -> a training batch."""
    toks = tokens[:, : seq_len + 1]
    b = toks.shape[0]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((b, seq_len), dtype=torch.float32,
                               device=toks.device),
            "domain_id": torch.zeros((b,), dtype=torch.long,
                                     device=toks.device)}
