"""Per-request sampling: greedy, temperature, top-k, deterministic seeds
(port of ``repro.serve.sampling``, lines 1-120; the speculative accept /
resample half comes with the speculative slice).

One ``sample_tokens`` covers the whole slot batch: every request carries
its own (temperature, top_k, seed), and the engine folds the request's
generation index into its seed, so a request samples the same tokens
wherever and whenever its decode steps land.

``temperature == 0`` is exact greedy: ``torch.argmax``, which takes the
first index on ties, as ``jnp.argmax`` does.

Randomness: the reference folds (seed, token index) into a ``jax.random``
key.  Here the pair becomes a counter-based 63-bit seed (a hash of the two)
for a ``torch.Generator`` on the CPU, which draws the row's Gumbel noise for
a Gumbel-max draw (``jax.random.categorical``'s method).  The streams are
deterministic and independent of the device, but they are not
``jax.random``'s: a seeded request samples other tokens than the
reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> full vocabulary
    seed: int = 0                # per-request; folded with the token index


def request_seed(seed: int, token_index: int) -> int:
    """The generator seed of one request's ``token_index``-th sample."""
    h = hashlib.blake2b(np.asarray([seed, token_index], np.int64).tobytes(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def request_generator(seed: int, token_index: int) -> torch.Generator:
    return torch.Generator().manual_seed(request_seed(seed, token_index))


def topk_mask(lf: torch.Tensor, top_k) -> torch.Tensor:
    """Mask logits outside the top-k to -inf, with EXACTLY k survivors.

    lf [..., V] f32; top_k broadcastable to lf.shape[:-1] (<= 0 means the
    whole vocabulary).  Elements rank by (-logit, token id): the stable
    sort puts equal logits lower id first, so threshold ties cannot let
    more than k candidates through.
    """
    v = lf.shape[-1]
    top_k = torch.as_tensor(top_k, device=lf.device)
    order = torch.argsort(-lf, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)          # inverse permutation
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, v), v)
    return torch.where(ranks < k_eff[..., None], lf, -torch.inf)


def filtered_probs(logits: torch.Tensor, temperature, top_k) -> torch.Tensor:
    """The distribution a (temperature, top_k) request draws from; rows with
    temperature <= 0 get it clamped (their callers take the argmax)."""
    lf = logits.to(torch.float32)
    t = torch.as_tensor(temperature, dtype=torch.float32, device=lf.device)
    return torch.softmax(topk_mask(lf, top_k)
                         / torch.clamp_min(t, 1e-6)[..., None], -1)


def sample_tokens(logits: torch.Tensor, temperature, top_k,
                  generators) -> torch.Tensor:
    """logits [B, V], temperature [B], top_k [B], one CPU ``torch.Generator``
    per row -> token ids [B] (int64, on the logits' device).

    Rows with temperature <= 0 take the argmax; the others mask logits
    outside their top-k (exactly k survive, see ``topk_mask``) and draw
    at their temperature with their generator.  A batch that is all
    greedy (the engine's default) skips the sort and the draw.
    """
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, -1)
    temperature = np.asarray(temperature, np.float32)
    if not (temperature > 0).any():
        return greedy
    dev = lf.device
    t = torch.as_tensor(temperature, device=dev)
    scaled = topk_mask(lf, torch.as_tensor(np.asarray(top_k), device=dev)) \
        / torch.clamp_min(t, 1e-6)[:, None]
    u = torch.stack([torch.rand(lf.shape[-1], generator=g) for g in generators])
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    drawn = torch.argmax(scaled + gumbel.to(dev), -1)
    return torch.where(t > 0, drawn, greedy)


def sample_tokens_seeded(logits: torch.Tensor, temperature, top_k, seeds,
                         token_idx) -> torch.Tensor:
    """``sample_tokens`` with each row's generator made from its request
    seed and generation index."""
    gens = [request_generator(int(s), int(i)) for s, i in zip(seeds, token_idx)]
    return sample_tokens(logits, temperature, top_k, gens)
