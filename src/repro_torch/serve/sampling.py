"""Per-request sampling: greedy, temperature, top-k, deterministic seeds,
and the lossless speculative accept / resample rule (port of
``repro.serve.sampling``).

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

``speculative_verify_tokens`` is standard speculative sampling: accept a
draft token x with probability min(1, p(x) / q(x)), resample the first
rejection from norm(max(p - q, 0)), and draw a bonus token from the
target's next distribution when every proposal survives.  The emitted
tokens are distributed as sequential sampling from the target; greedy rows
emit the target's argmax chain, token for token what the plain engine
emits, and never touch a generator.  Acceptance uniforms, residual and
bonus draws and the draft's own proposals take separate sub-streams of a
request's (seed, token index): ``stream_generator``.
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
    seed and generation index (``fold_keys``)."""
    return sample_tokens(logits, temperature, top_k, fold_keys(seeds, token_idx))


# ---------------------------------------------------------------------------
# speculative decoding: draft sampling + lossless accept / resample
# ---------------------------------------------------------------------------

# sub-streams under each (seed, token index): acceptance uniforms,
# residual / bonus resamples and the draft's proposals share no draws
_ACCEPT_STREAM, _RESAMPLE_STREAM, _DRAFT_STREAM = 0, 1, 2


def stream_generator(seed: int, token_index: int,
                     stream: int) -> torch.Generator:
    """The CPU generator of one request's ``token_index``-th emission on
    sub-stream ``stream`` (the reference's ``fold_in(fold_in(key(seed),
    i), stream)``): a hash of the three, as ``request_seed`` hashes two."""
    h = hashlib.blake2b(np.asarray([seed, token_index, stream],
                                   np.int64).tobytes(), digest_size=8)
    return torch.Generator().manual_seed(
        int.from_bytes(h.digest(), "little") >> 1)


def fold_keys(seeds, token_idx) -> list[torch.Generator]:
    """[B] request seeds + [B] generation indices -> one generator a row
    (``request_generator``)."""
    return [request_generator(int(s), int(i)) for s, i in zip(seeds, token_idx)]


def _position_keys(seeds, token_idx, k1: int,
                   stream: int) -> list[list[torch.Generator]]:
    """[B] seeds + [B] first-emission indices -> [B][k1] generators, one
    per candidate emission position, on sub-stream ``stream``."""
    return [[stream_generator(int(s), int(t0) + i, stream) for i in range(k1)]
            for s, t0 in zip(seeds, token_idx)]


def _gumbel(gen: torch.Generator, v: int) -> torch.Tensor:
    u = torch.rand(v, generator=gen)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))


def _draw(probs: torch.Tensor, gens: list) -> torch.Tensor:
    """One categorical draw a row from ``probs`` [R, V] (Gumbel-max over
    log p; zero-probability tokens never drawn), row r with ``gens[r]``."""
    logp = torch.where(probs > 0, torch.log(probs), -torch.inf)
    noise = torch.stack([_gumbel(g, probs.shape[-1]) for g in gens])
    return torch.argmax(logp + noise.to(probs.device), -1)


def draft_sample_tokens(logits: torch.Tensor, temperature, top_k, seeds,
                        token_idx):
    """One draft-proposal step: the proposed token and the proposal
    distribution q the acceptance test needs.

    logits [B, V]; temperature / top_k / seeds [B]; token_idx [B] the
    generation index the proposal targets.  Greedy rows propose the
    argmax; an all-greedy batch returns q = None and draws nothing
    (greedy acceptance compares token ids; the reference returns zeros).
    Returns (tokens [B] int64, q [B, V] f32 or None).
    """
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, -1)
    temperature = np.asarray(temperature, np.float32)
    if not (temperature > 0).any():
        return greedy, None
    dev = lf.device
    t = torch.as_tensor(temperature, device=dev)
    q = filtered_probs(lf, t, torch.as_tensor(np.asarray(top_k), device=dev))
    rows = np.nonzero(temperature > 0)[0]
    gens = [stream_generator(int(seeds[r]), int(token_idx[r]), _DRAFT_STREAM)
            for r in rows]
    out = greedy.clone()
    idx = torch.as_tensor(rows, device=dev)
    out[idx] = _draw(q[idx], gens)
    return out, q


def speculative_verify_tokens(target_logits: torch.Tensor, draft_tokens,
                              draft_probs, n_prop, temperature, top_k, seeds,
                              token_idx):
    """Lossless accept / resample over one verified draft chunk per slot.

    target_logits [B, K1, V]: position i is the target's distribution for
    the (token_idx + i)-th emission; draft_tokens [B, K1 - 1]; draft_probs
    [B, K1 - 1, V] the draft's q; n_prop [B] proposals each row made (the
    rest is padding); temperature / top_k / seeds / token_idx [B], the
    last the generation index of the first emission.

    Greedy rows (temperature <= 0) accept draft i iff it equals the
    target's argmax at position i and emit the argmax chain;
    ``draft_probs=None`` stands for a batch that proposed nothing or is all
    greedy.  Stochastic rows accept x with probability min(1, p(x) / q(x)) (p the target's
    filtered distribution), resample the first rejection from
    norm(max(p - q, 0)) and draw a bonus token from p when every proposal
    survives.  Returns (out_tokens [B, K1] int64, zero past n_emit;
    n_emit [B] in [1, n_prop + 1]; n_acc [B] accepted drafts), on the
    logits' device.
    """
    b, k1, v = target_logits.shape
    k = k1 - 1
    dev = target_logits.device
    lf = target_logits.to(torch.float32)
    greedy = torch.argmax(lf, -1)                               # [B, K1]
    draft_tokens = torch.as_tensor(draft_tokens, device=dev).long()
    n_prop = torch.as_tensor(np.asarray(n_prop), device=dev).long()
    rows = torch.arange(b, device=dev)
    offs = torch.arange(k, device=dev)
    acc = draft_tokens == greedy[:, :k]
    temperature = np.asarray(temperature, np.float32)
    stochastic = temperature > 0
    if stochastic.any():
        t = torch.as_tensor(temperature, device=dev)
        p = filtered_probs(lf, t[:, None],
                           torch.as_tensor(np.asarray(top_k), device=dev)[:, None])
        # no proposal step ran (every k_eff 0): no q, and none is read
        q = (torch.zeros((b, k, v), device=dev) if draft_probs is None
             else torch.as_tensor(draft_probs, device=dev).to(torch.float32))
        p_tok = torch.gather(p[:, :k], -1, draft_tokens[..., None])[..., 0]
        q_tok = torch.gather(q, -1, draft_tokens[..., None])[..., 0]
        u = torch.zeros((b, k), dtype=torch.float32)
        for r in np.nonzero(stochastic)[0]:
            for i, g in enumerate(_position_keys([seeds[r]], [token_idx[r]], k,
                                                 _ACCEPT_STREAM)[0]):
                u[r, i] = torch.rand((), generator=g)
        # u q < p  <=>  u < min(1, p / q); q == 0 rejects unless p > 0
        acc = torch.where(t[:, None] > 0, u.to(dev) * q_tok < p_tok, acc)
    acc = acc & (offs[None, :] < n_prop[:, None])
    n_acc = torch.sum(torch.cumprod(acc.long(), 1), 1)           # [B]
    final = greedy[rows, n_acc]
    if stochastic.any():
        pf = p[rows, n_acc]                                     # [B, V]
        rejected = n_acc < n_prop
        qf = (q[rows, torch.clamp(n_acc, max=k - 1)] if k
              else torch.zeros_like(pf))
        qf = torch.where(rejected[:, None], qf, 0.0)
        residual = torch.clamp_min(pf - qf, 0.0)
        rmass = torch.sum(residual, -1, keepdim=True)
        final_p = torch.where(rmass > 0,
                              residual / torch.clamp_min(rmass, 1e-30), pf)
        rs = np.nonzero(stochastic)[0]
        na = n_acc.cpu().numpy()
        gens = [stream_generator(int(seeds[r]), int(token_idx[r]) + int(na[r]),
                                 _RESAMPLE_STREAM) for r in rs]
        idx = torch.as_tensor(rs, device=dev)
        final = final.clone()
        final[idx] = _draw(final_p[idx], gens)
    padded = torch.cat([draft_tokens, draft_tokens.new_zeros((b, 1))], 1)
    out = torch.where(torch.arange(k1, device=dev)[None, :] < n_acc[:, None],
                      padded, 0)
    out[rows, n_acc] = final
    return out, n_acc + 1, n_acc
