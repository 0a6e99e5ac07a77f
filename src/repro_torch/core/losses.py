"""Distillation and task losses (port of ``repro.core.losses``).

The QAD loss (paper Eq. 1) is token-level KL divergence between the BF16
teacher and the NVFP4 student, temperature 1:

    L = E_tokens[ KL( softmax(t) || softmax(s) ) ]

  * ``kl_from_logits`` and the other plain losses: computed in f32 from
    materialized logits; the oracles of the KL kernels.
  * ``chunked_kl_loss`` / ``chunked_ce_loss``: the unembedding GEMM fused
    with the loss, over vocabulary chunks, with the analytic gradient; no
    [B, S, V] logits are ever live.  The reference writes these as
    ``custom_vjp``s in plain ``jnp``; here they are
    ``torch.autograd.Function``s in plain torch.
  * ``kernels.ops.kl_loss``: the streaming KL kernels (K5, K6), which the
    port's QAD step uses.

Every loss takes a float mask (1 = real token) and returns the mean over
real tokens.  On a training mesh a data rank holds some of the batch's
rows: the plain losses take ``denom``, the real tokens of the whole batch
(``global_denominator``), and return this rank's share of the mean, the
sum over the data group being the mean (a mean of per-rank means is
wrong wherever the ranks' counts differ).
"""
from __future__ import annotations

import torch

from ..distributed import ctx

_F32 = torch.float32


def global_denominator(mask: torch.Tensor) -> torch.Tensor | None:
    """A masked mean's denominator on a training mesh: the real tokens of
    every data rank's rows (at least 1); None off a mesh, where each loss
    counts its own mask."""
    if ctx.data() is None:
        return None
    return torch.clamp_min(ctx.data_sum(torch.sum(mask)), 1.0)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 denom: torch.Tensor | None = None) -> torch.Tensor:
    if denom is None:
        denom = torch.clamp_min(torch.sum(mask), 1.0)
    return torch.sum(x * mask) / denom


# ---------------------------------------------------------------------------
# plain (logits-materializing) losses
# ---------------------------------------------------------------------------


def kl_per_token(teacher_logits: torch.Tensor,
                 student_logits: torch.Tensor) -> torch.Tensor:
    """Token KL(p_t || p_s) over the last axis, in f32."""
    t = teacher_logits.to(_F32)
    s = student_logits.to(_F32)
    p_t = torch.softmax(t, -1)
    return torch.sum(p_t * (torch.log_softmax(t, -1)
                            - torch.log_softmax(s, -1)), -1)


def kl_from_logits(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                   mask: torch.Tensor,
                   denom: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token KL(p_t || p_s), in f32."""
    return _masked_mean(kl_per_token(teacher_logits, student_logits), mask,
                        denom)


def mse_from_logits(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                    mask: torch.Tensor,
                    denom: torch.Tensor | None = None) -> torch.Tensor:
    """MSE on logits (paper Table 8 ablation)."""
    d = teacher_logits.to(_F32) - student_logits.to(_F32)
    return _masked_mean(torch.mean(d * d, -1), mask, denom)


def ce_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor,
                   denom: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross entropy (the QAT objective)."""
    lf = logits.to(_F32)
    lse = torch.logsumexp(lf, -1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return _masked_mean(lse - ll, mask, denom)


def top1_agreement(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                   mask: torch.Tensor,
                   denom: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of tokens where the student's argmax is the teacher's."""
    agree = torch.argmax(teacher_logits, -1) == torch.argmax(student_logits, -1)
    return _masked_mean(agree.to(_F32), mask, denom)


# ---------------------------------------------------------------------------
# chunked fused unembedding + KL (memory-optimized path)
# ---------------------------------------------------------------------------
#
# Inputs are the final hidden states (teacher ht, student hs) and the two
# unembedding matrices [d, V].  The vocabulary is processed in chunks:
# streaming logsumexps and the p_t (t - s) sum in the forward; the backward
# recomputes each chunk's logits and uses dKL/ds_v = p_s(v) - p_t(v).


def _chunks(w: torch.Tensor, n_chunks: int) -> list[torch.Tensor]:
    d, v = w.shape
    if v % n_chunks:
        raise ValueError(f"vocab {v} is not a multiple of {n_chunks} chunks")
    return list(torch.split(w, v // n_chunks, dim=1))


def _combine_lse(tp, m, l, *rest):
    """A streamed log-sum-exp's running (max, sum) and sums scaled like
    its sum (``rest``), each rank's over its vocabulary tile, combined
    over the model group ``tp``: every rank's values all-gathered, each
    rescaled to the group's max and added in rank order (the same bits on
    every rank)."""
    every = tp.all_gather(torch.stack([m, l, *rest])[None], 0)
    top = torch.amax(every[:, 0], 0)
    out = [torch.zeros_like(l) for _ in range(1 + len(rest))]
    for r in range(every.shape[0]):
        corr = torch.exp(every[r, 0] - top)
        for i in range(len(out)):
            out[i] = out[i] + every[r, 1 + i] * corr
    return (top, *out)


def _kl_scan(ht, wt, hs, ws, n_chunks, tp=None):
    """Per-token KL and the two logsumexps, streamed over vocab chunks
    (with ``tp``: over this rank's vocabulary tile, then combined over
    the model group)."""
    lead = ht.shape[:-1]
    m_t = torch.full(lead, -torch.inf, dtype=_F32, device=ht.device)
    m_s = torch.full(lead, -torch.inf, dtype=_F32, device=ht.device)
    l_t = torch.zeros(lead, dtype=_F32, device=ht.device)
    l_s = torch.zeros_like(l_t)
    acc = torch.zeros_like(l_t)
    for wtc, wsc in zip(_chunks(wt, n_chunks), _chunks(ws, n_chunks)):
        t = (ht @ wtc).to(_F32)
        s = (hs @ wsc).to(_F32)
        m_t2 = torch.maximum(m_t, torch.amax(t, -1))
        corr_t = torch.exp(m_t - m_t2)
        e_t = torch.exp(t - m_t2[..., None])
        l_t = l_t * corr_t + torch.sum(e_t, -1)
        m_s2 = torch.maximum(m_s, torch.amax(s, -1))
        l_s = l_s * torch.exp(m_s - m_s2) + torch.sum(
            torch.exp(s - m_s2[..., None]), -1)
        acc = acc * corr_t + torch.sum(e_t * (t - s), -1)
        m_t, m_s = m_t2, m_s2
    if tp is not None:
        m_t, l_t, acc = _combine_lse(tp, m_t, l_t, acc)
        m_s, l_s = _combine_lse(tp, m_s, l_s)
    z_t = m_t + torch.log(l_t)
    z_s = m_s + torch.log(l_s)
    return acc / l_t - z_t + z_s, z_t, z_s


class _ChunkedKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ht, wt, hs, ws, mask, n_chunks, denom, tp):
        kl, z_t, z_s = _kl_scan(ht, wt, hs, ws, n_chunks, tp)
        if denom is None:
            denom = torch.clamp_min(torch.sum(mask), 1.0)
        ctx.save_for_backward(ht, wt, hs, ws, mask, z_t, z_s, denom)
        ctx.n_chunks = n_chunks
        return _masked_mean(kl, mask, denom)

    @staticmethod
    def backward(ctx, g):
        ht, wt, hs, ws, mask, z_t, z_s, denom = ctx.saved_tensors
        gt = (g * mask / denom).to(_F32)
        hsf = hs.reshape(-1, hs.shape[-1])
        dhs = torch.zeros_like(hs)
        dws = []
        for wtc, wsc in zip(_chunks(wt, ctx.n_chunks), _chunks(ws, ctx.n_chunks)):
            t = (ht @ wtc).to(_F32)
            s = (hs @ wsc).to(_F32)
            p_t = torch.exp(t - z_t[..., None])
            p_s = torch.exp(s - z_s[..., None])
            ds = ((p_s - p_t) * gt[..., None]).to(hs.dtype)
            dhs = dhs + ds @ wsc.T
            dws.append((hsf.T @ ds.reshape(-1, ds.shape[-1])).to(ws.dtype))
        # the teacher's inputs are constants (QAD stops the teacher's
        # gradient anyway); under a vocabulary split ``dhs`` is this rank's
        # columns' share, summed over the group by the caller's
        # ``ctx.copy_to_model``
        return None, None, dhs, torch.cat(dws, 1), None, None, None, None


def chunked_kl_loss(ht, wt, hs, ws, mask, n_chunks: int = 16, denom=None,
                    tp=None) -> torch.Tensor:
    """Mean token KL(p_t || p_s) fused with both unembedding GEMMs.  On a
    training mesh: ``denom`` the whole batch's real tokens
    (``global_denominator``; this rank's share of the mean is returned),
    and ``tp`` the model group where ``wt`` and ``ws`` hold this rank's
    vocabulary tile (the streamed log-sum-exps combined over it)."""
    return _ChunkedKL.apply(ht.detach(), wt.detach(), hs, ws, mask.detach(),
                            n_chunks, denom, tp)


# ---------------------------------------------------------------------------
# chunked fused CE (QAT at large vocab), the same machinery
# ---------------------------------------------------------------------------


def _ce_scan(h, w, labels, n_chunks):
    lead = h.shape[:-1]
    m = torch.full(lead, -torch.inf, dtype=_F32, device=h.device)
    l = torch.zeros(lead, dtype=_F32, device=h.device)
    ll = torch.zeros_like(l)
    chunks = _chunks(w, n_chunks)
    c = chunks[0].shape[1]
    for i, wc in enumerate(chunks):
        s = (h @ wc).to(_F32)
        m2 = torch.maximum(m, torch.amax(s, -1))
        l = l * torch.exp(m - m2) + torch.sum(torch.exp(s - m2[..., None]), -1)
        # the label's logit, where the label falls in this chunk
        loc = labels - i * c
        inside = (loc >= 0) & (loc < c)
        picked = torch.gather(s, -1, torch.clamp(loc, 0, c - 1)[..., None].long()
                              )[..., 0]
        ll = torch.where(inside, picked, ll)
        m = m2
    return m + torch.log(l), ll


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, mask, n_chunks):
        z, ll = _ce_scan(h, w, labels, n_chunks)
        ctx.save_for_backward(h, w, labels, mask, z)
        ctx.n_chunks = n_chunks
        return _masked_mean(z - ll, mask)

    @staticmethod
    def backward(ctx, g):
        h, w, labels, mask, z = ctx.saved_tensors
        gt = (g * mask / torch.clamp_min(torch.sum(mask), 1.0)).to(_F32)
        hf = h.reshape(-1, h.shape[-1])
        dh = torch.zeros_like(h)
        dws = []
        chunks = _chunks(w, ctx.n_chunks)
        c = chunks[0].shape[1]
        for i, wc in enumerate(chunks):
            s = (h @ wc).to(_F32)
            p = torch.exp(s - z[..., None])
            loc = labels - i * c
            inside = (loc >= 0) & (loc < c)
            onehot = ((torch.arange(c, device=h.device)
                       == torch.clamp(loc, 0, c - 1)[..., None])
                      & inside[..., None])
            ds = ((p - onehot.to(_F32)) * gt[..., None]).to(h.dtype)
            dh = dh + ds @ wc.T
            dws.append((hf.T @ ds.reshape(-1, ds.shape[-1])).to(w.dtype))
        return dh, torch.cat(dws, 1), None, None, None


def chunked_ce_loss(h, w, labels, mask, n_chunks: int = 16) -> torch.Tensor:
    """Mean next-token CE fused with the unembedding GEMM."""
    return _ChunkedCE.apply(h, w, labels, mask.detach(), n_chunks)
