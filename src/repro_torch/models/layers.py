"""Shared building blocks (port of ``repro.models.layers``).

Every GEMM routes through ``qeinsum`` / ``qdense``, the single NVFP4
injection point: the activation is fake-quantized along its last dim by
``QuantConfig.q_act`` (the ``nvfp4_qdq`` kernel on the card), and the
weight is a dense tensor or a ``PackedNVFP4``.  A 2-D packed weight goes
to the ``nvfp4_matmul`` kernel (K2); a packed MoE expert stack
[E, K, N] goes to the grouped kernel (K3) under
``packed_backend="grouped"`` (the engine's fused tier); other packed
weights are dequantized and multiplied; dense weights are multiplied as
they are.

``moe_ffn`` is the top-k MoE with sorted capacity dispatch in the
reference's three scopes.  Under TP the router's logits are all-gathered
along E before the softmax (every rank routes and drops alike) and each
rank runs its tiles of the expert stacks (``_expert_ffn``): its E/n
experts, whose outputs are all-gathered along E before the combine, or
every expert's slice of the FFN dim, the down projection's f32 partials
summed over the group.  Under grad (MoE QAD on a training mesh) these
are ``ctx``'s autograd collectives, the whole slab entering the split
products through ``copy_to_model``; one global capacity domain gathers
every data rank's tokens first, so the slots are the whole batch's, and
per-row dispatch reports the batch's aux.

Under an active tensor-parallel context (``distributed.ctx``) a dense
GEMM site names its ``parallelism``.  A column site takes the whole
activation and gives this rank's N/n output features: a 2-D packed tile
runs K4 in column mode.  A row site takes this rank's K/n features: a 2-D
packed tile runs K4 in row mode (f32 partials summed over the group), a
dense tile an f32 product and the same sum; the activation's QDQ takes
the group's amax.  A row weight that could not split in whole blocks
stays replicated, as in the reference: its input is all-gathered along
the features and the weight dequantized and multiplied, with no sum
afterwards.  Column weights always split under TP: the engine admits a
config only when its heads, KV heads and d_ff divide the group, and a
column split needs no more.  Under grad (training on a mesh) a column
site's input passes ``ctx.copy_to_model`` and a row site's sum is
``ctx.reduce_from_model``, so each gradient is reduced where its forward
was not; a dense weight tile's QDQ takes the whole weight's amax there
(``ctx.tile_amax``).

Every dispatch is counted (``qeinsum_dispatch_total{backend}`` and its
analytic weight bytes) into the recorder an engine step installs
(``obs.dispatch``), with the reference's backend labels: ``pallas_2d``
(K2), ``pallas_grouped`` (K3), ``pallas_tp_column`` / ``pallas_tp_row``
(K4), ``dequant`` and ``dense``.  The port counts every call; the
reference one per compiled specialization.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.nvfp4 import BLOCK, PackedNVFP4
from ..core.qconfig import QuantConfig
from ..distributed import ctx
from ..kernels import ops
from ..kernels.nvfp4_matmul import sum_k_f32
from ..obs import dispatch as obs_dispatch
from ..obs import numerics as obs_numerics

_DENSE_EQ = "...k,ko->...o"
_MOE_EQ = "...eck,eko->...eco"


# On the card cuBLAS picks a GEMM's kernel, and with it the order in which
# an output row is summed, from the number of rows M.  A dense product's
# rows are padded to a multiple of MIN_ROWS there, so every product of up
# to 64 rows gives a row the same bits: the speculative verify's k + 1
# tokens a slot those of the decode step's one, a slot those of a batch-1
# request (``chip_smoke.py`` phase 3l: without it the MoE router's rows
# parted between M = 8 and 24).  On the CPU the products stay as they are,
# the reference's parity tests' products.
MIN_ROWS = 64


def pad_rows(x2: torch.Tensor) -> torch.Tensor:
    """A [M, ...] tensor's rows padded with zeros to a multiple of MIN_ROWS
    on the card; on the CPU the tensor itself."""
    n = x2.shape[0]
    if not x2.is_cuda or n % MIN_ROWS == 0:
        return x2
    return torch.nn.functional.pad(x2, (0, 0) * (x2.dim() - 1)
                                   + (0, MIN_ROWS - n % MIN_ROWS))


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype (what ``jnp.einsum`` returns), its
    rows independent of how many share the call (``MIN_ROWS``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    y = pad_rows(x2).to(dt) @ w.to(dt)
    return y[:x2.shape[0]].reshape(*x.shape[:-1], y.shape[-1])


def _to_groups(x: torch.Tensor) -> torch.Tensor:
    """[..., E, C, K] -> [E, (lead * C), K]: every leading batch dim joins
    each expert's M rows."""
    *_, e, c, k = x.shape
    return x.reshape(-1, e, c, k).movedim(1, 0).reshape(e, -1, k)


def _from_groups(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_to_groups`` for an output [E, (lead * C), N]."""
    *lead, e, c, _ = like.shape
    n = y.shape[-1]
    return y.reshape(e, -1, c, n).movedim(0, 1).reshape(*lead, e, c, n)


def _moe_einsum(x: torch.Tensor, w: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """``einsum(_MOE_EQ, x, w)`` for a dense expert stack w [E, K, N]: f32
    products and sums, rounded once to the promoted dtype (or to
    ``out_dtype``), as XLA computes a bf16 dot.  On the CPU the sum runs
    over K in order, as XLA's CPU dot sums (so this is bitwise the grouped
    kernel's plain version); on the card it is one f32 batched product."""
    dt = out_dtype or torch.promote_types(x.dtype, w.dtype)
    xg = _to_groups(x)
    if xg.device.type == "cpu":
        y = sum_k_f32(xg, w.transpose(1, 2))
    else:
        y = torch.bmm(xg.to(torch.float32), w.to(torch.float32))
    return _from_groups(y, x).to(dt)


def _note_gemm(backend: str, w) -> None:
    """Record one qeinsum dispatch and its analytic weight bytes if an
    engine step is recording: a packed weight moves its codes, block scales
    and f32 tensor scale, a dense one its elements.  Shapes only: nothing
    reads the device."""
    rec = obs_dispatch.active()
    if rec is None:
        return
    nbytes = (w.nbytes if isinstance(w, PackedNVFP4)
              else w.numel() * w.element_size())
    rec.gemm(backend, nbytes)


def _probe_packed(qcfg: QuantConfig, kind: str, wr, tp=None) -> None:
    """A packed weight bypasses ``q_weight``: its scale-structure probe
    lives at the dispatch point (``tp``: ``wr`` is this rank's tile)."""
    tape = obs_numerics.active() if qcfg.numerics else None
    if tape is not None and isinstance(wr, PackedNVFP4):
        tape.put(f"{kind}.w", obs_numerics.packed_weight_stats(wr, tp))


def _moe_grouped(xq: torch.Tensor, wr: PackedNVFP4) -> torch.Tensor:
    """``_MOE_EQ`` through ``ops.nvfp4_matmul_grouped``: one launch for all
    experts; x [..., E, C, K] -> [..., E, C, N]."""
    _note_gemm("pallas_grouped", wr)
    y = ops.nvfp4_matmul_grouped(_to_groups(xq), wr, out_dtype=xq.dtype)
    return _from_groups(y, xq)


def qeinsum(qcfg: QuantConfig, kind: str, eq: str, x: torch.Tensor, w,
            contract_axis: int = 0, quantize_act: bool = True,
            parallelism: str | None = None) -> torch.Tensor:
    """``einsum(eq, q_act(x), resolve(w))`` for the dense equation
    (w [K, N]) or the MoE one (w [E, K, N], ``contract_axis=1``).
    ``quantize_act=False`` lets the MoE fake-quant an activation once and
    reuse it across GEMMs.  ``parallelism`` under TP: "column" or "row"
    (a dense site; "row_scatter": a row site whose output each rank keeps
    only its own slice of, ``_qeinsum_row``), "column" or "expert" (an
    expert stack's tile on its FFN dim or on E: the product is the tile's,
    no collective)."""
    if eq not in (_DENSE_EQ, _MOE_EQ):
        raise ValueError(f"unsupported einsum {eq!r}")
    tp = ctx.current()
    if tp is not None and eq == _DENSE_EQ and parallelism in ("row",
                                                                "row_scatter"):
        return _qeinsum_row(qcfg, kind, x, w, quantize_act, tp,
                            parallelism == "row_scatter")
    if tp is not None and eq == _DENSE_EQ and parallelism == "column":
        x = ctx.copy_to_model(x, tp)
    xq = qcfg.q_act(x, kind) if quantize_act else x
    wr = qcfg.resolve_weight(w, kind, contract_axis)
    _probe_packed(qcfg, kind, wr, tp if parallelism else None)
    einsum = _matmul if eq == _DENSE_EQ else _moe_einsum
    if isinstance(wr, PackedNVFP4):
        if (wr.ndim == 3 and contract_axis == 1 and eq == _MOE_EQ
                and qcfg.packed_backend == "grouped"):
            return _moe_grouped(xq, wr)
        if (wr.ndim == 2 and contract_axis == 0 and eq == _DENSE_EQ
                and qcfg.packed_backend in ("auto", "grouped")):
            if tp is not None and parallelism == "column":
                _note_gemm("pallas_tp_column", wr)
                return ops.nvfp4_matmul_tp(xq, wr, tp, "column",
                                           out_dtype=xq.dtype)
            _note_gemm("pallas_2d", wr)
            return ops.nvfp4_matmul(xq, wr, out_dtype=xq.dtype)
        _note_gemm("dequant", wr)
        return einsum(xq, ops.dequant_weight(wr, contract_axis, xq.dtype))
    _note_gemm("dense", wr)
    return einsum(xq, wr)


def _qeinsum_row(qcfg: QuantConfig, kind: str, x: torch.Tensor, w,
                 quantize_act: bool, tp,
                 scatter: bool = False) -> torch.Tensor:
    """A row-parallel dense site under TP: ``x`` [..., K/n] holds this
    rank's features, ``w`` [K/n, N] (or its packed tile) the matching
    rows, and every rank gets the whole y [..., N]; with ``scatter`` (a
    dense tile) this rank's slice y [..., N/n] of it, the f32 partials
    reduce-scattered (``ctx.scatter_from_model``)."""
    wr = qcfg.resolve_weight(w, kind, 0)
    packed = isinstance(wr, PackedNVFP4)
    if scatter and packed:
        raise NotImplementedError("a scattered row site takes a dense tile")
    if (wr.k if packed else wr.shape[0]) != x.shape[-1]:
        # replicated (no whole-block split): gather the features, no sum
        x = ctx.gather_from_model(x, tp, -1)
        xq = qcfg.q_act(x, kind) if quantize_act else x
        _probe_packed(qcfg, kind, wr)
        _note_gemm("dequant" if packed else "dense", wr)
        return _matmul(xq, ops.dequant_weight(wr, 0, xq.dtype)
                       if packed else wr)
    if (not packed and x.shape[-1] % BLOCK and qcfg.quantize_weights
            and qcfg.quantizes(kind)):
        raise NotImplementedError(
            f"a {kind} row-parallel site's {x.shape[-1]} features a rank cut "
            f"its {BLOCK}-element NVFP4 blocks: a dense tile's QDQ would "
            "block across the cut")
    xq = qcfg.q_act(x, kind, tp) if quantize_act else x
    _probe_packed(qcfg, kind, wr, tp)
    if packed and wr.ndim == 2 and qcfg.packed_backend in ("auto", "grouped"):
        _note_gemm("pallas_tp_row", wr)
        return ops.nvfp4_matmul_tp(xq, wr, tp, "row", out_dtype=xq.dtype)
    _note_gemm("dequant" if packed else "dense", wr)
    wd = ops.dequant_weight(wr, 0, xq.dtype) if packed else wr
    part = xq.to(torch.float32) @ wd.to(torch.float32)
    whole = (ctx.scatter_from_model(part, tp, -1) if scatter
             else ctx.reduce_from_model(part, tp))
    return whole.to(torch.promote_types(xq.dtype, wd.dtype))


def qdense(qcfg: QuantConfig, kind: str, x: torch.Tensor, w,
           b: torch.Tensor | None = None, contract_axis: int = 0,
           quantize_act: bool = True,
           parallelism: str | None = None) -> torch.Tensor:
    """y = x @ w (+ b) with NVFP4 fake-quant per the policy; ``w`` [in, out]
    or an expert stack [E, in, out] with ``contract_axis=1`` and x
    [..., E, C, in]; dense or packed."""
    if w.ndim == 2 and contract_axis == 0:
        eq = _DENSE_EQ
    elif w.ndim == 3 and contract_axis == 1:
        eq = _MOE_EQ
    else:
        raise ValueError(f"unsupported weight rank/contract_axis: "
                         f"{w.ndim}/{contract_axis}")
    y = qeinsum(qcfg, kind, eq, x, w, contract_axis, quantize_act,
                parallelism)
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# norms (computed in fp32)
# ---------------------------------------------------------------------------


def row_mean(v: torch.Tensor) -> torch.Tensor:
    """``torch.mean(v, -1, keepdim=True)``, each row summed in an order that
    does not depend on how many rows share the call: on the card torch
    picks a reduction's launch shape from the number of rows, so they are
    padded as a GEMM's are (``pad_rows``)."""
    flat = v.reshape(-1, v.shape[-1])
    m = torch.mean(pad_rows(flat), -1, keepdim=True)
    return m[:flat.shape[0]].reshape(*v.shape[:-1], 1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(row_mean(xf * xf) + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor | None, b: torch.Tensor | None,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = row_mean(xf)
    var = row_mean(torch.square(xf - mu))
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(cfg, x, w=None, b=None):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, w)
    if cfg.norm == "layernorm":
        return layernorm(x, w, b)
    if cfg.norm == "layernorm_np":          # OLMo: non-parametric LN
        return layernorm(x, None, None)
    raise ValueError(cfg.norm)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; pos: broadcastable to [..., S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = pos[..., None].to(torch.float32) * freqs          # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1 = x[..., : hd // 2].to(torch.float32)
    xf2 = x[..., hd // 2:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], -1).to(x.dtype)


def _mrope_slots(sections: tuple, n: int, device) -> torch.Tensor:
    """The section (0 = t, 1 = h, 2 = w) of each of the ``n`` frequency
    slots: ``jnp.repeat(arange, sections, total_repeat_length=n)``, which
    drops what lies past ``n`` and repeats the last section up to ``n``."""
    ids = torch.repeat_interleave(torch.arange(len(sections), device=device),
                                  torch.tensor(sections, device=device))
    if ids.numel() >= n:
        return ids[:n]
    return torch.cat([ids, ids[-1:].expand(n - ids.numel())])


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the hd/2 frequency slots are split into
    (t, h, w) sections, each rotated by its own position stream.

    x: [B, S, H, hd]; pos3: [B, S, 3] (t/h/w position ids)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    sec = _mrope_slots(tuple(sections), hd // 2, x.device)
    ang = pos3.to(torch.float32)[..., sec] * freqs          # [B, S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1 = x[..., : hd // 2].to(torch.float32)
    xf2 = x[..., hd // 2:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], -1).to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embedding [seq, d], f32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    log_c = float(np.log(np.float32(10000.0)))
    inv = torch.exp(-log_c * torch.arange(d // 2, dtype=torch.float32,
                                          device=device) / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _in_dtype(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (a Python scalar meets a JAX array in the
    array's dtype)."""
    return float(torch.tensor(v, dtype=dtype))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign, as XLA's CPU code treats them
    (flush to zero, denormals are zero)."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, x * 0, x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``, the tanh approximation, as it is written: its
    constants in x's dtype and every step rounded to it, subnormals
    flushed, the last product's among them before it rounds to x's dtype
    (an f32 subnormal that would round up to the smallest bf16 normal is
    0 in the reference), so it is the reference's on every finite bf16
    value.  ``F.gelu(..., approximate="tanh")`` rounds once, and parts
    from the reference on four bf16 values in ten."""
    x = _flush(x)
    c = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    k = _in_dtype(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    # a product of two bf16 values is exact in f32
    return _flush(x.to(torch.float32) * cdf.to(torch.float32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x * 1 / (exp(-x) + 1), each step
    rounded to x's dtype (for bf16, four roundings where ``F.silu`` has
    one)."""
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def swiglu_mlp(qcfg, x, wg, wu, wd, kind: str = "mlp"):
    g = qdense(qcfg, kind, x, wg, parallelism="column")
    u = qdense(qcfg, kind, x, wu, parallelism="column")
    return qdense(qcfg, kind, silu(g) * u, wd, parallelism="row")


def gelu_mlp(qcfg, x, wi, wd, bi=None, bd=None, kind: str = "mlp"):
    h = gelu(qdense(qcfg, kind, x, wi, bi, parallelism="column"))
    return qdense(qcfg, kind, h, wd, bd, parallelism="row")


# ---------------------------------------------------------------------------
# MoE FFN: capacity-based sorted dispatch (reference lines 304-470)
# ---------------------------------------------------------------------------


def moe_ffn(qcfg, cfg, x, router_w, wg, wu, wd):
    """Top-k MoE with sorted capacity dispatch; static shapes throughout.

    x [B, S, d]; router_w [d, E]; expert stacks [E, d, ffe] / [E, ffe, d].
    Returns (out [B, S, d], aux {"moe_dropped_frac",
    "moe_router_entropy"}).  ``cfg.moe_dispatch`` picks the capacity
    domain:

      * "global": one sort over all B * S tokens;
      * "local": one per batch row, so a request's routing (and drops)
        never depends on the requests batched beside it;
      * "token": one per token, what the multi-token paged forward needs
        to reproduce one-token decode; with ``act_scope="token"`` the
        expert slabs quantize per dispatch row ("row" scope), which is
        per token here.
    """
    dispatch = getattr(cfg, "moe_dispatch", "global")
    b, s, d = x.shape
    dp = ctx.data()
    if dispatch == "token":
        if qcfg.act_scope == "token":
            qcfg = dataclasses.replace(qcfg, act_scope="row")
        out, aux = _moe_dispatch_local(qcfg, cfg, x.reshape(b * s, 1, d),
                                       router_w, wg, wu, wd)
        return out.reshape(b, s, d), _data_mean(aux, b * s)
    if dispatch == "local":
        out, aux = _moe_dispatch_local(qcfg, cfg, x, router_w, wg, wu, wd)
        return out, _data_mean(aux, b)
    if dp is not None and dp.size > 1:
        # one capacity domain over the whole batch, as GSPMD sorts it: the
        # data ranks' tokens gathered, every rank dispatching them alike
        # (its own tokens' slots are the reference's); a token of another
        # rank gets no gradient here, so the gather's backward keeps this
        # rank's rows and each expert's gradient its own tokens' share
        xs = ctx.gather_from_model(x, dp, 0)
        with ctx.data_replicated():
            out, aux = _moe_dispatch_flat(qcfg, cfg, xs.reshape(-1, d),
                                          router_w, wg, wu, wd)
        return out.reshape(-1, s, d).narrow(0, dp.rank * b, b), aux
    out, aux = _moe_dispatch_flat(qcfg, cfg, x.reshape(b * s, d), router_w,
                                  wg, wu, wd)
    return out.reshape(b, s, d), aux


def _data_mean(aux: dict, rows: int) -> dict:
    """Per-row dispatch's aux on a training mesh: each stat's mean over
    every data rank's rows (one collective; the ranks' row counts
    weigh their means), so every rank reports the batch's."""
    dp = ctx.data()
    if dp is None or dp.size == 1:
        return aux
    n = torch.tensor(float(rows), device=aux["moe_dropped_frac"].device)
    tot = ctx.data_sum(torch.stack([aux["moe_dropped_frac"] * n,
                                    aux["moe_router_entropy"] * n, n]))
    return {"moe_dropped_frac": tot[0] / tot[2],
            "moe_router_entropy": tot[1] / tot[2]}


def _expert_layout(cfg, wg) -> str | None:
    """How this rank holds the expert stacks under TP, read from the gate
    stack's shape: "ep" (E/n experts, ``moe_shard="ep"``), "tp" (every
    expert's FFN dim split, ``moe_shard="tp"``, or E not dividing the
    group), or None (no context, or every expert whole on every rank)."""
    if ctx.current() is None:
        return None
    if wg.shape[0] != cfg.n_experts:
        return "ep"
    ffe = wg.codes.shape[-2] if isinstance(wg, PackedNVFP4) else wg.shape[-1]
    return "tp" if ffe != cfg.moe_d_ff else None


def _expert_ffn(qcfg, cfg, xe, wg, wu, wd):
    """Quantized SwiGLU over per-expert token slabs xe [..., E, C, d]; the
    input is fake-quantized once for the gate and up GEMMs.

    Under TP every rank holds the whole slab (routing is replicated) and
    quantizes it whole.  "ep": the rank runs its E/n experts, the hidden's
    QDQ takes the group's amax where its scope spans the experts, and the
    experts' outputs are all-gathered along E, so the combine sees every
    expert's bits.  "tp": gate and up column-parallel on the FFN dim, the
    down projection row-parallel (``_expert_down_tp``)."""
    layout = _expert_layout(cfg, wg)
    tp = ctx.current()
    if layout is not None:
        # the whole slab enters split products: its gradient is the sum of
        # every rank's (its experts', or its FFN columns')
        xe = ctx.copy_to_model(xe, tp)
    xq = qcfg.q_act(xe, "mlp")
    if layout == "ep":
        e_loc = wg.shape[0]
        xq = xq.narrow(-3, tp.rank * e_loc, e_loc)
    par = {"ep": "expert", "tp": "column"}.get(layout)
    g = qdense(qcfg, "mlp", xq, wg, contract_axis=1, quantize_act=False,
               parallelism=par)
    u = qdense(qcfg, "mlp", xq, wu, contract_axis=1, quantize_act=False,
               parallelism=par)
    h = silu(g) * u
    if layout == "tp":
        return _expert_down_tp(qcfg, h, wd, tp)
    if layout == "ep":
        # the group's amax is the slab's where the scope spans the experts:
        # the tensor, or a row ahead of them (the engine's per-row and
        # per-token dispatch); a flat slab's rows are its experts
        if not (qcfg.act_scope == "tensor"
                or (qcfg.act_scope == "row" and h.ndim > 3)):
            raise NotImplementedError(
                f"experts split over ranks with {qcfg.act_scope!r} "
                f"activation scales on a {h.ndim}-D slab: serve with per-row "
                "dispatch (moe_dispatch='local' or 'token')")
        h = qcfg.q_act(h, "mlp", tp)
        y = qdense(qcfg, "mlp", h, wd, contract_axis=1, quantize_act=False,
                   parallelism="expert")
        return ctx.gather_from_model(y, tp, -3)
    h = qcfg.q_act(h, "mlp")
    return qdense(qcfg, "mlp", h, wd, contract_axis=1, quantize_act=False)


def _expert_down_tp(qcfg, h, wd, tp):
    """The down projection of FFN-split experts: ``h`` [..., E, C, ffe/n]
    holds this rank's features.  Where they are whole 16-element blocks
    the QDQ takes the group's amax and ``wd``'s rows multiply them, the
    f32 partials summed over the group.  Where blocks cross the cut, the
    hidden is all-gathered and quantized whole; a replicated ``wd`` (its
    packed K could not split) then runs whole with no sum, a split one on
    the rank's features of the quantized hidden, or, where its dense tile
    is fake-quantized at run time (training), gathered whole too."""
    f_loc = h.shape[-1]
    packed = isinstance(wd, PackedNVFP4)
    whole = (wd.k if packed else wd.shape[-2]) != f_loc
    if whole or f_loc % BLOCK:
        hq = qcfg.q_act(ctx.gather_from_model(h, tp, -1), "mlp")
        if not (whole or packed) and qcfg.quantize_weights:
            # a dense tile fake-quantized at run time (training on a mesh)
            # would take blocks across its cut: the stack is gathered and
            # quantized whole, and every rank runs the whole product
            wd = ctx.gather_from_model(wd, tp, -2)
            whole = True
        if whole:
            return qdense(qcfg, "mlp", hq, wd, contract_axis=1,
                          quantize_act=False)
        hq = hq.narrow(-1, tp.rank * f_loc, f_loc)
    else:
        hq = qcfg.q_act(h, "mlp", tp)
    wr = qcfg.resolve_weight(wd, "mlp", 1)
    _probe_packed(qcfg, "mlp", wr, tp)
    _note_gemm("dequant" if packed else "dense", wr)
    w = ops.dequant_weight(wr, 1, hq.dtype) if packed else wr
    part = _moe_einsum(hq, w, torch.float32)
    return ctx.reduce_from_model(part, tp).to(
        torch.promote_types(hq.dtype, w.dtype))


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index (a stable descending sort keeps tied entries in order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(qcfg, cfg, x, router_w):
    """Router, top-k and sorted capacity dispatch over rows x [R, N, d]
    (R capacity domains of N tokens each).

    Returns (buf_tok [R, E * cap] token of each expert slot, 0 for an empty
    slot; the combine plan (dst [R, N, k] slot of each kept (token, choice)
    in expert order, keep [R, N, k], weight [R, N, k]); cap; aux)."""
    r, n, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    dev = x.device
    if router_w.shape[-1] != e:
        # the router's E split over the group: every rank gathers every
        # expert's logit, so every rank routes (and drops) alike; the
        # tokens' gradient sums every rank's experts'
        tp = ctx.current()
        logits = ctx.gather_from_model(
            qdense(qcfg, "router", ctx.copy_to_model(x, tp), router_w), tp, -1)
    else:
        logits = qdense(qcfg, "router", x, router_w)
    gates = torch.softmax(logits.to(torch.float32), -1)              # [R,N,E]
    topw, topi = _top_k(gates, k)                                    # [R,N,k]
    topw = topw / torch.clamp_min(torch.sum(topw, -1, keepdim=True), 1e-9)

    flat_e = topi.reshape(r, n * k)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k).expand(r, n * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.take_along_dim(flat_e, order, 1)
    st = torch.take_along_dim(flat_t, order, 1)
    # position within each expert's segment, per row
    seg_start = torch.sum(se[:, None, :] < torch.arange(e, device=dev)[None, :, None], -1)
    pos_in_e = (torch.arange(n * k, device=dev)[None]
                - torch.take_along_dim(seg_start, se, 1))
    cap = int(max(1, (n * k * cfg.capacity_factor) // e))
    keep = pos_in_e < cap
    dropped = 1.0 - torch.mean(keep.to(torch.float32))

    # expert slots [R, E * cap]: dropped entries land in a garbage slot
    dst = torch.where(keep, se * cap + torch.clamp(pos_in_e, 0, cap - 1),
                      e * cap)
    rows = torch.arange(r, device=dev)[:, None]
    buf_tok = torch.zeros((r, e * cap + 1), dtype=torch.int64, device=dev)
    buf_tok[rows, dst] = st
    # the combine plan, back in (token, choice) order, choices sorted by
    # expert: the order in which the reference's scatter-add reaches a token
    dst_tc = torch.empty_like(dst).scatter_(1, order, dst).reshape(r, n, k)
    keep_tc = torch.empty_like(keep).scatter_(1, order, keep).reshape(r, n, k)
    by_e = torch.argsort(topi, dim=-1, stable=True)
    plan = tuple(torch.take_along_dim(a, by_e, -1)
                 for a in (dst_tc, keep_tc, topw))
    aux = {"moe_dropped_frac": dropped,
           "moe_router_entropy": -torch.mean(torch.sum(
               gates * torch.log(gates + 1e-9), -1))}
    return buf_tok[:, :-1], plan, cap, aux


def _combine(ye: torch.Tensor, plan) -> torch.Tensor:
    """out[r, t] = sum over token t's kept choices of ye[r, slot] * weight,
    in f32, added in expert order from +0: the reference's scatter-add
    (``_batched_scatter_add``), which XLA applies in slot order, as a
    gather and a fixed-order sum, the same on every device (no atomics).
    A dropped choice adds -0.0 (an exact identity); the reference's empty
    slots add ye * 0 to token 0, which leaves a sum unchanged.

    ye [R, E * cap, d]; plan (dst, keep, weight) [R, N, k] -> [R, N, d] f32.
    """
    dst, keep, w = plan
    r, n, k = dst.shape
    d = ye.shape[-1]
    slot = torch.where(keep, dst, 0).reshape(r, n * k, 1).expand(r, n * k, d)
    c = torch.gather(ye, 1, slot).reshape(r, n, k, d).to(torch.float32) * w[..., None]
    c = torch.where(keep[..., None], c, torch.full_like(c, -0.0))
    out = torch.zeros((r, n, d), dtype=torch.float32, device=ye.device)
    for j in range(k):
        out = out + c[:, :, j]
    return out


class _Dispatch(torch.autograd.Function):
    """The expert slots' tokens: forward ``xe[r, slot] = x[r, buf_tok[r,
    slot]]``; backward each token's gradient as the sum of its kept
    choices' slots' gradients in the plan's order (the slots' order),
    added in the gradient's dtype: what the indexing's own backward sums
    on the CPU, but a gather, with no atomics, so the card gives every
    rank the same bits.  An empty slot holds token 0 and a dropped choice
    no slot; neither reaches the combine, so their gradients are zero and
    are left out."""

    @staticmethod
    def forward(ctx, x, buf_tok, dst, keep):
        ctx.save_for_backward(dst, keep)
        return torch.take_along_dim(x, buf_tok[:, :, None], 1)

    @staticmethod
    def backward(ctx, g):
        dst, keep = ctx.saved_tensors
        r, n, k = dst.shape
        slot = torch.where(keep, dst, 0).reshape(r, n * k, 1)
        got = torch.take_along_dim(g, slot, 1).reshape(r, n, k, -1)
        got = torch.where(keep[..., None], got, torch.zeros_like(got))
        dx = got[:, :, 0]
        for j in range(1, k):
            dx = dx + got[:, :, j]
        return dx, None, None, None


def _dispatch(x: torch.Tensor, buf_tok: torch.Tensor, plan) -> torch.Tensor:
    """x [R, N, d] -> the expert slots' tokens [R, E * cap, d]."""
    return _Dispatch.apply(x, buf_tok, plan[0], plan[1])


def _moe_dispatch_local(qcfg, cfg, x, router_w, wg, wu, wd):
    """Per-batch-row dispatch: each row of x [B, S, d] is its own capacity
    domain; the expert slabs are [B, E, cap, d]."""
    b, s, d = x.shape
    e = cfg.n_experts
    buf_tok, plan, cap, aux = _route(qcfg, cfg, x, router_w)
    xe = _dispatch(x, buf_tok, plan).reshape(b, e, cap, d)
    ye = _expert_ffn(qcfg, cfg, xe, wg, wu, wd)
    out = _combine(ye.reshape(b, e * cap, d), plan)
    return out.to(x.dtype), aux


def _moe_dispatch_flat(qcfg, cfg, xf, router_w, wg, wu, wd):
    """One capacity domain over a flat [T, d] token slab; the expert slabs
    are [E, cap, d]."""
    t, d = xf.shape
    e = cfg.n_experts
    buf_tok, plan, cap, aux = _route(qcfg, cfg, xf[None], router_w)
    xe = _dispatch(xf[None], buf_tok, plan).reshape(e, cap, d)
    ye = _expert_ffn(qcfg, cfg, xe, wg, wu, wd)
    out = _combine(ye.reshape(1, e * cap, d), plan)[0]
    return out.to(xf.dtype), aux
