"""Paged attention for the serving engine: CUDA kernel for Hopper and its
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_attention`` (body ``_attend_kernel``): page-table gather, FP8-KV
dequantization and grouped-query attention for one-token decode
(q_len 1) and multi-query verify / paged-prefill chunks (q_len k + 1), in
one launch, without a dense [B, MB * bs, Hkv, hd] copy of the pages.

The kernel (``csrc/paged_attention.cu``) gives a thread-block cluster to
each (request, KV head, up to 16 query rows) and splits each row's keys
over the cluster's blocks (``split_plan``, ``key_ranges``); the softmax is
taken in three exchanges through distributed shared memory (row max, sum
of exp, p V partials, each summed in split order), with no rescaling, and
q K^T and p V run on the tensor cores.  It keeps every rounding point of
the plain version and differs from it only in the order of f32 sums, so it
is held to a tolerance, not bitwise.  A row's split, and so its sums'
order, depends only on its own pos: each query's output is bitwise the one
a one-query call at its pos gives (the speculative verify's k + 1 queries
against the plain decode's one).  It reads only the pages that hold valid
keys.

Bound on the H100: bytes, the valid K and V pages (2 KB per token and
layer for acereason-7b).

The plain version is the reference's gather-then-attend arithmetic: every
one of the MB pages is gathered, FP8 pages are dequantized as
``bf16(f32(e4m3) * scale)``, and the softmax is max, exp, sum and division
in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
ROWS = 16                # query rows per cluster (the MMA's M)
TILE = 16                # keys per MMA step; parts start at multiples of it
MAX_SPLIT = 8            # blocks per cluster (the portable limit)
KEYS_PER_BLOCK = 96      # the split's aim: about this many keys a block
MAX_CHUNK = 128          # keys a block holds in shared memory at once
MAX_SMEM = 232448        # shared memory a block can use on Hopper


def _scale(hd: int) -> float:
    """1 / sqrt(hd) in f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _pos2(pos: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """Per-query valid-key counts [B, S] from [B] or [B, S]."""
    pos = pos.to(torch.int32)
    return torch.broadcast_to(pos[:, None] if pos.ndim == 1 else pos, (b, s))


def dequant(vals: torch.Tensor, scale: torch.Tensor | None,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Pool pages in ``dtype``: bf16 pages as they are, e4m3 pages as
    ``(f32(e4m3) * scale).to(dtype)`` with one f32 scale per row."""
    if scale is None:
        return vals.to(dtype)
    return (vals.to(torch.float32) * scale[..., None]).to(dtype)


def gather(pool_sl: dict, block_tables: torch.Tensor, dtype=torch.bfloat16):
    """Dense per-request views (k, v) [B, MB * bs, Hkv, hd] of the pages
    the tables name, dequantized to ``dtype``."""
    b, mb = block_tables.shape
    idx = block_tables.long()

    def dense(name):
        a = pool_sl[name]
        if a.dtype == torch.float8_e4m3fn:         # gather the bytes
            g = a.view(torch.uint8)[idx].view(a.dtype)
        else:
            g = a[idx]                              # [B, MB, bs, ...]
        return g.reshape(b, mb * g.shape[2], *g.shape[3:])

    fp8 = pool_sl.get("k_scale") is not None
    return (dequant(dense("k"), dense("k_scale") if fp8 else None, dtype),
            dequant(dense("v"), dense("v_scale") if fp8 else None, dtype))


def plain(q: torch.Tensor, pool_sl: dict, block_tables: torch.Tensor,
          pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """The plain PyTorch version: gather all MB pages, then attend.

    q [B, S, H, hd]; pool_sl {"k", "v" [n_blocks, bs, Hkv, hd], optional
    "k_scale", "v_scale" [n_blocks, bs, Hkv]}; block_tables [B, MB];
    pos [B] or [B, S] valid-key counts.  Returns [B, S, H, hd] in q's dtype.
    Several queries a row are attended one at a time, each as a one-query
    call: a BLAS product over one query row (a matrix-vector product) sums
    in another order than over several, and the verify step's query i
    must be bitwise the decode step's.
    """
    b, s, h, hd = q.shape
    if s > 1:
        pos2 = _pos2(pos, b, s)
        return torch.cat([plain(q[:, i:i + 1], pool_sl, block_tables,
                                pos2[:, i], window=window)
                          for i in range(s)], 1)
    k, v = gather(pool_sl, block_tables, q.dtype)
    n, hkv = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, s, hkv, h // hkv, hd).to(f32)  # head = kvh * n_rep + rep
    sc = torch.einsum("bsgrd,bngd->bgrsn", qg, k.to(f32)) * _scale(hd)
    key = torch.arange(n, device=q.device)
    qpos = _pos2(pos, b, s)[:, None, None, :, None]  # [B, 1, 1, S, 1]
    valid = key < qpos
    if window:
        valid = valid & (key >= qpos - window)
    sc = torch.where(valid, sc, NEG_INF)
    m = torch.amax(sc, -1, keepdim=True)
    e = torch.exp(sc - m)
    p = e / torch.sum(e, -1, keepdim=True)
    out = torch.einsum("bgrsn,bngd->bsgrd", p.to(q.dtype).to(f32), v.to(f32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q, k, v, k_scale, v_scale, block_tables, pos):
    if not all(t.is_cuda for t in (q, k, v, block_tables, pos)):
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got q "
                         f"on {q.device}, pages on {k.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_attention takes bf16 queries, got {q.dtype}")
    fp8 = k_scale is not None
    page_dtype = torch.float8_e4m3fn if fp8 else torch.bfloat16
    if k.dtype != page_dtype or v.dtype != page_dtype:
        raise TypeError(f"paged_attention takes {page_dtype} pages "
                        f"{'with' if fp8 else 'without'} scales, got "
                        f"{k.dtype} and {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,S,H,hd] and pages [n,bs,Hkv,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[3] != hd or h % k.shape[2] or hd % 16 or hd > 256:
        raise ValueError(f"head dims: q {tuple(q.shape)} against pages "
                         f"{tuple(k.shape)} (hd % 16 == 0, hd <= 256, "
                         "H % Hkv == 0)")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} for B={b}")
    if tuple(pos.shape) not in ((b,), (b, s)):
        raise ValueError(f"pos {tuple(pos.shape)} for B={b}, S={s}")
    for t in (k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("pool pages must be contiguous and 16-byte aligned")
    if fp8 and (v_scale is None or k_scale.shape != k.shape[:3]
                or v_scale.shape != k.shape[:3]):
        raise ValueError("FP8 pages take k_scale and v_scale [n, bs, Hkv]")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape: ``n_split`` blocks per cluster (the cluster
    shape is (n_split, 1, 1)), ``row_blocks`` clusters per (request, KV
    head), ``chunk`` keys a block stages at once, and the block's shared
    memory in bytes."""
    n_split: int
    row_blocks: int
    chunk: int
    smem: int


def _part_len(span: int, n_split: int) -> int:
    """Keys per part when ``span`` keys are cut into ``n_split`` parts at
    multiples of TILE (the kernel's ``cs``)."""
    per = -(-span // n_split)                 # ceil
    return -(-per // TILE) * TILE


def smem_bytes(hd: int, chunk: int, mb: int) -> int:
    """The kernel's shared memory: q, the K (then V) chunk and p in bf16;
    the score strip, the partial outputs the blocks send, their row maxes
    and sums, and the block's own in f32; the positions and the table row."""
    ldq = hd + 8
    return (2 * (ROWS * ldq + chunk * ldq + ROWS * (chunk + 8))
            + 4 * (ROWS * chunk + ROWS * hd + MAX_SPLIT + 2 * MAX_SPLIT * ROWS
                   + 4 * ROWS) + 4 * (3 * ROWS + mb))


def split_plan(s: int, n_rep: int, mb: int, bs: int, hd: int,
               window: int = 0) -> Plan:
    """The launch's plan from the shapes alone: pos stays on the device (a
    host copy would cost a synchronisation per launch).  The split count
    comes from the longest key range one query can have (the table, or
    the window), with about KEYS_PER_BLOCK keys a block: it does not depend
    on S, so a query is split alike in a one-query call.  The chunk covers
    a block's part for every row of a cluster (their pos differ by up to
    S - 1), or the block loops over chunks."""
    cap = mb * bs
    own = min(cap, window) if window else cap
    n_split = max(1, min(MAX_SPLIT, -(-own // KEYS_PER_BLOCK)))
    longest = min(cap, window + s - 1) if window else cap
    # a part starts at a multiple of TILE, so a range gains up to TILE - 1
    chunk = max(TILE, min(MAX_CHUNK, _part_len(longest + TILE - 1, n_split)))
    while smem_bytes(hd, chunk, mb) > MAX_SMEM and chunk > TILE:
        chunk -= TILE
    return Plan(n_split, -(-(n_rep * s) // ROWS), chunk,
                smem_bytes(hd, chunk, mb))


def row_parts(p: int, mb: int, bs: int, window: int,
              n_split: int) -> list[tuple[int, int]]:
    """The keys [lo, hi) each of the n_split blocks takes for one query
    row with ``p`` valid keys, as the kernel computes them: the row's keys
    run from its window's start to p, capped at the table; from that start
    rounded down to a multiple of TILE they are cut into n_split parts of
    ``_part_len`` keys.  A function of p alone."""
    j_lo = max(p - window, 0) if window else 0
    j_hi = min(p, mb * bs)
    base = j_lo - j_lo % TILE
    cs = _part_len(max(j_hi - base, 0), n_split)
    out = []
    for r in range(n_split):
        lo = max(j_lo, base + r * cs)
        out.append((lo, max(min(j_hi, base + (r + 1) * cs), lo)))
    return out


def key_ranges(pos: torch.Tensor, s: int, n_rep: int, mb: int, bs: int,
               window: int, n_split: int) -> torch.Tensor:
    """[B, row_blocks, ROWS, n_split, 2] int64: the keys [lo, hi) block r
    of a cluster takes for each of its rows (``row_parts``; rows past the
    last are empty).  Row g of cluster rb holds query (rb * ROWS + g) % S."""
    pos2 = _pos2(pos, pos.shape[0], s).to(torch.int64).cpu()
    b = pos2.shape[0]
    r_all = n_rep * s
    out = torch.zeros((b, -(-r_all // ROWS), ROWS, n_split, 2),
                      dtype=torch.int64)
    for bi in range(b):
        for g_all in range(r_all):
            p = int(pos2[bi, g_all % s])
            out[bi, g_all // ROWS, g_all % ROWS] = torch.tensor(
                row_parts(p, mb, bs, window, n_split))
    return out


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_tables: torch.Tensor, pos: torch.Tensor,
           k_scale: torch.Tensor | None = None,
           v_scale: torch.Tensor | None = None, *,
           window: int = 0) -> torch.Tensor:
    """Run the CUDA kernel: [B, S, H, hd] bf16 out.

    q is read through its strides and pos ([B] or [B, S], int32 or int64)
    as it is, so an engine step adds no device op besides the launch.
    Every table entry that addresses a valid key (key < max pos) must be a
    block id of the pool; the kernel reads no other entry.
    """
    _check(q, k, v, k_scale, v_scale, block_tables, pos)
    b, s, h, hd = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    if q.stride(-1) != 1:
        q = q.contiguous()
    bt = block_tables
    if bt.dtype != torch.int32 or bt.stride(1) != 1:
        bt = bt.to(torch.int32).contiguous()
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    pos_sb, pos_ss = (pos.stride(0), 0) if pos.ndim == 1 else pos.stride()
    fp8 = k_scale is not None
    if fp8:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
    plan = split_plan(s, h // hkv, bt.shape[1], bs, hd, window)
    q_vec = q.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in q.stride()[:3])
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().paged_attention(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if fp8 else None,
            v_scale.data_ptr() if fp8 else None, int(fp8), bt.data_ptr(),
            bt.stride(0), pos.data_ptr(), pos_sb, pos_ss,
            int(pos.dtype == torch.int64), out.data_ptr(), b, s, h, hkv, hd,
            bs, bt.shape[1], int(window), plan.n_split, plan.chunk,
            int(q_vec), _scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    return out


def key_range(pos: torch.Tensor, s: int, mb: int, bs: int,
              window: int = 0) -> torch.Tensor:
    """Keys each request's queries can see: from the window's start to its
    largest pos, capped at the table, [B]."""
    pos2 = _pos2(pos, pos.shape[0], s).to(torch.int64)
    hi = torch.clamp(pos2.amax(1), max=mb * bs)
    lo = torch.clamp(pos2.amin(1) - window, min=0) if window else torch.zeros_like(hi)
    return torch.clamp(hi - lo, min=0)


def bytes_moved(q: torch.Tensor, k: torch.Tensor, block_tables: torch.Tensor,
                pos: torch.Tensor, fp8: bool, window: int = 0) -> int:
    """Bytes the function must move on these inputs: q read and out
    written once, and the K and V rows (with their scales for FP8) of the
    keys the queries can see, once per KV head."""
    b, s, h, hd = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    keys = int(key_range(pos, s, block_tables.shape[1], bs, window).sum())
    per_key = 2 * hkv * (hd * k.element_size() + (4 if fp8 else 0))
    return 2 * q.numel() * q.element_size() + keys * per_key


def flops(q: torch.Tensor, k: torch.Tensor, block_tables: torch.Tensor,
          pos: torch.Tensor, window: int = 0) -> int:
    """Multiply-adds of q K^T and p V over the keys the queries can see,
    two operations each."""
    b, s, h, hd = q.shape
    keys = int(key_range(pos, s, block_tables.shape[1], k.shape[1], window).sum())
    return 4 * keys * (h // k.shape[2]) * s * k.shape[2] * hd
