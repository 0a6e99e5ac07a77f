"""The amax scopes of the port's ``nvfp4_qdq`` op (K1) and the key split of
its ``paged_attention`` kernel (K7), against the JAX package, on the CPU.

The reference's Pallas kernels run once per module in a subprocess, in
interpret mode, with ``XLA_FLAGS=--xla_allow_excess_precision=false`` as
the other parity tests run the reference; the inputs are made here from
numpy seeds and handed over as numpy arrays.

Parity levels:

* **bitwise**: ``ops.nvfp4_qdq(x, scope=...)`` (its plain version on the
  CPU) against ``ref.nvfp4_qdq_ref`` with the scope's amax taken by torch,
  against the reference's ``nvfp4_qdq`` kernel given each segment's amax,
  and ``QuantConfig.q_act`` against its former form (the amax a torch
  reduction handed to the op);
* **plan**: the key ranges ``paged_attention.key_ranges`` gives the
  blocks of a cluster tile each query row's keys exactly once, never
  reach a page past its pos, and equal a one-query call's at that pos;
* **tolerance**: a torch model of the kernel's three exchanges (row max,
  sum of exp, p V partials, each combined in split order) within K7's
  tolerance (one bf16 ulp of the larger value plus 1e-3, as on the card)
  of ``paged_attention.plain`` and of the reference's kernel.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import qconfig
from repro_torch.kernels import nvfp4_qdq as kqdq
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as kpa

K7_ATOL = 1e-3
# K1: (shape, K of the op: the last dim padded to a multiple of 16)
QDQ_SHAPES = [(8, 1, 48), (1, 40, 64), (3, 5, 48), (2, 3, 40)]
SCOPES = ["tensor", "row", "token"]
# K7 cases: (name, B, S, H, Hkv, hd, bs, MB, window, fp8); two pool layers
# each, pos drawn below
K7_CASES = [("decode", 4, 1, 4, 2, 32, 8, 32, 0, False),
            ("s3", 3, 3, 4, 2, 32, 8, 24, 0, False),
            ("window", 4, 3, 4, 1, 32, 8, 24, 20, False),
            ("fp8", 3, 2, 6, 2, 32, 16, 12, 0, True)]
N_LAYERS = 2


def _qdq_input(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape) * 3.0
    x[..., :16].flat[:16] = 0.0           # an all-zero block
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _padded(x):
    return F.pad(x, (0, (-x.shape[-1]) % 16))


def _segments(shape, scope):
    """(segments, rows of the reference kernel per segment) of a shape."""
    rows = int(np.prod(shape[:-1]))
    if scope == "tensor":
        return 1, rows
    if scope == "row":
        return shape[0], rows // shape[0]
    return rows, 1


def _k7_inputs(i, layer):
    """Pages, tables, queries and pos of K7 case ``i`` and pool layer
    ``layer``: bf16 pages, or e4m3 pages with one f32 scale per row."""
    name, b, s, h, hkv, hd, bs, mb, window, fp8 = K7_CASES[i]
    rng = np.random.default_rng(100 * i + layer)
    n_blocks = b * mb + 3
    k = torch.from_numpy(rng.standard_normal((n_blocks, bs, hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n_blocks, bs, hkv, hd)).astype(np.float32))
    if fp8:
        def quant(t):
            sc = t.abs().amax(-1).clamp_min(1e-30) / 448.0
            return (t / sc[..., None]).to(torch.float8_e4m3fn), sc
        (k, ks), (v, vs) = quant(k), quant(v)
        pool = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        pool = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    bt = torch.from_numpy(rng.permutation(n_blocks)[: b * mb].reshape(b, mb)
                          .astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32)
                         ).to(torch.bfloat16)
    # the first request at pos 1 (or its first query), the second at the
    # table's end, the others in between; queries of a request consecutive
    top = rng.integers(s, mb * bs + 1, size=b)
    top[0], top[1] = s, mb * bs
    pos = torch.from_numpy((top[:, None] - s + 1 + np.arange(s)[None, :])
                           .astype(np.int32))
    if s == 1:
        pos = pos[:, 0]
    return q, pool, bt, pos, window


def _reference_inputs():
    """Every reference input as numpy arrays: per K1 shape the padded x
    (bf16 values in f32) and one amax per row for each scope; per K7 case
    and layer the queries, pages (bf16 values in f32, or e4m3 bytes and
    scales), tables, pos and window."""
    res = {}
    for shape in QDQ_SHAPES:
        xp = _padded(_qdq_input(shape)).float()
        res[f"qdq/{shape}/x"] = xp.numpy()
        for scope in SCOPES:
            n_seg, rows = _segments(shape, scope)
            segs = xp.reshape(n_seg, rows, xp.shape[-1])
            amax = segs.abs().amax(dim=(1, 2))
            res[f"qdq/{shape}/{scope}/amax"] = amax.repeat_interleave(rows).numpy()
    for i, case in enumerate(K7_CASES):
        for layer in range(N_LAYERS):
            q, pool, bt, pos, window = _k7_inputs(i, layer)
            key = f"k7/{case[0]}/{layer}"
            res[f"{key}/q"] = q.float().numpy()
            for name, t in pool.items():
                res[f"{key}/{name}"] = (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                                        else t.float()).numpy()
            res[f"{key}/bt"], res[f"{key}/pos"] = bt.numpy(), pos.numpy()
            res[f"{key}/window"] = np.asarray(window)
    return res


# The reference's kernels on those inputs (run as a script in the JAX
# subprocess: argv[1] inputs, argv[2] outputs).  The reference's QDQ kernel
# takes one amax a call; being blockwise given it, it runs once per row of
# x with that row's segment amax (vmapped), one compile per shape.
_REFERENCE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.kernels.nvfp4_qdq import nvfp4_qdq
from repro.kernels.paged_attention import paged_attention

inp, res = dict(np.load(sys.argv[1])), {}
qdq = jax.vmap(lambda row, amax: nvfp4_qdq(row, amax, interpret=True))
for name in [k for k in inp if k.startswith("qdq/") and k.endswith("/x")]:
    shape = name[len("qdq/"):-len("/x")]
    x = inp[name]
    rows = x.reshape(-1, 1, x.shape[-1])
    scopes = ("tensor", "row", "token")
    amax = np.concatenate([inp[f"qdq/{shape}/{s}/amax"] for s in scopes])
    out = np.asarray(qdq(jnp.asarray(np.concatenate([rows] * 3)).astype(jnp.bfloat16),
                         jnp.asarray(amax)).astype(jnp.float32))
    for s, o in zip(scopes, np.split(out, 3)):
        res[f"qdq/{shape}/{s}"] = o.reshape(x.shape)
for name in [k for k in inp if k.startswith("k7/") and k.endswith("/q")]:
    key = name[:-len("/q")]
    fp8 = f"{key}/k_scale" in inp
    def page(n):
        a = jnp.asarray(inp[f"{key}/{n}"])
        if fp8:
            return jax.lax.bitcast_convert_type(a, jnp.float8_e4m3fn)
        return a.astype(jnp.bfloat16)
    scales = ((jnp.asarray(inp[f"{key}/k_scale"]), jnp.asarray(inp[f"{key}/v_scale"]))
              if fp8 else (None, None))
    out = paged_attention(jnp.asarray(inp[name]).astype(jnp.bfloat16), page("k"),
                          page("v"), jnp.asarray(inp[f"{key}/bt"]),
                          jnp.asarray(inp[f"{key}/pos"]), *scales,
                          window=int(inp[f"{key}/window"]), interpret=True)
    res[key] = np.asarray(out.astype(jnp.float32))
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The reference's outputs, computed once in a JAX subprocess."""
    tmp = tmp_path_factory.mktemp("jax_attn_qdq_ref")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inp, **_reference_inputs())
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(here, "..", "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, inp, out], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return dict(data)


def _bits(t):
    return t.float().contiguous().view(torch.int32)


# ---- K1: the amax scopes ----------------------------------------------------

@pytest.mark.parametrize("scope", SCOPES)
@pytest.mark.parametrize("shape", QDQ_SHAPES, ids=str)
def test_qdq_scope_matches_torch_amax_and_reference(jref, shape, scope):
    """Bitwise: the op with a scope equals the plain version given the
    scope's amax taken by torch, and the reference's kernel given each
    segment's amax (the last dim padded with zeros to 16)."""
    xp = _padded(_qdq_input(shape))
    got = ops.nvfp4_qdq(xp, scope=scope)
    dims = {"tensor": tuple(range(xp.ndim)), "row": tuple(range(1, xp.ndim)),
            "token": -1}[scope]
    amax = torch.amax(torch.abs(xp.float()), dim=dims, keepdim=True)
    assert got.dtype == torch.bfloat16 and got.shape == xp.shape
    assert torch.equal(_bits(got), _bits(ref.nvfp4_qdq_ref(xp, amax)))
    np.testing.assert_array_equal(
        got.float().numpy().view(np.uint32),
        jref[f"qdq/{shape}/{scope}"].view(np.uint32))


@pytest.mark.parametrize("scope", SCOPES)
@pytest.mark.parametrize("shape", QDQ_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q_act_unchanged_by_scope(shape, scope, dtype):
    """Bitwise: ``q_act`` hands the scope to the op; its output is what it
    was when it took the amax with torch ops and handed that over."""
    x = _qdq_input(shape).to(dtype)
    got = qconfig.QuantConfig(act_scope=scope).q_act(x, "mlp")
    amax = None                                   # the tensor scope's
    if scope != "tensor":
        dims = tuple(range(1, x.ndim)) if scope == "row" else -1
        amax = torch.amax(torch.abs(x.to(torch.float32)), dim=dims, keepdim=True)
    want = qconfig._fq_lastdim(x, amax)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))


def test_qdq_plan_modes():
    """The launch plan: a segment within a block, within a cluster of up
    to 8 blocks, or in the cooperative two-pass grid (one workspace slot
    per 1024-block chunk)."""
    def mode(shape, scope):
        seg = kqdq.segment(shape, scope) // 16
        return kqdq.plan(int(np.prod(shape)) // 16, seg, False)
    assert mode((8, 1, 3584), "row") == ("local", 0)
    assert mode((16, 3584), "token") == ("local", 0)
    assert mode((8, 1, 18944), "row") == ("cluster", 0)
    assert mode((4, 1, 3584), "tensor") == ("cluster", 0)
    assert mode((1, 512, 18944), "row") == ("two_pass", 592)
    assert mode((8, 512, 2048), "tensor") == ("two_pass", 512)
    assert mode((4096, 8192), "tensor") == ("two_pass", 2048)
    assert kqdq.plan(10, 10, True) == ("external", 0)
    with pytest.raises(ValueError):
        kqdq.segment((48,), "row")


@pytest.mark.parametrize("amax_shape,seg", [((), 8 * 5 * 48), ((8, 1, 1), 5 * 48),
                                            ((8, 5, 1), 48), ((1, 5, 1), 48)])
def test_qdq_external_amax_segments(amax_shape, seg):
    """A caller's amax maps to one value per segment of the flat tensor
    (a broadcast that is no keepdim prefix is expanded per last-dim
    vector); an amax that varies along the blocked dim is refused."""
    amax = torch.arange(1, 1 + int(np.prod(amax_shape))).float().reshape(amax_shape)
    flat, got_seg = kqdq._external(amax, (8, 5, 48))
    assert got_seg == seg
    want = torch.broadcast_to(amax, (8, 5, 1)).reshape(-1)
    assert torch.equal(flat.repeat_interleave(seg // 48), want)
    with pytest.raises(ValueError):
        kqdq._external(torch.ones(8, 5, 48), (8, 5, 48))


# ---- K7: the key split ------------------------------------------------------

PLAN_CASES = [  # (B, S, n_rep, MB, bs, window)
    (8, 1, 7, 34, 16, 0), (1, 16, 7, 34, 16, 0), (1, 16, 7, 34, 16, 40),
    (4, 3, 2, 32, 8, 0), (4, 3, 4, 24, 8, 20), (2, 1, 7, 260, 16, 0),
    (3, 2, 3, 12, 16, 0), (5, 1, 1, 3, 5, 0), (2, 4, 2, 40, 7, 9)]


def _plan_pos(b, s, mb, bs, seed):
    """Consecutive queries per request, the first request at pos 1, the
    second at the table's end; pos [B] for S = 1, else [B, S]."""
    rng = np.random.default_rng(seed)
    top = rng.integers(s, mb * bs + 1, size=b)
    top[0] = s
    if b > 1:
        top[1] = mb * bs
    pos = top[:, None] - s + 1 + np.arange(s)[None, :]
    return torch.from_numpy(pos[:, 0] if s == 1 else pos)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_split_plan_tiles_each_key_range_once(case):
    """Each query row's blocks take contiguous key ranges that tile its
    keys [window start, pos) exactly once, start at multiples of 16 (but
    the first), and read no page past its pos; a row's ranges are those a
    one-query call at the same pos gives (its split depends on its own pos
    alone), and the plan's split count does not depend on S."""
    b, s, n_rep, mb, bs, window = case
    plan = kpa.split_plan(s, n_rep, mb, bs, 128, window)
    assert 1 <= plan.n_split <= kpa.MAX_SPLIT
    assert plan.n_split == kpa.split_plan(1, n_rep, mb, bs, 128, window).n_split
    assert plan.row_blocks == -(-(n_rep * s) // kpa.ROWS)
    assert plan.chunk % 16 == 0 and plan.smem <= kpa.MAX_SMEM
    for seed in range(3):
        pos = _plan_pos(b, s, mb, bs, seed)
        for n_split in {plan.n_split, 1, kpa.MAX_SPLIT}:
            ranges = kpa.key_ranges(pos, s, n_rep, mb, bs, window, n_split)
            pos2 = pos[:, None].expand(b, s) if pos.ndim == 1 else pos
            for bi in range(b):
                for g_all in range(n_rep * s):
                    p = int(pos2[bi, g_all % s])
                    lo = max(p - window, 0) if window else 0
                    hi = min(p, mb * bs)
                    keys = []
                    row = ranges[bi, g_all // 16, g_all % 16]
                    for r, (klo, khi) in enumerate(row.tolist()):
                        assert klo <= khi
                        if klo < khi:
                            assert r == 0 or klo % 16 == 0 or klo == lo
                            # the page of its last key holds a valid key
                            assert (khi - 1) // bs <= (hi - 1) // bs
                        keys += range(klo, khi)
                    assert keys == list(range(lo, hi))
                    one = kpa.key_ranges(torch.tensor([p]), 1, 1, mb, bs,
                                         window, n_split)[0, 0, 0]
                    assert torch.equal(row, one)


def _ulp_tol(got, want):
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(big)) - 7) + K7_ATOL


def _emulate(q, pool, bt, pos, window, n_split=None):
    """The kernel's arithmetic in torch: per query row and block, the f32
    scores of the row's part of its keys; the row max over the blocks;
    each block's sum of exp with it, the sums added in split order; p
    rounded to bf16 and each block's p V partial, the partials added in
    split order."""
    b, s, h, hd = q.shape
    bs, hkv = pool["k"].shape[1], pool["k"].shape[2]
    mb = bt.shape[1]
    n_rep = h // hkv
    plan = kpa.split_plan(s, n_rep, mb, bs, hd, window)
    n_split = n_split or plan.n_split
    ranges = kpa.key_ranges(pos, s, n_rep, mb, bs, window, n_split)
    kd, vd = kpa.gather(pool, bt)                # [B, MB * bs, Hkv, hd] bf16
    pos2 = (pos[:, None].expand(b, s) if pos.ndim == 1 else pos).long()
    scale = kpa._scale(hd)
    out = torch.zeros((b, s, h, hd))
    for bi in range(b):
        for kvh in range(hkv):
            for rb in range(plan.row_blocks):
                for gl, g in enumerate(range(rb * 16,
                                             min(n_rep * s, rb * 16 + 16))):
                    head, qi = kvh * n_rep + g // s, g % s
                    qr = q[bi, qi, head].float()[None]            # [1, hd]
                    parts = []
                    for klo, khi in ranges[bi, rb, gl].tolist():
                        keys = torch.arange(klo, khi)
                        sc = (qr @ kd[bi, keys, kvh].float().T) * scale
                        parts.append((sc, keys))
                    m = torch.full((1,), -torch.inf)
                    for sc, _ in parts:                           # exchange 1
                        if sc.shape[1]:
                            m = torch.maximum(m, sc.amax(1))
                    l = torch.zeros(1)
                    for sc, _ in parts:                           # exchange 2
                        l = l + torch.exp(sc - m[:, None]).sum(1)
                    o = torch.zeros((1, hd))
                    for sc, keys in parts:                        # exchange 3
                        pr = torch.exp(sc - m[:, None]) / l[:, None]
                        o = o + pr.to(torch.bfloat16).float() @ vd[bi, keys, kvh].float()
                    out[bi, qi, head] = o[0]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("layer", range(N_LAYERS))
@pytest.mark.parametrize("i", range(len(K7_CASES)), ids=[c[0] for c in K7_CASES])
def test_emulated_exchanges_match_plain_and_reference(jref, i, layer):
    """Tolerance: the three exchanges in split order, with the plan's
    split and with 8 blocks a cluster, within K7's tolerance of the plain
    version and of the reference's kernel; the plain version against the
    reference's kernel too."""
    q, pool, bt, pos, window = _k7_inputs(i, layer)
    plain = kpa.plain(q, pool, bt, pos, window=window).float()
    want = torch.from_numpy(jref[f"k7/{K7_CASES[i][0]}/{layer}"])
    assert bool(((plain - want).abs() <= _ulp_tol(plain, want)).all())
    for n_split in (None, kpa.MAX_SPLIT):
        got = _emulate(q, pool, bt, pos, window, n_split).float()
        assert bool(((got - plain).abs() <= _ulp_tol(got, plain)).all())
        assert bool(((got - want).abs() <= _ulp_tol(got, want)).all())


def test_paged_attention_op_takes_pos_as_given():
    """On the CPU the op is its plain version for pos [B] int32 and
    [B, S] int64 alike (the kernel reads both as they are)."""
    q, pool, bt, pos, window = _k7_inputs(1, 0)
    a = ops.paged_attention(q, pool, bt, pos.long(), window=window)
    b = ops.paged_attention(q, pool, bt, pos.int(), window=window)
    assert torch.equal(a, b)
    q1, pool1, bt1, pos1, _ = _k7_inputs(0, 0)
    assert torch.equal(ops.paged_attention(q1, pool1, bt1, pos1),
                       ops.paged_attention(q1, pool1, bt1, pos1[:, None].long()))
    assert dataclasses.asdict(kpa.split_plan(1, 7, 34, 16, 128)) == dict(
        n_split=6, row_blocks=1, chunk=96, smem=kpa.smem_bytes(128, 96, 34))
