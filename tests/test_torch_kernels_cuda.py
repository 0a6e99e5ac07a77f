"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode.  The file imports no JAX, so the machine with the card
runs it as it is (that machine has no JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: ``nvfp4_qdq`` bitwise (the same f32 operations in the same
order), with the amax the caller's or the kernel's own in every scope, a
NaN where the plain version has one; ``nvfp4_matmul`` (K2) and ``nvfp4_matmul_grouped`` (K3) within
one bf16 ulp of the plain version's f32 product plus 2^-20 * (|x| @ |W|^T),
a bound on summing the same exact products in another f32 order, and K3
bitwise equal to K2 on every group's slices (one device code); a token's
output row bitwise the same at every M (row invariance: one K order for
the decode and the tensor-core tile forms).  The KL forward (K5): per-token KL within
rtol 1e-4 plus 16 f32 ulps of |z_t| + |z_s| (KL is a small difference of
two terms of about log V, and the two versions sum e^x in other orders),
each logsumexp within 8 ulps; KL exactly 0 for identical logits.  The KL
backward (K6), given the same logsumexps: within one ulp of its output
dtype of the plain version's f32 value, plus 4 f32 ulps of
(p_s + p_t) |g| for the two ``expf``.  K4 (``nvfp4_matmul_tp``): each
rank tile through K2 within K2's bound; the row-mode sum of the tiles' f32
partials within 2^-20 * (|x| @ |W|^T) of the full-K plain product (the
same exact products summed in another order).  Paged attention (K7): within one
bf16 ulp of the larger of the kernel's and the plain version's values,
plus 1e-3: the two sum the dot products, the exps and p V in other f32
orders, which moves a rare probability by one bf16 ulp (about 1e-4 of
the output at these shapes); each query's rows of a multi-query call
bitwise those of a one-query call at the same position (a row's split of
its keys depends on its own position alone).  ``core.nvfp4.fp8_quantize``
(the FP8 KV writes) bitwise the CPU's.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.core import nvfp4
from repro_torch.kernels import kl_loss as kkl
from repro_torch.kernels import nvfp4_qdq as kqdq
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as kpa

K7_ATOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the plain versions' f32 products must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _matmul_ok(x, p, out_dtype=torch.bfloat16):
    y = ops.nvfp4_matmul(x, p, out_dtype).float()
    y32 = ref.nvfp4_matmul_ref(x, p, torch.float32)
    w = nvfp4.unpack(p, torch.bfloat16).float()[:, : p.k]
    bound = 2.0 ** -20 * (x.float().abs() @ w.abs().T)
    if out_dtype == torch.bfloat16:
        bound += torch.exp2(torch.floor(torch.log2(y32.abs().clamp_min(1e-30))) - 7)
    return bool(((y - y32).abs() <= bound).all())


@pytest.mark.parametrize("shape", [(4, 3584), (256, 18944), (3, 5, 48), (1, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scope", ["tensor", "row", "token"])
def test_qdq_kernel_bitwise(gen, shape, dtype, scope):
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
    x.view(-1)[:16] = 0.0                     # an all-zero block
    amax = None
    if scope == "row":
        amax = x.float().abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    elif scope == "token":
        amax = x.float().abs().amax(dim=-1, keepdim=True)
    got = ops.nvfp4_qdq(x, amax)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(ref.nvfp4_qdq_ref(x, amax)))


def _qdq_equal(got, want):
    """Bitwise, a NaN matching a NaN (the kernel's NaN payload may differ)."""
    torch.cuda.synchronize()
    gn, wn = torch.isnan(got), torch.isnan(want)
    return torch.equal(gn, wn) and torch.equal(_bits(got)[~gn], _bits(want)[~wn])


def _device_ops(fn):
    """Names of the device kernels and copies one call of ``fn`` runs.  The
    profiler now and then drops a kernel's record but never adds one: 32
    spin kernels are recorded ahead of the call (and left out), and an
    empty profile is taken again, three in all (as ``chip_smoke.py``'s
    ``device_ops``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        if names:
            return names
    return names


# the engine's and the trainer's QDQ sites: decode rows (one block and a
# cluster), the exact-prefill row and the training tensor (two passes), a
# paged chunk's tokens; nemotron-nano-9b-sim's decode rows (d_model 4480,
# d_ff 15680: 980 blocks of 16, not a multiple of 128 values)
QDQ_SCOPED = [((8, 1, 3584), "row"), ((8, 1, 18944), "row"),
              ((1, 512, 18944), "row"), ((16, 3584), "token"),
              ((4096, 8192), "tensor"), ((8, 512, 2048), "tensor"),
              ((1, 16, 18944), "token"), ((3, 5, 48), "row"),
              ((8, 1, 4480), "row"), ((8, 1, 15680), "row"),
              # rwkv6-3b's decode rows (d_model 2560, d_ff 8960)
              ((8, 1, 2560), "row"), ((8, 1, 8960), "row")]


@pytest.mark.parametrize("shape,scope", QDQ_SCOPED, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qdq_kernel_own_amax_bitwise(gen, shape, scope, dtype):
    """The kernel takes the scope's amax itself: bitwise equal to the plain
    version with the amax taken by torch."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
    x.view(-1)[:16] = 0.0
    got = ops.nvfp4_qdq(x, scope=scope)
    assert got.dtype == dtype and got.shape == x.shape
    assert _qdq_equal(got, ref.nvfp4_qdq_ref(x, None, scope))


@pytest.mark.parametrize("scope", ["tensor", "row", "token"])
@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1), (torch.bfloat16, 2),
                                          (torch.bfloat16, 4), (torch.float32, 1),
                                          (torch.float32, 2)])
def test_qdq_kernel_misaligned_view(gen, scope, dtype, offset):
    """A view that starts off a 16-byte boundary is read in place with
    narrower loads, in every scope and with the caller's amax."""
    base = (torch.randn(8 * 18944 + 16, generator=gen, device="cuda") * 3).to(dtype)
    x = base[offset:offset + 8 * 18944].view(8, 1, 18944)
    assert x.data_ptr() % 16
    assert _qdq_equal(ops.nvfp4_qdq(x, scope=scope), ref.nvfp4_qdq_ref(x, None, scope))
    amax = kqdq.scope_amax(x, scope)
    assert _qdq_equal(ops.nvfp4_qdq(x, amax), ref.nvfp4_qdq_ref(x, amax))


@pytest.mark.parametrize("shape,scope", [((8, 1, 3584), "row"), ((8, 1, 18944), "row"),
                                         ((8, 512, 2048), "tensor"),
                                         ((16, 3584), "token")], ids=str)
def test_qdq_kernel_nan_and_inf(gen, shape, scope):
    """A NaN or an inf in x: the kernel's amax propagates a NaN as
    torch.amax does, so every segment the plain version makes NaN is NaN
    and the others are bitwise equal; with the caller's finite amax only
    the NaN's block is NaN."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    flat = x.view(-1)
    flat[100] = float("nan")
    flat[flat.numel() - 5] = float("inf")
    want = ref.nvfp4_qdq_ref(x, None, scope)
    assert bool(torch.isnan(want).any())
    assert _qdq_equal(ops.nvfp4_qdq(x, scope=scope), want)
    amax = torch.full((), 4.0, device="cuda")
    assert _qdq_equal(ops.nvfp4_qdq(x, amax), ref.nvfp4_qdq_ref(x, amax))


@pytest.mark.parametrize("shape,scope", [((8, 1, 3584), "row"), ((8, 1, 18944), "row"),
                                         ((1, 512, 18944), "row"),
                                         ((1, 16, 3584), "token"),
                                         ((8, 512, 2048), "tensor")], ids=str)
def test_qdq_scope_is_one_device_kernel(gen, shape, scope):
    """One ``ops.nvfp4_qdq`` call with a scope runs one device kernel and
    nothing else (no amax reduction, copy or memset)."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    names = _device_ops(lambda: ops.nvfp4_qdq(x, scope=scope))
    assert len(names) == 1 and "qdq" in names[0], names


@pytest.mark.parametrize("m,k,n", [(4, 3584, 4608), (4, 18944, 3584),
                                   (256, 3584, 3584), (1, 48, 40),
                                   (33, 80, 200), (9, 256, 96),
                                   # wd at decode, a paged chunk and prefill
                                   (1, 18944, 3584), (8, 18944, 3584),
                                   (16, 18944, 3584), (256, 18944, 3584),
                                   # M at and past each block shape's edge
                                   (5, 3584, 4608), (9, 3584, 4608),
                                   (17, 3584, 3584), (42, 3584, 3584),
                                   (257, 3584, 3584),
                                   # Kp % 64 != 0 and 88-byte scale rows
                                   (8, 1408, 2048), (42, 1408, 2048),
                                   (257, 1408, 24)])
def test_matmul_kernel_within_bound(gen, m, k, n):
    x = ops.nvfp4_qdq((torch.randn((m, k), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    assert _matmul_ok(x, ops.pack_weight(w.to(torch.bfloat16)))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_padded_k(gen, x_dtype, out_dtype):
    """orig_k (40) below the stored K (48): x carries the logical K."""
    x = torch.randn((5, 40), generator=gen, device="cuda").to(x_dtype)
    w = torch.nn.functional.pad(torch.randn((24, 40), generator=gen,
                                            device="cuda"), (0, 8))
    p = dataclasses.replace(nvfp4.pack(w), orig_k=40)
    assert _matmul_ok(x, p, out_dtype)


@pytest.mark.parametrize("m", [1, 8, 16, 256])
def test_matmul_kernel_f32_out_at_wd(gen, m):
    """f32 out at wd (K = 18944): no bf16 ulp to hide in, so the kernel's
    sum must stay within the summation bound 2^-20 * (|x| @ |W|^T) alone
    (each 64-k step's MMAs promoted into the f32 sum)."""
    x = ops.nvfp4_qdq((torch.randn((m, 18944), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    w = torch.randn((18944, 3584), generator=gen, device="cuda") / math.sqrt(18944)
    assert _matmul_ok(x, ops.pack_weight(w.to(torch.bfloat16)), torch.float32)


@pytest.mark.parametrize("m", [1, 8, 42])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_f32_x(gen, m, out_dtype):
    """f32 x at K = 3584 (split into three bf16 parts on the tensor cores)
    within K2's bound of the plain version's f32 product."""
    x = torch.randn((m, 3584), generator=gen, device="cuda") * 2
    w = torch.randn((3584, 4608), generator=gen, device="cuda") / math.sqrt(3584)
    assert _matmul_ok(x, ops.pack_weight(w.to(torch.bfloat16)), out_dtype)


# nemotron-nano-9b-sim's recurrent-layer sites: (name, K, N); wd's K =
# 15680 is 245 chunks of 64, not a multiple of 128
NEMO_SITES = [("wx", 4480, 4480), ("wg", 4480, 15680), ("wd", 15680, 4480)]


@pytest.mark.parametrize("site", NEMO_SITES, ids=[s[0] for s in NEMO_SITES])
def test_matmul_kernel_on_stack_slice(gen, site):
    """K2 on one [layer, inner] slice of a weight stacked over two leading
    axes, packed as PTQ packs the rglru family's ``blocks/rec`` (a tensor
    scale per slice, [2, 2, 1, 1]): the slice keeps ``orig_k`` and its own
    scale, and K2 at M = 8 (decode) and 256 (prefill tiles) is within its
    bound of the plain version; row 3 of the M = 256 product equals the
    M = 8 product's bitwise (row invariance at this K)."""
    from repro_torch.core import ptq
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models.common import ParamSpec
    _, k, n = site
    spec = ParamSpec((2, 2, k, n), ("layers", "inner", "embed", "mlp"),
                     kind="mlp", contract_axis=2)
    w = (torch.randn((2, 2, k, n), generator=gen, device="cuda")
         / math.sqrt(k)).to(torch.bfloat16)
    w[1, 0] *= 4.0                                 # another tensor scale
    packed = ptq.quantize_leaf(spec, w, QuantConfig(weight_format="packed"))
    assert packed.tensor_scale.shape == (2, 2, 1, 1)
    sl = packed[1][0]
    assert sl.codes.shape == (n, k // 2) and sl.k == k
    assert sl.tensor_scale.shape == (1, 1)
    assert float(sl.tensor_scale) != float(packed[0][0].tensor_scale)
    x = ops.nvfp4_qdq((torch.randn((256, k), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    for m in (8, 256):
        assert _matmul_ok(x[:m], sl)
    assert torch.equal(_bits(ops.nvfp4_matmul(x, sl)[:8]),
                       _bits(ops.nvfp4_matmul(x[:8], sl)))


# the shapes of rwkv6-3b, whisper-tiny and qwen2-vl-2b: (name, K, N).
# rwkv6's two LoRA down-projections sit below one 128-row weight tile (N =
# 64, the decay's; N = 160, the token shift's five streams of 32)
SLAB_SITES = [("rwkv6 dec_w1", 2560, 64), ("rwkv6 ts_w1", 2560, 160),
              ("rwkv6 wr", 2560, 2560), ("rwkv6 cm_wk", 2560, 8960),
              ("rwkv6 cm_wv", 8960, 2560), ("whisper wi", 384, 1536),
              ("whisper wd", 1536, 384), ("qwen2-vl wqkv", 1536, 2048),
              ("qwen2-vl wd", 8960, 1536)]


@pytest.mark.parametrize("site", SLAB_SITES, ids=[s[0] for s in SLAB_SITES])
def test_matmul_kernel_at_the_slab_families_shapes(gen, site):
    """K2 at decode (M = 8 slots) and prefill (M = 512) within its bound;
    the M = 512 product's first 8 rows bitwise the M = 8 product's."""
    _, k, n = site
    x = ops.nvfp4_qdq((torch.randn((512, k), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    p = ops.pack_weight(w.to(torch.bfloat16))
    for m in (8, 512):
        assert _matmul_ok(x[:m], p)
    assert torch.equal(_bits(ops.nvfp4_matmul(x, p)[:8]),
                       _bits(ops.nvfp4_matmul(x[:8], p)))


def test_matmul_kernel_whisper_cross_kv(gen):
    """K2 at whisper-tiny's cross-attention KV site as the slab engine's
    decode step runs it: M = 12000 (8 slots x 1500 encoder frames), K =
    384, N = 1152 (x_wqkv), within its bound; rows 0..7 bitwise the same
    rows alone."""
    x = ops.nvfp4_qdq((torch.randn((12000, 384), generator=gen, device="cuda")
                       * 2).to(torch.bfloat16))
    w = torch.randn((384, 1152), generator=gen, device="cuda") / math.sqrt(384)
    p = ops.pack_weight(w.to(torch.bfloat16))
    assert _matmul_ok(x, p)
    assert torch.equal(_bits(ops.nvfp4_matmul(x, p)[:8]),
                       _bits(ops.nvfp4_matmul(x[:8], p)))


# acereason-7b's GEMM sites: (name, K, N)
ACE_SITES = [("wqkv", 3584, 4608), ("wo", 3584, 3584), ("wg", 3584, 18944),
             ("wd", 18944, 3584)]


@pytest.mark.parametrize("site", ACE_SITES, ids=[s[0] for s in ACE_SITES])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_kernel_row_invariance(gen, site, out_dtype):
    """A token's output row does not depend on M or on the other tokens:
    rows of an M = 256 product (prefill tiles) equal bitwise the same rows
    computed at M = 16 (a paged chunk), M = 8 and M = 4 (decode) and alone.
    The design has one K order for every M, so this holds across all of
    them.  K3 on the same rows as one group of a stack equals them too."""
    _, k, n = site
    x = ops.nvfp4_qdq((torch.randn((256, k), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    p = ops.pack_weight(w.to(torch.bfloat16))
    full = _bits(ops.nvfp4_matmul(x, p, out_dtype))
    for rows in (slice(0, 16), slice(200, 216), slice(248, 256), slice(100, 104)):
        assert torch.equal(_bits(ops.nvfp4_matmul(x[rows], p, out_dtype)), full[rows])
    for r in (0, 77, 255):
        assert torch.equal(_bits(ops.nvfp4_matmul(x[r:r + 1], p, out_dtype)),
                           full[r:r + 1])
    stack = nvfp4.PackedNVFP4(p.codes[None].expand(2, -1, -1).contiguous(),
                              p.scales[None].expand(2, -1, -1).contiguous(),
                              p.tensor_scale.reshape(1), p.orig_k)
    xg = torch.stack([x[:16], x[16:32]])
    got = _bits(ops.nvfp4_matmul_grouped(xg, stack, out_dtype))
    assert torch.equal(got.reshape(32, n), full[:32])


def _grouped_case(gen, g, m, k, n, per_group, orig_k=0):
    """x [G, M, K] (through the qdq kernel unless K is padded) and a packed
    stack [G, N, K/2] whose experts differ in scale; ``orig_k`` pads the
    stored K."""
    x = (torch.randn((g, m, orig_k or k), generator=gen, device="cuda") * 2
         ).to(torch.bfloat16)
    if not orig_k:
        x = ops.nvfp4_qdq(x)
    w = (torch.randn((g, n, k), generator=gen, device="cuda") / math.sqrt(k)
         * torch.arange(1, g + 1, device="cuda")[:, None, None])
    p = nvfp4.pack(w.to(torch.bfloat16), n_lead=1 if per_group else 0)
    if orig_k:
        p = dataclasses.replace(p, orig_k=orig_k)
    return x, p


@pytest.mark.parametrize("g,m,k,n,per_group,orig_k", [
    (60, 8, 2048, 1408, False, 0), (60, 8, 1408, 2048, False, 0),
    (60, 42, 2048, 1408, False, 0), (60, 16, 1408, 2048, True, 0),
    (60, 16, 2048, 1408, False, 0), (60, 42, 1408, 2048, True, 0),
    (3, 5, 48, 24, True, 40), (4, 1, 64, 40, False, 0)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_kernel_within_bound_and_bitwise_k2(gen, g, m, k, n, per_group,
                                                    orig_k, out_dtype):
    """K3 against its plain version within K2's bound (one ulp of the
    output plus 2^-20 * (|x| @ |W|^T)), and bitwise equal to K2 run on
    each group's slices: the Qwen1.5-MoE expert stacks at decode (M = 8),
    exact prefill (M = 42) and a paged chunk (M = 16), per-group and
    shared tensor scales, K padded under orig_k, M = 1."""
    x, p = _grouped_case(gen, g, m, k, n, per_group, orig_k)
    y = ops.nvfp4_matmul_grouped(x, p, out_dtype)
    y32 = ref.nvfp4_matmul_grouped_ref(x, p, torch.float32)
    w = nvfp4.unpack(p, torch.bfloat16).float()[..., : p.k]
    bound = 2.0 ** -20 * torch.bmm(x.float().abs(), w.abs().transpose(1, 2))
    if out_dtype == torch.bfloat16:
        bound += torch.exp2(torch.floor(torch.log2(y32.abs().clamp_min(1e-30))) - 7)
    assert bool(((y.float() - y32).abs() <= bound).all())
    ts = p.tensor_scale.reshape(-1)
    for i in range(g):
        sl = nvfp4.PackedNVFP4(p.codes[i], p.scales[i], ts[i if per_group else 0],
                               p.orig_k)
        assert torch.equal(_bits(y[i]), _bits(ops.nvfp4_matmul(x[i], sl, out_dtype)))


def _ulp(x, mant_bits):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - mant_bits)


def kl_fwd_ok(t, s):
    """K5 against its plain version on the same logits (tolerance above)."""
    kl, zt, zs = kkl.launch_fwd(t, s)
    pk, pzt, pzs = kkl.plain_fwd(t, s)
    tol_kl = 1e-4 * pk.abs() + 16 * _ulp(pzt.abs() + pzs.abs(), 23)
    return bool(((kl - pk).abs() <= tol_kl).all()
                and ((zt - pzt).abs() <= 8 * _ulp(pzt, 23)).all()
                and ((zs - pzs).abs() <= 8 * _ulp(pzs, 23)).all())


def kl_bwd_ok(t, s, zt, zs, g):
    """K6 against its plain version's f32 value, given the same z."""
    ds = kkl.launch_bwd(t, s, zt, zs, g).float()
    p_s = torch.exp(s.float() - zs[:, None])
    p_t = torch.exp(t.float() - zt[:, None])
    want = (p_s - p_t) * g[:, None]
    mant = 7 if s.dtype == torch.bfloat16 else 23
    tol = _ulp(want, mant) + 4 * 2.0 ** -23 * (p_s + p_t) * g.abs()[:, None]
    return bool(((ds - want).abs() <= tol).all())


@pytest.mark.parametrize("t,v", [(64, 50304), (8, 152064), (33, 257),
                                 (5, 7), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kl_kernels_against_plain(gen, t, v, dtype):
    """Ragged V (no multiple of the 16-byte vector) and tiny rows included;
    a masked-out row (g = 0) gives zeros."""
    tl = (torch.randn((t, v), generator=gen, device="cuda") * 2).to(dtype)
    sl = (tl.float() + 0.3 * torch.randn((t, v), generator=gen, device="cuda")
          ).to(dtype)
    assert kl_fwd_ok(tl, sl)
    _, zt, zs = kkl.launch_fwd(tl, sl)
    g = torch.rand(t, generator=gen, device="cuda") / t
    g[0] = 0.0
    assert kl_bwd_ok(tl, sl, zt, zs, g)
    assert not kkl.launch_bwd(tl, sl, zt, zs, g)[0].any()


def test_kl_kernels_misaligned_rows(gen):
    """A view that starts off a 16-byte boundary is copied to an aligned
    buffer; rows of odd V start at every offset."""
    base = torch.randn((9, 1001), generator=gen, device="cuda").to(torch.bfloat16)
    tl, sl = base[1:, :1000], base[:-1, 1:]
    assert kl_fwd_ok(tl, sl)


def test_kl_identical_logits_give_zero(gen):
    tl = torch.randn((16, 50304), generator=gen, device="cuda").to(torch.bfloat16)
    kl, zt, zs = kkl.launch_fwd(tl, tl)
    assert not kl.any() and torch.equal(zt, zs)


def test_kl_op_on_card_matches_cpu(gen):
    """``ops.kl_loss`` forward and gradient on the card against the same
    op on the CPU (plain versions)."""
    tl = (torch.randn((40, 3001), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    sl = (tl.float() + 0.2 * torch.randn((40, 3001), generator=gen,
                                         device="cuda")).to(torch.bfloat16)
    mask = (torch.rand(40, generator=gen, device="cuda") > 0.3).float()
    s_gpu = sl.clone().requires_grad_()
    s_cpu = sl.cpu().requires_grad_()
    loss_gpu = ops.kl_loss(tl, s_gpu, mask)
    loss_cpu = ops.kl_loss(tl.cpu(), s_cpu, mask.cpu())
    loss_gpu.backward()
    loss_cpu.backward()
    assert abs(float(loss_gpu) - float(loss_cpu)) <= 1e-4 * abs(float(loss_cpu)) + 1e-6
    assert torch.allclose(s_gpu.grad.float().cpu(), s_cpu.grad.float(),
                          rtol=1e-2, atol=1e-6)


def _k7_case(gen, b, s_q, h, hkv, hd, n_blocks, bs, mb, pos, fp8=False):
    """Random pages (bf16, or e4m3 with per-row scales), a table of
    distinct blocks per request, queries; ``pos`` [B] or [B, S]."""
    dev = "cuda"
    k = torch.randn((n_blocks, bs, hkv, hd), generator=gen, device=dev)
    v = torch.randn((n_blocks, bs, hkv, hd), generator=gen, device=dev)
    if fp8:
        def quant(x):
            scale = x.abs().amax(-1).clamp_min(1e-30) / 448.0
            return (x / scale[..., None]).to(torch.float8_e4m3fn), scale
        (k, ks), (v, vs) = quant(k), quant(v)
        pool = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        pool = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    bt = torch.randperm(n_blocks, generator=gen, device=dev)[: b * mb]
    q = torch.randn((b, s_q, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    return q, pool, bt.reshape(b, mb).to(torch.int32), \
        torch.as_tensor(pos, dtype=torch.int32, device=dev)


def _k7_ok(q, pool, bt, pos, window=0):
    got = ops.paged_attention(q, pool, bt, pos, window=window).float()
    want = ref.paged_attention_ref(q, pool, bt, pos, window=window).float()
    big = torch.maximum(got.abs(), want.abs())
    return bool(((got - want).abs() <= _ulp(big, 7) + K7_ATOL).all())


def _decode_pos(gen, b, hi):
    return torch.randint(1, hi + 1, (b,), generator=gen, device="cuda")


def test_paged_attention_decode_acereason_shape(gen):
    """Decode at the engine's acereason-7b shape: 8 slots, 28 heads over 4
    KV heads, pages [272, 16, 4, 128], tables [8, 34], pos 1..544."""
    pos = _decode_pos(gen, 8, 544)
    pos[0], pos[1] = 1, 544
    assert _k7_ok(*_k7_case(gen, 8, 1, 28, 4, 128, 272, 16, 34, pos))


def test_paged_attention_prefill_chunk_shape(gen):
    """The paged-prefill form: one 16-token chunk, per-query positions."""
    pos = (300 + torch.arange(1, 17)).reshape(1, 16)
    assert _k7_ok(*_k7_case(gen, 1, 16, 28, 4, 128, 272, 16, 34, pos))


# (S_q, heads, KV heads, FP8 pages): the speculative verify at k = 4 on
# acereason-7b's heads, and at k = 2 on qwen2-moe-a2.7b's FP8 pool
VERIFY_CASES = [(5, 28, 4, False), (3, 16, 16, True), (16, 28, 4, False)]


@pytest.mark.parametrize("s_q,h,hkv,fp8", VERIFY_CASES)
def test_paged_attention_rows_equal_one_query_calls(gen, s_q, h, hkv, fp8):
    """The verify shape (8 slots, S_q queries at per-query positions that
    cross block and part boundaries): within tolerance, and each query's
    rows bitwise a one-query call's at its position (what greedy
    speculative parity on the paged path rests on)."""
    lens = torch.tensor([12, 93, 189, 285, 380, 475, 531, 539]) - max(s_q - 5, 0)
    pos = lens[:, None] + torch.arange(1, s_q + 1)[None, :]
    q, pool, bt, pos = _k7_case(gen, 8, s_q, h, hkv, 128, 272, 16, 34, pos,
                                fp8=fp8)
    assert _k7_ok(q, pool, bt, pos)
    got = ops.paged_attention(q, pool, bt, pos)
    for i in range(s_q):
        one = ops.paged_attention(q[:, i:i + 1], pool, bt, pos[:, i])
        assert torch.equal(_bits(got[:, i]), _bits(one[:, 0])), i


@pytest.mark.parametrize("s_q", [1, 16])
def test_paged_attention_fp8_moe_heads(gen, s_q):
    """FP8 pages at qwen2-moe-a2.7b's 16/16 heads of 128 (the moe_hybrid
    pool): decode over 8 slots and a 16-query chunk."""
    pos = (_decode_pos(gen, 8, 544) if s_q == 1
           else (256 + torch.arange(1, 17)).reshape(1, 16))
    assert _k7_ok(*_k7_case(gen, pos.shape[0], s_q, 16, 16, 128, 272, 16, 34,
                            pos, fp8=True))


def test_fp8_quantize_matches_cpu(gen):
    """Bitwise: E4M3 values and f32 scales of the FP8 KV quantizer on the
    card against the CPU's, on random rows, a zero row and rows whose
    values sit near E4M3 rounding ties of the division."""
    allb = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    rows = []
    for a in allb[allb > 1e-3][::97]:
        s = a * float(torch.tensor(1.0) / torch.tensor(448.0))
        xs = allb[allb <= a]
        d = (xs / s).to(torch.float8_e4m3fn).view(torch.uint8)
        r = (xs * (1.0 / s)).to(torch.float8_e4m3fn).view(torch.uint8)
        rows += [[float(a), float(x)] for x in xs[d != r][:3]]
    ties = torch.tensor(rows).to(torch.bfloat16)
    x = torch.cat([(torch.randn((64, 2), generator=torch.Generator()
                                .manual_seed(1)) * 100).to(torch.bfloat16),
                   torch.zeros((1, 2), dtype=torch.bfloat16), ties])
    x = torch.nn.functional.pad(x, (0, 126))          # rows of 128
    a, b = nvfp4.fp8_quantize(x), nvfp4.fp8_quantize(x.cuda())
    assert len(rows) > 10
    assert torch.equal(a.values.view(torch.uint8), b.values.cpu().view(torch.uint8))
    assert torch.equal(a.scale, b.scale.cpu())


@pytest.mark.parametrize("window", [8, 40, 300])
@pytest.mark.parametrize("s_q", [1, 3])
def test_paged_attention_window(gen, window, s_q):
    pos = 100 + torch.arange(s_q)[None, :] + 37 * torch.arange(4)[:, None]
    assert _k7_ok(*_k7_case(gen, 4, s_q, 8, 2, 64, 64, 16, 16, pos),
                  window=window)


@pytest.mark.parametrize("s_q", [1, 4])
def test_paged_attention_fp8_pages(gen, s_q):
    pos = 50 + torch.arange(s_q)[None, :] + 60 * torch.arange(3)[:, None]
    assert _k7_ok(*_k7_case(gen, 3, s_q, 28, 4, 128, 48, 16, 16, pos, fp8=True))


def test_paged_attention_ignores_dead_table_tail(gen):
    """Blocks past every query's pos are never read: poisoning them (and
    the table entries that name them) leaves the output bitwise alone."""
    q, pool, bt, pos = _k7_case(gen, 2, 1, 8, 2, 64, 20, 16, 8, [9, 20])
    want = ops.paged_attention(q, pool, bt, pos)
    dead = bt[:, 2:].reshape(-1).long()
    poisoned = {n: a.clone() for n, a in pool.items()}
    for a in poisoned.values():
        a[dead] = 1e4
    assert torch.equal(ops.paged_attention(q, poisoned, bt, pos), want)
    bt2 = bt.clone()
    bt2[:, 2:] = 2 ** 30                     # out of range, never read
    assert torch.equal(ops.paged_attention(q, pool, bt2, pos), want)


def test_paged_attention_noncontiguous_q(gen):
    q, pool, bt, pos = _k7_case(gen, 4, 2, 8, 2, 64, 40, 16, 8,
                                [[5, 6], [60, 61], [100, 101], [127, 128]])
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)   # same values
    assert not qt.is_contiguous()
    assert torch.equal(ops.paged_attention(qt, pool, bt, pos),
                       ops.paged_attention(q, pool, bt, pos))
    assert _k7_ok(qt, pool, bt, pos)


@pytest.mark.parametrize("keys", [4096, 32768])
def test_paged_attention_long_context(gen, keys):
    """Decode at 4k and 32k valid keys: every block of a cluster holds
    more keys than it stages at once, so it loops and recomputes."""
    mb = keys // 16 + 2
    pos = torch.tensor([keys, keys - 77], device="cuda")
    assert _k7_ok(*_k7_case(gen, 2, 1, 28, 4, 128, 2 * mb + 4, 16, mb, pos))


@pytest.mark.parametrize("where", ["boundaries", "ends", "beside"])
def test_paged_attention_split_edges(gen, where):
    """pos on the boundaries of the blocks' parts of a 544-key table, at 1
    and at MB x bs, and one key to either side of a boundary."""
    cs = kpa._part_len(544, kpa.split_plan(1, 7, 34, 16, 128).n_split)
    pos = {"boundaries": [cs * i for i in range(1, 8)] + [1],
           "ends": [1, 1, 1, 1, 544, 544, 544, 544],
           "beside": [cs - 1, cs + 1, 2 * cs - 1, 2 * cs + 1, 16, 17, 15, 33]}[where]
    pos = [min(p, 544) for p in pos]
    assert _k7_ok(*_k7_case(gen, 8, 1, 28, 4, 128, 272, 16, 34, pos))


@pytest.mark.parametrize("window", [40, 200])
def test_paged_attention_fp8_window_chunk(gen, window):
    """FP8 pages with a window at S = 16 (a paged-prefill chunk)."""
    pos = (300 + torch.arange(1, 17)).reshape(1, 16)
    assert _k7_ok(*_k7_case(gen, 1, 16, 28, 4, 128, 272, 16, 34, pos, fp8=True),
                  window=window)


def test_paged_attention_decode_is_one_device_kernel(gen):
    """The engine-shaped decode call (pos [B] int32, tables int32) runs one
    device kernel and nothing else."""
    pos = _decode_pos(gen, 8, 544).to(torch.int32)
    q, pool, bt, pos = _k7_case(gen, 8, 1, 28, 4, 128, 272, 16, 34, pos)
    names = _device_ops(lambda: ops.paged_attention(q, pool, bt, pos))
    assert len(names) == 1 and "paged_attention" in names[0], names


def test_launch_counters_count_card_launches(gen):
    ops.reset_launches()
    x = torch.randn((4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ops.nvfp4_matmul(ops.nvfp4_qdq(x), ops.pack_weight(
        torch.randn((64, 32), generator=gen, device="cuda")))
    s = torch.randn((4, 64), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    ops.kl_loss(x, s, torch.ones(4, device="cuda")).backward()
    ops.paged_attention(*_k7_case(gen, 1, 1, 2, 1, 32, 4, 8, 2, [3]))
    ops.nvfp4_matmul_grouped(x.reshape(2, 2, 64), nvfp4.pack(
        torch.randn((2, 16, 64), generator=gen, device="cuda")))
    torch.cuda.synchronize()
    assert ops.launches == {"nvfp4_qdq": 1, "nvfp4_matmul": 1,
                            "nvfp4_matmul_grouped": 1, "kl_loss": 1,
                            "kl_loss_bwd": 1, "paged_attention": 1}


# acereason-7b's five GEMM sites at tp = 2: (name, K, N, mode)
TP_SITES = [("wqkv", 3584, 4608, "column"), ("wo", 3584, 3584, "row"),
            ("wg", 3584, 18944, "column"), ("wd", 18944, 3584, "row")]


def _tp_case(gen, m, k, n):
    x = ops.nvfp4_qdq((torch.randn((m, k), generator=gen, device="cuda") * 2
                       ).to(torch.bfloat16))
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    return x, ops.pack_weight(w.to(torch.bfloat16))


def _full_k_ok(x, p, got):
    """``got`` [M, N] f32 within the summation-order bound of the full-K
    plain product."""
    y32 = ref.nvfp4_matmul_ref(x, p, torch.float32)
    w = nvfp4.unpack(p, torch.bfloat16).float()[:, : p.k]
    bound = 2.0 ** -20 * (x.float().abs() @ w.abs().T)
    return bool(((got.float() - y32).abs() <= bound).all())


def _tiles_vs_full(x, p, mode, ys):
    """Column: the tiles' outputs side by side; row: their f32 sum."""
    return _full_k_ok(x, p, torch.cat(ys, -1) if mode == "column" else sum(ys))


@pytest.mark.parametrize("site", TP_SITES, ids=[s[0] for s in TP_SITES])
@pytest.mark.parametrize("m", [8, 256])
def test_tp_tiles_kernel_within_bound(gen, site, m):
    """Each rank tile (``nvfp4.tp_tile``, contiguous) through K2 within
    K2's bound of its plain version; the two tiles together against the
    full-K plain product."""
    _, k, n, mode = site
    x, p = _tp_case(gen, m, k, n)
    ys = []
    for rank in range(2):
        tile = nvfp4.tp_tile(p, mode, rank, 2)
        assert tile.codes.is_contiguous() and tile.codes.shape[-1] % 8 == 0
        xl = x if mode == "column" else x.chunk(2, -1)[rank].contiguous()
        assert _matmul_ok(xl, tile, torch.float32)
        ys.append(ops.nvfp4_matmul(xl, tile, torch.float32))
    assert _tiles_vs_full(x, p, mode, ys)


def _k4_rank(tp, m, k, n, mode):
    """One rank of the two-rank K4 test: the same seeded inputs on both."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, p = _tp_case(gen, m, k, n)
    tile = nvfp4.tp_tile(p, mode, tp.rank, tp.size)
    xl = x if mode == "column" else x.chunk(tp.size, -1)[tp.rank].contiguous()
    ops.reset_launches()
    y = ops.nvfp4_matmul_tp(xl, tile, tp, mode, torch.float32)
    torch.cuda.synchronize()
    return y.cpu(), ops.launches["nvfp4_matmul_tp"]


@pytest.mark.parametrize("site", [TP_SITES[0], TP_SITES[3]],
                         ids=["wqkv", "wd"])
def test_k4_two_gloo_ranks_on_one_card(gen, site):
    """K4 on two gloo ranks sharing the card: one launch per rank; column
    outputs side by side, and the row all-reduce on every rank, within the
    summation-order bound of the full-K plain product."""
    from repro_torch.launch import mesh
    _, k, n, mode = site
    out = mesh.spawn(_k4_rank, 2, 8, k, n, mode, device="cuda", timeout=600)
    assert [launches for _, launches in out] == [1, 1]
    x, p = _tp_case(torch.Generator(device="cuda").manual_seed(7), 8, k, n)
    ys = [y.cuda() for y, _ in out]
    if mode == "column":
        assert _tiles_vs_full(x, p, mode, ys)
    else:
        assert torch.equal(ys[0], ys[1])
        assert _full_k_ok(x, p, ys[0])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_engine_telemetry_on_the_card(gen, arch):
    """Smoke size on the card: greedy tokens bitwise the same with
    telemetry off and tracing on, the trace valid, and each
    ``kernel_dispatch_total{kernel}`` equal to the launches ``ops``
    counted over the traced engine's steps (the MoE config's fused tier
    runs ``nvfp4_matmul_grouped``, the dense one ``paged_attention``)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.obs import Observability
    from repro_torch.obs import validate
    from repro_torch.serve import Engine
    cfg = configs.get_smoke(arch)
    params, qcfg = serve.load_quantized(cfg, 0, "packed", "cuda")
    prompts = serve.mixed_prompts(4, 4, 16, cfg.vocab_size, seed=3)
    outs = []
    for obs in (None, Observability(metrics=True, trace=True)):
        eng = Engine(cfg, params, qcfg, obs=obs, n_slots=4, block_size=8,
                     max_blocks_per_slot=4, n_blocks=16)
        ops.reset_launches()
        rids, out = serve.run_workload(eng, prompts, 5)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches.items() if v}
        outs.append([out[r].tolist() for r in rids])
    assert outs[0] == outs[1]
    snap = eng.obs.metrics.snapshot()
    kern = {c["labels"]["kernel"]: c["value"]
            for c in snap["kernel_dispatch_total"]["labels"]}
    assert kern == launches
    assert kern["nvfp4_matmul_grouped" if cfg.n_experts
                else "paged_attention"] > 0
    gemm = {c["labels"]["backend"]: c["value"]
            for c in snap["qeinsum_dispatch_total"]["labels"]}
    assert gemm["pallas_2d"] == launches["nvfp4_matmul"]
    assert validate.check_trace(eng.obs.trace.to_chrome()) == []
