"""The packed-NVFP4 GEMM's layout arithmetic, on the CPU.

The CUDA kernel (``kernels/csrc/nvfp4_matmul.cuh``) cannot run here, but
the pieces of its design that are plain arithmetic can be held to the plain
version: the wrapper's x layout for the tensor-core tile form, and a numpy
model of the kernel's register decode (the byte tables built per 16-value
block and the two ``prmt`` lookups per element) and of its permuted K order
across the MMA fragments.  Tolerances: the decode bitwise against
``nvfp4.unpack``; the fragment model in float64 against ``x @ W^T`` within
1e-12 relative (the same exact products, summed in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import nvfp4
from repro_torch.kernels import nvfp4_matmul as kmm


def test_tile_order_is_the_decode_k_order():
    """Word 8a + 2j + b of each 64-value chunk (values 16a + 4j + 2b +
    {0, 1}) lands at word 4 (2j + b) + a: slice 2j + b of MMA j holds, in
    order a = 0..3, the values thread a's A fragment multiplies."""
    x = torch.arange(3 * 192, dtype=torch.float32).reshape(3, 192).to(torch.bfloat16)
    y = kmm._tile_order(x)
    for c in range(3):
        for a in range(4):
            for j in range(4):
                for b in range(2):
                    src = c * 64 + 16 * a + 4 * j + 2 * b
                    dst = c * 64 + 2 * (4 * (2 * j + b) + a)
                    assert torch.equal(y[:, dst:dst + 2], x[:, src:src + 2])


@pytest.mark.parametrize("dtype,rows,k,kp,want_k,tiled", [
    (torch.bfloat16, 32, 40, 48, 40, False),     # split form: K a multiple of 8
    (torch.bfloat16, 5, 37, 48, 40, False),      # zero columns to a multiple of 8
    (torch.bfloat16, 33, 40, 48, 64, True),      # tile form: whole 64-value chunks
    (torch.bfloat16, 256, 1408, 1408, 1408, True),
    (torch.float32, 64, 80, 80, 80, False)])     # f32 x keeps its order
def test_kernel_x_layout(dtype, rows, k, kp, want_k, tiled):
    x = torch.randn((rows, k)).to(dtype)
    got = kmm._kernel_x(x, kp)
    assert got.shape == (rows, want_k) and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    padded = torch.nn.functional.pad(x, (0, want_k - k))
    assert torch.equal(got, kmm._tile_order(padded) if tiled else padded)


def test_kernel_x_realigns_a_misaligned_view():
    base = torch.randn(2 * 64 + 1).to(torch.bfloat16)
    x = base[1:].reshape(2, 64)                    # starts 2 bytes in
    got = kmm._kernel_x(x, 64)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)


# ---- a numpy model of the kernel's register decode ------------------------


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes of (x, y)."""
    x, y, sel = (np.asarray(v, dtype=np.uint64) for v in (x, y, sel))
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, sel).shape, dtype=np.uint64)
    for i in range(4):
        idx = (sel >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((src >> (idx * np.uint64(8))) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _bf16x2(lo, hi):
    """Two f32 arrays rounded to bf16 (nearest even) and packed."""
    def b(v):
        t = torch.from_numpy(np.array(v, dtype=np.float32, ndmin=1))
        bits = t.to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
        return bits.reshape(np.shape(v))
    return b(lo) | (b(hi) << 16)


def _make_lut(s):
    """make_lut: the low and high bytes of round_bf16(f32(e2m1 * s))."""
    s = np.asarray(s, dtype=np.float32)
    q = [_bf16x2(np.float32(lo) * s, np.float32(hi) * s)
         for lo, hi in ((0.0, 0.5), (1.0, 1.5), (2.0, 3.0), (4.0, 6.0))]
    return (_byte_perm(q[0], q[1], 0x6420), _byte_perm(q[2], q[3], 0x6420),
            _byte_perm(q[0], q[1], 0x7531), _byte_perm(q[2], q[3], 0x7531))


def _decode_word(w, lut):
    """decode_word: a word of codes -> the bf16 pairs of its four bytes."""
    lo03, lo47, hi03, hi47 = lut
    w = np.asarray(w, dtype=np.uint32)
    idx = w & np.uint32(0x77777777)
    idx_hi = idx >> np.uint32(16)
    w4 = (w << np.uint32(4)).astype(np.uint32)
    lo_a = _byte_perm(lo03, lo47, idx)
    hi_a = _byte_perm(hi03, hi47, idx) | (_byte_perm(w4, w, 0x5140) & np.uint32(0x80808080))
    lo_b = _byte_perm(lo03, lo47, idx_hi)
    hi_b = _byte_perm(hi03, hi47, idx_hi) | (_byte_perm(w4, w, 0x7362) & np.uint32(0x80808080))
    return (_byte_perm(lo_a, hi_a, 0x5140), _byte_perm(lo_a, hi_a, 0x7362),
            _byte_perm(lo_b, hi_b, 0x5140), _byte_perm(lo_b, hi_b, 0x7362))


def _block_scales(p):
    return (p.scales.to(torch.float32) * p.tensor_scale).numpy()


def _words(codes, row, block):
    """The two little-endian words of one 16-value block of a code row."""
    by = codes[row, 8 * block: 8 * block + 8].astype(np.uint32)
    return (by[0] | by[1] << 8 | by[2] << 16 | by[3] << 24,
            by[4] | by[5] << 8 | by[6] << 16 | by[7] << 24)


@pytest.mark.parametrize("magnitude", [1e-6, 1.0, 3e4])
def test_register_decode_equals_unpack(magnitude):
    """Every element the tables give, bitwise the plain version's bf16
    weight: all 16 codes (negative zero too), an all-zero block (scale 0)
    and weights of very small and very large magnitude."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((24, 128)) * magnitude, dtype=torch.float32)
    w[0, :16] = 0.0
    w[1, :16] = -0.0
    p = nvfp4.pack(w.to(torch.bfloat16))
    want = nvfp4.unpack(p, torch.bfloat16).view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    codes, s = p.codes.numpy(), _block_scales(p)
    for r in range(codes.shape[0]):
        for blk in range(codes.shape[1] // 8):
            lut = _make_lut(s[r, blk])
            pairs = [v for wd in _words(codes, r, blk) for v in _decode_word(wd, lut)]
            for i, v in enumerate(pairs):       # byte i: values 2i, 2i + 1
                assert v & 0xFFFF == want[r, 16 * blk + 2 * i]
                assert v >> 16 == want[r, 16 * blk + 2 * i + 1]


def _unpack_pair(v):
    """bf16x2 register -> two float64 values."""
    h = torch.tensor([v & 0xFFFF, v >> 16], dtype=torch.int32).to(torch.int16)
    return h.view(torch.bfloat16).double().numpy()


def test_fragment_permutation_computes_x_w():
    """One warp, one 64-value chunk, 16 weight rows x 8 tokens, with the
    kernel's fragment assignment (thread (g, t) decodes block t of rows g
    and g + 8; MMA j takes values 16t + 4j .. 16t + 4j + 3 of x) and the
    m16n8k16 fragment semantics: the four MMAs give W x^T."""
    rng = np.random.default_rng(1)
    p = nvfp4.pack(torch.tensor(rng.standard_normal((16, 64)),
                                dtype=torch.float32).to(torch.bfloat16))
    w = nvfp4.unpack(p, torch.bfloat16).double().numpy()
    x = torch.tensor(rng.standard_normal((8, 64))).to(torch.bfloat16).double().numpy()
    codes, s = p.codes.numpy(), _block_scales(p)
    d = np.zeros((16, 8))
    for j in range(4):
        a_mat, b_mat = np.zeros((16, 16)), np.zeros((16, 8))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for row in (g, g + 8):
                lut = _make_lut(s[row, t])
                pairs = [v for wd in _words(codes, row, t) for v in _decode_word(wd, lut)]
                # code byte 2j -> k pair (2t, 2t+1), byte 2j+1 -> (2t+8, 2t+9)
                a_mat[row, 2 * t: 2 * t + 2] = _unpack_pair(int(pairs[2 * j]))
                a_mat[row, 2 * t + 8: 2 * t + 10] = _unpack_pair(int(pairs[2 * j + 1]))
            b_mat[2 * t: 2 * t + 2, g] = x[g, 16 * t + 4 * j: 16 * t + 4 * j + 2]
            b_mat[2 * t + 8: 2 * t + 10, g] = x[g, 16 * t + 4 * j + 2: 16 * t + 4 * j + 4]
        d += a_mat @ b_mat
    want = w @ x.T
    assert np.abs(d - want).max() <= 1e-12 * np.abs(want).max()
