// Device code shared by the packed-NVFP4 matmul (nvfp4_matmul.cu, K2) and
// its grouped form (nvfp4_matmul_grouped.cu, K3); K4 is K2 on a rank's tile.
//
// y[g] = x[g] @ W_g with every W_g stored as packed NVFP4 W_g^T.  Inputs:
// x [G, M, K] (bf16 or f32, rows 16-byte aligned; K the logical K padded to
// a multiple of 8, or for the bf16 tile form to whole 64-value chunks and
// reordered, see below), codes uint8 [G, N, Kp/2] (two E2M1 nibbles per byte, even k in
// the low nibble), scales e4m3 [G, N, Kp/16], tensor scales f32 on the
// device, one per group (ts_stride 1) or one for all (ts_stride 0); Kp >= K
// is the stored, block-padded K.  The group is blockIdx.z: a block moves
// its base pointers to its group and then runs exactly the code of a
// single-matrix launch, so group g of K3 equals K2 on group g's slices
// bitwise.
//
// Design: a tensor-core GEMM for every M, swap-AB: Y^T = W^T X^T, the
// weight's N rows on the MMA's rows (16 per mma.sync.m16n8k16, 64 per
// wgmma.m64nNk16), tokens on its columns (8 per fragment), bf16 in, f32
// accumulate.  Codes, scales and x stream through a ring of shared memory
// filled by cp.async, 64 k per chunk.  A thread decodes its A fragments from
// the ring straight into registers; no decoded weight goes back to shared
// memory.  The 64 k of a chunk are taken in a permuted order so that a
// thread's A elements are the 8 code bytes of one 16-element block (one
// scale): thread (g, t) takes block t, and MMA j the k values
// 16t + 4j .. 16t + 4j + 3.  B follows the same permutation, so the
// products are those of y = x W.
//
// Decode, exact: per block a thread builds the eight bf16 values
// round_bf16(f32(e2m1 * s)), s = f32(e4m3) * tensor_scale, e2m1 in
// {0, .5, 1, 1.5, 2, 3, 4, 6}, with the same f32 multiply and rounding as
// the plain version, and keeps their low and high bytes as two 8-byte
// tables.  An element is then two prmt lookups by its nibble's magnitude
// bits plus its sign bit: about 2 integer ops per element, bitwise equal
// to nvfp4.unpack.
//
// Two forms, picked by M (rows per group):
//  * split (M <= 32; decode, paged-prefill chunks), mma.sync: KW =
//    ksplit(Kp) warps of a block share 16-64 rows, each on its own
//    contiguous K range, x loaded per warp into B fragments; the ranges'
//    sums are added in order through shared memory.  Bound: the packed
//    weight's bytes (0.5625 B/param).  The K split keeps thousands of
//    warps' loads in flight even at N = 3584, K = 18944.
//  * tile (M > 32; prefill), wgmma for bf16 x: two or three warpgroups own
//    128 or 192 rows x 64 tokens; each warp decodes its 16 rows, and
//    wgmma reads x from shared memory in the same permuted order (the
//    wrapper lays x out so, see kernels/nvfp4_matmul.py::_tile_order).
//    x arrives by TMA (box copies through the async proxy that wgmma
//    reads, counted on an mbarrier), codes and scales by cp.async.  Bound:
//    operations; measured, the decode and the MMAs of a chunk run one
//    after the other (ptxas serializes a wgmma whose A registers other
//    instructions define, so the decode of chunk c + 1 cannot hide under
//    chunk c's MMAs), and each block reads all of its tokens' x.
//
// Tolerance.  A bf16 product is exact in f32.  Hopper's MMA aligns and
// truncates inside one instruction, so no MMA chain runs long: the four
// MMAs of a chunk (twelve for f32 x) run into a zeroed fragment, which an
// FADD adds to the f32 sum (promotion every 64 k).  The output is rounded
// once.
//
// Row invariance.  Each output element's K order depends on Kp alone, the
// same at every M and in both forms: Kp is cut into ksplit(Kp) contiguous
// ranges of 64-k chunks; a range is summed chunk by chunk from zero; the
// range sums are added in order, P0 + P1 + ... .  The split form runs the
// ranges on separate warps, the tile form in turn, keeping the running
// total in shared memory.  An MMA's column depends on that column's inputs
// only, and a chunk's wgmma chain gives the bits of the same mma.sync
// chain (held by the card tests), so a token's row of y does not depend on
// M, on the other tokens or on its place in the tile.
//
// f32 x is split exactly into three bf16 parts, x = hi + mid + lo, and each
// A fragment meets all three (three MMAs).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;      // K elements per warp and pipeline stage
constexpr int kRowBytes = 32;   // code bytes of one row in a chunk
constexpr int kRowScales = 4;   // scale bytes of one row in a chunk

// the number of contiguous K ranges: a function of the stored K alone
__host__ __device__ __forceinline__ int ksplit(int kp) {
  return kp > 4096 ? 8 : 4;
}
__host__ __device__ __forceinline__ int range_lo(int r, int chunks, int s) {
  return r * chunks / s;
}

__device__ __forceinline__ float e4m3_to_f32(uint8_t s) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)s, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16, 8 or 4 bytes; zero-fills the destination when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A B on the tensor cores: A 16 x 16 bf16 (4 registers), B 16 x 8
// bf16 (2 registers), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The eight bf16 magnitudes of one 16-element block, split into their low
// and high bytes: byte i of lo03:lo47 (hi03:hi47) is the low (high) byte of
// round_bf16(f32(e2m1_i * s)), e2m1 = 0, .5, 1, 1.5, 2, 3, 4, 6.
struct Lut {
  uint32_t lo03, lo47, hi03, hi47;
};
__device__ __forceinline__ Lut make_lut(float s) {
  const uint32_t q01 = bf16x2_bits(0.0f * s, 0.5f * s);
  const uint32_t q23 = bf16x2_bits(1.0f * s, 1.5f * s);
  const uint32_t q45 = bf16x2_bits(2.0f * s, 3.0f * s);
  const uint32_t q67 = bf16x2_bits(4.0f * s, 6.0f * s);
  return {__byte_perm(q01, q23, 0x6420), __byte_perm(q45, q67, 0x6420),
          __byte_perm(q01, q23, 0x7531), __byte_perm(q45, q67, 0x7531)};
}

// One word of codes (bytes 0..3, eight nibbles) -> p[i], the bf16x2 pair of
// byte i (its low nibble in the low half).  The nibble's magnitude bits
// index the tables; its sign bit becomes the value's.
__device__ __forceinline__ void decode_word(uint32_t w, const Lut& l, uint32_t& p0,
                                            uint32_t& p1, uint32_t& p2,
                                            uint32_t& p3) {
  const uint32_t idx = w & 0x77777777u;
  const uint32_t idx_hi = idx >> 16;
  const uint32_t w4 = w << 4;
  // byte i of the sign words carries nibble i's sign bit in its msb
  const uint32_t lo_a = __byte_perm(l.lo03, l.lo47, idx);
  const uint32_t hi_a = __byte_perm(l.hi03, l.hi47, idx) |
                        (__byte_perm(w4, w, 0x5140) & 0x80808080u);
  const uint32_t lo_b = __byte_perm(l.lo03, l.lo47, idx_hi);
  const uint32_t hi_b = __byte_perm(l.hi03, l.hi47, idx_hi) |
                        (__byte_perm(w4, w, 0x7362) & 0x80808080u);
  p0 = __byte_perm(lo_a, hi_a, 0x5140);
  p1 = __byte_perm(lo_a, hi_a, 0x7362);
  p2 = __byte_perm(lo_b, hi_b, 0x5140);
  p3 = __byte_perm(lo_b, hi_b, 0x7362);
}

// B fragments of one token fragment for the 4 MMAs of a chunk: thread
// (g, t) holds x[g][16t .. 16t + 15] of the chunk; MMA j takes values
// 4j .. 4j + 3 (b0: the first two, b1: the next two).  f32 x carries its
// three bf16 parts.
template <typename TX>
struct BFrag;
template <>
struct BFrag<__nv_bfloat16> {
  static constexpr int kParts = 1;
  uint32_t v[4][1][2];
  __device__ __forceinline__ void load(const uint8_t* row, int t) {
    const uint4 u0 = *reinterpret_cast<const uint4*>(row + 32 * t);
    const uint4 u1 = *reinterpret_cast<const uint4*>(row + 32 * t + 16);
    v[0][0][0] = u0.x; v[0][0][1] = u0.y; v[1][0][0] = u0.z; v[1][0][1] = u0.w;
    v[2][0][0] = u1.x; v[2][0][1] = u1.y; v[3][0][0] = u1.z; v[3][0][1] = u1.w;
  }
};
// x = hi + mid + lo exactly: each part is the bf16 rounding of what the
// parts before it leave, and each difference is exact in f32
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const __nv_bfloat162 md = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(ra - __low2float(md), rb - __high2float(md));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&md);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
struct BFrag<float> {
  static constexpr int kParts = 3;
  uint32_t v[4][3][2];
  __device__ __forceinline__ void load(const uint8_t* row, int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = *reinterpret_cast<const float4*>(row + 64 * t + 16 * j);
      split3(f.x, f.y, v[j][0][0], v[j][1][0], v[j][2][0]);
      split3(f.z, f.w, v[j][0][1], v[j][1][1], v[j][2][1]);
    }
  }
};

// Shared memory of one stage, per K-warp q: codes [BR][32], scales [BR][4],
// x [BT][kXRow] (a chunk's 64 values, padded by 16 bytes: conflict-free
// 16-byte reads).
template <typename TX, int BR, int BT, int KW>
struct Ring {
  static constexpr int kXRow = kChunk * (int)sizeof(TX) + 16;
  static constexpr int kCodes = BR * kRowBytes;
  static constexpr int kScales = BR * kRowScales;
  static constexpr int kPerKw = kCodes + kScales + BT * kXRow;
  static constexpr int kStage = KW * kPerKw;
};

// at most 128 registers a thread, or 255 for warp tiles of 8 or more
// fragment products (f32 x counts its three parts)
constexpr int kMinBlocks(int nt, int frags) {
  return frags >= 8 ? (nt >= 256 ? 1 : 256 / nt) : (nt >= 512 ? 1 : 512 / nt);
}

__device__ __forceinline__ void zero_bytes(uint8_t* p, int bytes, int tid, int nt) {
  for (int i = tid; i < bytes / 4; i += nt) reinterpret_cast<uint32_t*>(p)[i] = 0u;
}

// The split form on mma.sync.  One block: rows [n0, n0 + BR) x tokens
// [t0, t0 + BT) of one group; warp = wr * KW + kw: row warp wr owns FN row
// fragments and all FT token fragments, and K-warp kw sums K range kw
// (KW == ksplit(kp)).
template <bool GROUPED, typename TX, int FN, int FT, int WR, int KW, int STAGES>
__global__ void __launch_bounds__(WR * KW * 32,
                                  kMinBlocks(WR * KW * 32, FN * FT * BFrag<TX>::kParts))
mma_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
           const uint8_t* __restrict__ scales,
           const float* __restrict__ tensor_scale, void* __restrict__ out,
           int out_is_f32, int ts_stride, int m, int n, int k, int kp) {
  constexpr int BR = WR * FN * 16, BT = FT * 8, NT = WR * KW * 32;
  constexpr int NP = BFrag<TX>::kParts;
  using R = Ring<TX, BR, BT, KW>;
  extern __shared__ __align__(16) uint8_t smem[];

  if (GROUPED) {  // this block's group: move the operands to its slices
    const long long g = blockIdx.z;
    x += g * m * k;
    codes += g * n * (kp / 2);
    scales += g * n * (kp / 16);
    tensor_scale += g * ts_stride;
    out = static_cast<uint8_t*>(out) + g * m * n * (out_is_f32 ? 4 : 2);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp % KW, wr = warp / KW;
  const int g = lane >> 2, t = lane & 3;
  const int kh = kp / 2, kb = kp / 16;
  const int n0 = blockIdx.x * BR, t0 = blockIdx.y * BT;
  const int nvalid = min(BR, n - n0), mvalid = min(BT, m - t0);
  const int chunks = (kp + kChunk - 1) / kChunk;
  const int iters = (chunks + KW - 1) / KW;  // the longest range
  const bool codes16 =
      kh % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool scales4 =
      kb % 4 == 0 && (reinterpret_cast<uintptr_t>(scales) & 3) == 0;
  const float s_t = tensor_scale[0];

  // rows no load fills stay zero: weight rows past N, token rows past M
  if (nvalid < BR || mvalid < BT) {
    for (int s = 0; s < STAGES * KW; ++s) {
      uint8_t* b = smem + s * R::kPerKw;
      zero_bytes(b + nvalid * kRowBytes, (BR - nvalid) * kRowBytes, tid, NT);
      zero_bytes(b + R::kCodes + nvalid * kRowScales, (BR - nvalid) * kRowScales,
                 tid, NT);
      zero_bytes(b + R::kCodes + R::kScales + mvalid * R::kXRow,
                 (BT - mvalid) * R::kXRow, tid, NT);
    }
  }

  // K-warp q's chunks [lo, lo + len), range q.  Computed once per piece
  // (an integer division is a long routine), by an unrolled select so no
  // array is indexed at run time.
  auto range_of = [&](int q, int& lo, int& len) {
    lo = 0;
    len = -1;  // q out of range: no chunk
#pragma unroll
    for (int v = 0; v < KW; ++v)
      if (q == v) {
        lo = range_lo(v, chunks, KW);
        len = range_lo(v + 1, chunks, KW) - lo;
      }
  };

  // This thread's copies of a stage, planned once: piece u of the codes is
  // (K-warp, row, byte offset); the same for scales and x.  At step it a
  // piece moves chunk lo + it of its K-warp's range, while it < len.
  const int cbytes = codes16 ? 16 : 8;                 // code piece size
  const int cper = kRowBytes / cbytes;
  constexpr int kXPer = 16 / (int)sizeof(TX);          // x values per piece
  constexpr int kXPieces = kChunk / kXPer;             // pieces per x row
  constexpr int CU = (KW * BR * 4 + NT - 1) / NT;
  constexpr int SU = (KW * BR + NT - 1) / NT;
  constexpr int XU = (KW * BT * kXPieces + NT - 1) / NT;
  const uint8_t* code_src[CU];
  int code_dst[CU], code_lo[CU], code_len[CU], code_p[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    const int i = tid + u * NT;
    const int q = i / (BR * cper), r = i / cper % BR, p = i % cper * cbytes;
    range_of(r < nvalid ? q : -1, code_lo[u], code_len[u]);
    code_p[u] = p;
    code_dst[u] = q * R::kPerKw + r * kRowBytes + p;
    code_src[u] = codes + (long long)(n0 + r) * kh + p;
  }
  const uint8_t* sc_src[SU];
  int sc_dst[SU], sc_lo[SU], sc_len[SU];
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    const int i = tid + u * NT, q = i / BR, r = i % BR;
    range_of(r < nvalid ? q : -1, sc_lo[u], sc_len[u]);
    sc_dst[u] = q * R::kPerKw + R::kCodes + r * kRowScales;
    sc_src[u] = scales + (long long)(n0 + r) * kb;
  }
  const TX* x_src[XU];
  int x_dst[XU], x_lo[XU], x_len[XU], x_k[XU];
#pragma unroll
  for (int u = 0; u < XU; ++u) {
    const int i = tid + u * NT;
    const int q = i / (BT * kXPieces), r = i / kXPieces % BT, p = i % kXPieces;
    range_of(r < mvalid ? q : -1, x_lo[u], x_len[u]);
    x_k[u] = p * kXPer;
    x_dst[u] = q * R::kPerKw + R::kCodes + R::kScales + r * R::kXRow + p * 16;
    x_src[u] = x + (long long)(t0 + r) * k + p * kXPer;
  }

  auto load = [&](int slot, int it) {
    uint8_t* st = smem + slot * R::kStage;
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (it >= code_len[u]) continue;
      const int c = code_lo[u] + it;
      const bool in = c * kRowBytes + code_p[u] < kh;   // the last chunk may be short
      const uint8_t* src = in ? code_src[u] + c * kRowBytes : codes;
      if (codes16) cp_async16(st + code_dst[u], src, in);
      else cp_async8(st + code_dst[u], src, in);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      if (it >= sc_len[u]) continue;
      const int c = sc_lo[u] + it;
      if (scales4) {  // Kp % 64 == 0: every chunk is whole
        cp_async4(st + sc_dst[u], sc_src[u] + c * kRowScales);
      } else {        // rows not 4-byte aligned: plain loads
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c * kRowScales + e < kb) v |= (uint32_t)sc_src[u][c * kRowScales + e] << (8 * e);
        *reinterpret_cast<uint32_t*>(st + sc_dst[u]) = v;
      }
    }
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      if (it >= x_len[u]) continue;
      const int c = x_lo[u] + it;
      const bool in = c * kChunk + x_k[u] < k;
      cp_async16(st + x_dst[u],
                 in ? static_cast<const void*>(x_src[u] + c * kChunk)
                    : static_cast<const void*>(x), in);
    }
  };

  float acc[FN][FT][4];  // the open range's sum
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int j = 0; j < FT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] = 0.0f;

  int my_lo, my_len;  // this warp's chunks
  range_of(kw, my_lo, my_len);
  auto compute = [&](int slot, int it) {
    if (it >= my_len) return;
    const uint8_t* b = smem + (slot * KW + kw) * R::kPerKw;
    const uint8_t* cs = b + wr * FN * 16 * kRowBytes;
    const uint8_t* ss = b + R::kCodes + wr * FN * 16 * kRowScales;
    const uint8_t* xs = b + R::kCodes + R::kScales;
    uint32_t a[FN][4][4];  // [row fragment][MMA j][register]
#pragma unroll
    for (int f = 0; f < FN; ++f) {
      const int r0 = f * 16 + g;
      const uint2 c0 = *reinterpret_cast<const uint2*>(cs + r0 * kRowBytes + 8 * t);
      const uint2 c1 = *reinterpret_cast<const uint2*>(cs + (r0 + 8) * kRowBytes + 8 * t);
      const Lut l0 = make_lut(e4m3_to_f32(ss[r0 * kRowScales + t]) * s_t);
      const Lut l1 = make_lut(e4m3_to_f32(ss[(r0 + 8) * kRowScales + t]) * s_t);
      // code byte 2j -> k pair (2t, 2t+1) of MMA j, byte 2j+1 -> (2t+8, 2t+9)
      decode_word(c0.x, l0, a[f][0][0], a[f][0][2], a[f][1][0], a[f][1][2]);
      decode_word(c0.y, l0, a[f][2][0], a[f][2][2], a[f][3][0], a[f][3][2]);
      decode_word(c1.x, l1, a[f][0][1], a[f][0][3], a[f][1][1], a[f][1][3]);
      decode_word(c1.y, l1, a[f][2][1], a[f][2][3], a[f][3][1], a[f][3][3]);
    }
    // every token fragment, those past M included (their x rows are zero):
    // no branch between the MMA chains, so they overlap
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      BFrag<TX> bf;
      bf.load(xs + (j * 8 + g) * R::kXRow, t);
#pragma unroll
      for (int f = 0; f < FN; ++f) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int p = 0; p < NP; ++p) mma_bf16(d, a[f][s], bf.v[s][p][0], bf.v[s][p][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][j][i] += d[i];
      }
    }
  };

  // the pipeline: STAGES - 1 stages in flight ahead of the one in use
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < iters) load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();
    compute(it % STAGES, it);
  }

  // sum the K-warps' ranges in order, P0 + P1 + ...; warp kw = 0 of each
  // row warp writes
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kPer = FN * FT * 4 * 32;
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int j = 0; j < FT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp * kPer + ((f * FT + j) * 4 + i) * 32 + lane] = acc[f][j][i];
  __syncthreads();
  if (kw != 0) return;
  float y[FN][FT][4];
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int j = 0; j < FT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = warp * kPer + ((f * FT + j) * 4 + i) * 32 + lane;
        float v = red[o];
#pragma unroll
        for (int q = 1; q < KW; ++q) v = v + red[q * kPer + o];
        y[f][j][i] = v;
      }

  // d0: (row g, token 2t), d1: (g, 2t+1), d2: (g+8, 2t), d3: (g+8, 2t+1)
#pragma unroll
  for (int f = 0; f < FN; ++f) {
    const int row = n0 + wr * FN * 16 + f * 16 + g;
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      const int tok = t0 + j * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = row + (i >> 1) * 8, tt = tok + (i & 1);
        if (rr >= n || tt >= m) continue;
        const long long o = (long long)tt * n + rr;
        if (out_is_f32)
          static_cast<float*>(out)[o] = y[f][j][i];
        else
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y[f][j][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tile form on wgmma (bf16 x, M > 32): a warpgroup's four warps decode 64
// weight rows into A fragments in registers (the same layout as mma.sync's
// A, the same permuted K order and decode), and wgmma.m64nBTk16 multiplies
// them with x read from shared memory by descriptor, in wgmma's K-major
// core-matrix layout without swizzle.  x comes in the permuted order
// (_tile_order): its 16-byte piece q of a chunk is slice q = 2j + b (MMA j,
// k half b), the words 8a + 2j + b (a = 0..3) of the token's 64 values, so
// a core-matrix row is the k values 16a + 4j + 2b + {0, 1}.  One TMA box
// (8 values x BT tokens) fills one slice.
// ---------------------------------------------------------------------------

constexpr int kTileT = 64;   // tokens of a tile-form block (wgmma's N)

// the four chained MMAs of one 64-k chunk, back to back: d = A0 B0 (d not
// read), then d += Aj Bj; nothing else runs between them
__device__ __forceinline__ void wgmma_chunk(float (&d)[kTileT / 2], const uint32_t (&a)[4][4],
                                            const uint64_t (&desc)[4]) {
  asm volatile(
      "{\n.reg .pred zero, keep;\n"
      "setp.ne.b32 zero, 0, 0;\n"
      "setp.eq.b32 keep, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %48, zero, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%36, %37, %38, %39}, %49, keep, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%40, %41, %42, %43}, %50, keep, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%44, %45, %46, %47}, %51, keep, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]), "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]), "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
        "l"(desc[0]), "l"(desc[1]), "l"(desc[2]), "l"(desc[3]));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// x reaches the tile form by TMA: a box copy through the async proxy,
// which wgmma reads, its completion counted in bytes on an mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// keep registers an in-flight wgmma reads or writes where they are: the
// compiler sees them used and redefined here
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[j][q])::"memory");
}
// shared-memory matrix descriptor, no swizzle: start, leading-dimension
// (K direction) and stride-dimension (8-row groups) byte offsets
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// One stage holds kCps consecutive chunks: codes [BR][kCodeRow] (a row's
// 32 bytes per chunk side by side, the row padded against bank conflicts),
// scales [BR][4 kCps], and per chunk the 8 x slices.
template <int BR, int kCps>
struct WgRing {
  static constexpr int kSlice = kTileT * 16;        // one (j, b) slice: 64 tokens x 16 B
  static constexpr int kCodeRow = kCps * kRowBytes + 16;
  static constexpr int kCodes = BR * kCodeRow;
  static constexpr int kScales = BR * kRowScales * kCps;
  static constexpr int kXChunk = 8 * kSlice;
  static constexpr int kStage = kCodes + kScales + kCps * kXChunk;
};

template <bool GROUPED, int NWG, int kCps, int STAGES>
__global__ void __launch_bounds__(NWG * 128, 1)
wg_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ codes,
          const uint8_t* __restrict__ scales, const float* __restrict__ tensor_scale,
          void* __restrict__ out, int out_is_f32, int ts_stride, int m, int n, int kp) {
  constexpr int BR = NWG * 64, NT = NWG * 128, BT = kTileT, NA = BT / 2;
  using R = WgRing<BR, kCps>;
  static_assert(STAGES >= 3, "the stage after the current one is decoded from");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint64_t xbar[STAGES];  // x of ring slot s has landed
  // TMA's destinations want more alignment than the dynamic base promises
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  if (GROUPED) {
    const long long g = blockIdx.z;
    codes += g * n * (kp / 2);
    scales += g * n * (kp / 16);
    tensor_scale += g * ts_stride;
    out = static_cast<uint8_t*>(out) + g * m * n * (out_is_f32 ? 4 : 2);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kh = kp / 2, kb = kp / 16;
  const int n0 = blockIdx.x * BR, t0 = blockIdx.y * BT;
  const int nvalid = min(BR, n - n0);
  const int chunks = (kp + kChunk - 1) / kChunk;
  const int stages = (chunks + kCps - 1) / kCps;
  const int nsplit = ksplit(kp);
  const bool codes16 = kh % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool scales4 = kb % 4 == 0 && (reinterpret_cast<uintptr_t>(scales) & 3) == 0;
  const float s_t = tensor_scale[0];

  // weight rows no copy fills stay zero (TMA zero-fills x past M and K)
  for (int s = 0; s < STAGES; ++s) {
    uint8_t* b = smem + s * R::kStage;
    zero_bytes(b + nvalid * R::kCodeRow, (BR - nvalid) * R::kCodeRow, tid, NT);
    zero_bytes(b + R::kCodes + nvalid * kRowScales * kCps,
               (BR - nvalid) * kRowScales * kCps, tid, NT);
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&xbar[s]);
    mbar_init_fence();
  }
  __syncthreads();

  // copy plans, per stage: code pieces (row, chunk h, offset) and scale
  // words (row, chunk h); x is one box (BT tokens x 8 values) per chunk
  // and slice
  const int cbytes = codes16 ? 16 : 8, cper = kRowBytes / cbytes;
  constexpr int CU = (BR * 4 * kCps + NT - 1) / NT;
  const uint8_t* code_src[CU];
  int code_dst[CU], code_k[CU];
  bool code_on[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    const int i = tid + u * NT, r = i / (cper * kCps), h = i / cper % kCps;
    const int p = i % cper * cbytes;
    code_on[u] = r < nvalid;
    code_k[u] = h * kRowBytes + p;              // byte offset in the stage's K
    code_dst[u] = r * R::kCodeRow + h * kRowBytes + p;
    code_src[u] = codes + (long long)(n0 + r) * kh + h * kRowBytes + p;
  }
  constexpr int SU = (BR * kCps + NT - 1) / NT;

  auto load = [&](int slot, int sg) {
    uint8_t* st = smem + slot * R::kStage;
    const int c0 = sg * kCps;               // the stage's first chunk
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (!code_on[u]) continue;
      const bool in = c0 * kRowBytes + code_k[u] < kh;
      const uint8_t* src = in ? code_src[u] + c0 * kRowBytes : codes;
      if (codes16) cp_async16(st + code_dst[u], src, in);
      else cp_async8(st + code_dst[u], src, in);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int i = tid + u * NT, r = i / kCps, h = i % kCps;
      if (r >= nvalid) continue;
      const uint8_t* ss = scales + (long long)(n0 + r) * kb + (c0 + h) * kRowScales;
      uint8_t* sd = st + R::kCodes + (r * kCps + h) * kRowScales;
      if (c0 + h >= chunks) {  // the phantom chunk past an odd count: zeros
        *reinterpret_cast<uint32_t*>(sd) = 0u;
      } else if (scales4) {
        cp_async4(sd, ss);
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((c0 + h) * kRowScales + e < kb) v |= (uint32_t)ss[e] << (8 * e);
        *reinterpret_cast<uint32_t*>(sd) = v;
      }
    }
    if (tid == 0) {  // one thread sends the stage's x boxes
      mbar_expect_tx(&xbar[slot], kCps * 8 * BT * 16);
#pragma unroll
      for (int h = 0; h < kCps; ++h)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          tma_load_3d(st + R::kCodes + R::kScales + h * R::kXChunk + q * R::kSlice, &xmap,
                      (c0 + h) * kChunk + 8 * q, t0, GROUPED ? (int)blockIdx.z : 0,
                      &xbar[slot]);
    }
  };

  // A fragments of this warp's 16 rows for the 4 MMAs of chunk c
  auto decode = [&](int c, uint32_t (&a)[4][4]) {
    const uint8_t* b = smem + (c / kCps % STAGES) * R::kStage;
    const int h = c % kCps, r0 = warp * 16 + g;
    const uint2 c0 = *reinterpret_cast<const uint2*>(b + r0 * R::kCodeRow + h * kRowBytes + 8 * t);
    const uint2 c1 =
        *reinterpret_cast<const uint2*>(b + (r0 + 8) * R::kCodeRow + h * kRowBytes + 8 * t);
    const uint8_t* sc = b + R::kCodes + h * kRowScales + t;
    const Lut l0 = make_lut(e4m3_to_f32(sc[r0 * kRowScales * kCps]) * s_t);
    const Lut l1 = make_lut(e4m3_to_f32(sc[(r0 + 8) * kRowScales * kCps]) * s_t);
    decode_word(c0.x, l0, a[0][0], a[0][2], a[1][0], a[1][2]);
    decode_word(c0.y, l0, a[2][0], a[2][2], a[3][0], a[3][2]);
    decode_word(c1.x, l1, a[0][1], a[0][3], a[1][1], a[1][3]);
    decode_word(c1.y, l1, a[2][1], a[2][3], a[3][1], a[3][3]);
  };

  float acc[NA], tmp[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = tmp[i] = 0.0f;
  float* tot = reinterpret_cast<float*>(smem + STAGES * R::kStage) + tid;
  int r_open = 0, r_end = range_lo(1, chunks, nsplit);
  auto close_ranges = [&](int upto) {
    while (r_open < nsplit && r_end <= upto) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        float* p = tot + i * NT;
        *p = r_open == 0 ? acc[i] : *p + acc[i];
        acc[i] = 0.0f;
      }
      ++r_open;
      r_end = range_lo(r_open + 1, chunks, nsplit);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) load(s, s);
    cp_async_commit();
  }
  uint32_t a_cur[4][4], a_nxt[4][4];
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  decode(0, a_cur);
  for (int sg = 0; sg < stages; ++sg) {
    cp_async_wait<STAGES - 3>();   // codes and scales of stages sg, sg + 1
    mbar_wait(&xbar[sg % STAGES], (sg / STAGES) & 1);   // x of stage sg
    __syncthreads();
    if (sg + STAGES - 1 < stages) load((sg + STAGES - 1) % STAGES, sg + STAGES - 1);
    cp_async_commit();
    // every stage runs kCps chunks: past an odd count the last is a zero
    // phantom, whose range has closed before it is added.  No branch
    // between a wgmma and its wait.
#pragma unroll
    for (int h = 0; h < kCps; ++h) {
      const int c = sg * kCps + h;
      close_ranges(c);
      const uint8_t* xs = smem + (sg % STAGES) * R::kStage + R::kCodes + R::kScales +
                          h * R::kXChunk;
      uint64_t desc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) desc[j] = wg_desc(xs + 2 * j * R::kSlice, R::kSlice, 128);
      reg_fence(tmp);
      reg_fence(a_cur);
      wgmma_fence();
      wgmma_chunk(tmp, a_cur, desc);
      wgmma_commit();
      decode(c + 1, a_nxt);   // while the MMAs run (past the end: unused)
      wgmma_wait_all();
      reg_fence(tmp);
      reg_fence(a_cur);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += tmp[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) a_cur[j][q] = a_nxt[j][q];
    }
  }
  close_ranges(chunks);

  // per 8-token block i: d[4i] (row g, token 8i + 2t), d[4i + 1] (g, 8i + 2t + 1),
  // d[4i + 2] (g + 8, 8i + 2t), d[4i + 3] (g + 8, 8i + 2t + 1)
  const int row = n0 + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int rr = row + ((i >> 1) & 1) * 8, tt = t0 + (i >> 2) * 8 + 2 * t + (i & 1);
    if (rr >= n || tt >= m) continue;
    const float v = tot[i * NT];
    const long long o = (long long)tt * n + rr;
    if (out_is_f32)
      static_cast<float*>(out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against the driver library)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

template <bool GROUPED, int NWG, int kCps, int STAGES>
cudaError_t launch_wg(const void* x, const void* codes, const void* scales,
                      const void* ts, void* out, int out_is_f32, int groups,
                      int ts_stride, int m, int n, int k, int kp, cudaStream_t s) {
  constexpr int BR = NWG * 64, NT = NWG * 128, BT = kTileT;
  // x [G, M, K] bf16 as boxes of 8 values x BT tokens; rows past M and
  // values past K read as zeros
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)m, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)k * 2, (cuuint64_t)m * k * 2};
  const cuuint32_t box[3] = {8, BT, 1}, unit[3] = {1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  constexpr int kSmem = STAGES * WgRing<BR, kCps>::kStage + NT * (BT / 2) * 4 + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block can have");
  auto kern = wg_kernel<GROUPED, NWG, kCps, STAGES>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  dim3 grid((n + BR - 1) / BR, (m + BT - 1) / BT, groups);
  kern<<<grid, NT, kSmem, s>>>(xmap, static_cast<const uint8_t*>(codes),
                               static_cast<const uint8_t*>(scales),
                               static_cast<const float*>(ts), out, out_is_f32,
                               ts_stride, m, n, kp);
  return cudaSuccess;
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms <= 0)
      sms = 132;
  }
  return sms;
}

template <bool GROUPED, typename TX, int FN, int FT, int WR, int KW, int STAGES>
cudaError_t launch_mma(const void* x, const void* codes, const void* scales,
                       const void* ts, void* out, int out_is_f32, int groups,
                       int ts_stride, int m, int n, int k, int kp, cudaStream_t s) {
  constexpr int BR = WR * FN * 16, BT = FT * 8, NT = WR * KW * 32;
  using R = Ring<TX, BR, BT, KW>;
  constexpr int kSmem = STAGES * R::kStage;
  static_assert(NT * FN * FT * 4 * 4 <= kSmem, "the ranges' sum reuses the ring");
  static_assert(kSmem <= 232448, "more shared memory than a block can have");
  auto kern = mma_kernel<GROUPED, TX, FN, FT, WR, KW, STAGES>;
  static bool ready = false;  // raise the dynamic shared memory limit once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  dim3 grid((n + BR - 1) / BR, (m + BT - 1) / BT, groups);
  kern<<<grid, NT, kSmem, s>>>(static_cast<const TX*>(x),
                               static_cast<const uint8_t*>(codes),
                               static_cast<const uint8_t*>(scales),
                               static_cast<const float*>(ts), out, out_is_f32,
                               ts_stride, m, n, k, kp);
  return cudaSuccess;
}

// Split form (M <= 32): KW = ksplit(kp) K-warps for each of WR row warps.
// The block shape changes only which block and warp computes an element,
// never its K order.
template <bool GROUPED, typename TX, int FN, int FT, int WR, int STAGES>
cudaError_t launch_split(const void* x, const void* codes, const void* scales,
                         const void* ts, void* out, int out_is_f32, int groups,
                         int ts_stride, int m, int n, int k, int kp, cudaStream_t s) {
  if (ksplit(kp) == 8)
    return launch_mma<GROUPED, TX, FN, FT, (WR > 2 ? 2 : WR), 8, STAGES>(
        x, codes, scales, ts, out, out_is_f32, groups, ts_stride, m, n, k, kp, s);
  return launch_mma<GROUPED, TX, FN, FT, WR, 4, STAGES>(
      x, codes, scales, ts, out, out_is_f32, groups, ts_stride, m, n, k, kp, s);
}

// Block shapes by M (rows per group) and grid size; none changes an
// element's K order.
template <bool GROUPED, typename TX>
cudaError_t dispatch(const void* x, const void* codes, const void* scales,
                     const void* ts, void* out, int out_is_f32, int groups,
                     int ts_stride, int m, int n, int k, int kp, cudaStream_t s) {
  const long long sms2 = 2LL * sm_count();
#define ARGS x, codes, scales, ts, out, out_is_f32, groups, ts_stride, m, n, k, kp, s
  if constexpr (sizeof(TX) == 4) {  // f32 x (edge cases only): split form, any M
    return launch_split<GROUPED, TX, 1, 4, 1, 2>(ARGS);
  } else {
    if (m <= 8)         // decode: one token fragment, 32 rows a block if that fills the card
      return (long long)groups * ((n + 31) / 32) >= sms2
                 ? launch_split<GROUPED, TX, 2, 1, 1, 6>(ARGS)
                 : launch_split<GROUPED, TX, 1, 1, 1, 6>(ARGS);
    if (m <= 16)        // a paged-prefill chunk: 64 rows a block share x
      return (long long)groups * ((n + 63) / 64) >= sms2
                 ? launch_split<GROUPED, TX, 2, 2, 2, 4>(ARGS)
                 : launch_split<GROUPED, TX, 1, 2, 4, 4>(ARGS);
    if (m <= 32)
      return (long long)groups * ((n + 31) / 32) >= sms2
                 ? launch_split<GROUPED, TX, 2, 4, 1, 3>(ARGS)
                 : launch_split<GROUPED, TX, 1, 4, 1, 3>(ARGS);
    // prefill (M > 32, the wrapper's TILE_M: x comes in _tile_order),
    // wgmma: 192 x 64 tiles where they still fill most SMs (they read x
    // once per 192 rows), else 128 x 64
    if ((long long)groups * ((n + 191) / 192) * ((m + 63) / 64) * 10 >= 7LL * sm_count())
      return launch_wg<GROUPED, 3, 1, 4>(ARGS);
    return launch_wg<GROUPED, 2, 2, 4>(ARGS);
  }
#undef ARGS
}

// Both entry points: pick the x type, launch, and return the launch's error
// (a refused launch never runs).  GROUPED (K3) moves each block to its
// group's slices and names the kernels apart from K2's in a profile; the
// arithmetic is the same.
template <bool GROUPED>
int run_matmul(const void* x, int x_is_f32, const void* codes,
               const void* scales, const void* tensor_scale, int ts_stride,
               void* out, int out_is_f32, int groups, int m, int n, int k,
               int kp, void* stream) {
  if (groups == 0 || m == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_is_f32 ? dispatch<GROUPED, float>(x, codes, scales, tensor_scale, out, out_is_f32,
                                          groups, ts_stride, m, n, k, kp, s)
               : dispatch<GROUPED, __nv_bfloat16>(x, codes, scales, tensor_scale, out,
                                                  out_is_f32, groups, ts_stride, m, n,
                                                  k, kp, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
