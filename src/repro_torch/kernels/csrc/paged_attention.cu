// Paged attention for the serving engine: page-table gather, FP8-KV
// dequantization and grouped-query attention in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention (body _attend_kernel).  For q [B, S, H, hd] bf16 against
// the pool pages k, v [n_blocks, bs, Hkv, hd] (bf16, or e4m3 with f32 scales
// [n_blocks, bs, Hkv]) through block_tables [B, MB] and the per-query valid
// key counts pos [B, S], each query row of head h (KV head h / n_rep) gets,
// in the oracle's (models/attention.py::paged_attend) rounding points:
//
//   s_j = (q . k_j) * scale                    f32, scale = f32(1/sqrt(hd))
//   key j valid iff j < pos and (window == 0 or j >= pos - window)
//   m = max_j s_j,  l = sum_j exp(s_j - m)     over the valid keys
//   p_j = bf16(exp(s_j - m) / l)
//   out = bf16(sum_j p_j v_j)                  f32 accumulation
//
// with FP8 pages dequantized as bf16(f32(e4m3) * scale) before use.
//
// The TPU kernel buffers the whole f32 score strip [R, MB * bs] (R = n_rep
// * S query rows) and the dequantized V pages in VMEM and runs the softmax
// once on its last sequential grid step.  Hopper has no sequential grid
// axis and a block gets at most 227 KB of shared memory, which the strip
// outgrows (258 KB for a 16-token replay chunk of acereason-7b against 576
// keys; 917 KB for one decode query at 32k).  So a block owns one
// (request, KV head), or up to 16 of its query rows (below), and walks the
// keys twice, in tiles of KT keys:
//
//   pass 1: scores -> per-row online (max, sum of exp), merged tile by tile;
//   pass 2: the same scores again -> p rounded to bf16 -> p V accumulated.
//
// Every rounding point of the oracle is kept; the kernel differs from its
// plain version only in the order of f32 sums (the dot products, the sum of
// exp, p V), and in the rescaling of the running sum when the row max
// grows.  Pass 2 recomputes the scores from K rather than keeping them in
// a device-memory workspace: K is re-read from L2 at decode, and the
// workspace would cost a write and a read of R * keys f32 per KV head (more
// bytes than K itself once R exceeds 64, as in the replay chunks).
//
// A block takes at most kRowsPerBlock (16) of its KV head's query rows: a
// 16-token chunk (112 rows for acereason-7b) spreads over 7 blocks per KV
// head, each walking the keys its own rows can see.
//
// Only the pages that hold valid keys are read: keys from the window's
// start (min pos - window) to max pos of the block's queries.  For a row
// with at least one valid key, skipping the rest is exact, because a masked
// key adds exp(-1e30 - m) = 0.  The reference reads all MB pages.
//
// Bound: bytes at decode (the valid K and V pages; 2 KB per token and layer
// for acereason-7b).  This first version leaves speed on the table: no
// split over the keys (at decode B * Hkv blocks, 32 for 8 slots of
// acereason-7b on 132 SMs), f32 FMAs from shared memory, no tensor cores.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;       // the oracle's NEG_INF
constexpr int kMaxSmem = 232448;        // 227 KB per block on Hopper
constexpr int kRowsPerBlock = 16;

struct Args {
  const __nv_bfloat16* q;   // [B, S, H, hd]
  const void* k;            // [n_blocks, bs, Hkv, hd] bf16 or e4m3
  const void* v;
  const float* k_scale;     // [n_blocks, bs, Hkv] (FP8 pages only)
  const float* v_scale;
  const int* bt;            // [B, MB]
  const int* pos;           // [B, S]
  __nv_bfloat16* out;       // [B, S, H, hd]
  int s, h, hkv, hd, bs, mb, window, kt, rb;
  float scale;
};

__device__ __forceinline__ float e4m3_to_f32(uint8_t x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x),
                                         __NV_E4M3);
  return __half2float(__half(h));
}

// Stage keys [j0, j0 + n) of one KV head into dst (row stride ld) as f32
// holding bf16 values, 8 elements per load.
template <bool kFp8>
__device__ __forceinline__ void load_tile(const Args& a, int b, int kvh,
                                          int j0, int n, const void* pages,
                                          const float* scales, float* dst,
                                          int ld) {
  const int chunks = a.hd / 8;
  for (int c = threadIdx.x; c < n * chunks; c += kThreads) {
    const int j = c / chunks, part = c % chunks;
    const int key = j0 + j;
    const int page = a.bt[b * a.mb + key / a.bs];
    const long row = ((long)page * a.bs + key % a.bs) * a.hkv + kvh;
    float* o = dst + j * ld + part * 8;
    if (kFp8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          static_cast<const uint8_t*>(pages) + row * a.hd + part * 8);
      const uint8_t* e = reinterpret_cast<const uint8_t*>(&raw);
      const float sc = scales[row];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = __bfloat162float(__float2bfloat16_rn(e4m3_to_f32(e[i]) * sc));
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(pages) + row * a.hd + part * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(e[i]);
    }
  }
}

__device__ __forceinline__ bool valid_key(int key, int p, int window) {
  return key < p && (window == 0 || key >= p - window);
}

// Scaled, masked scores of the R rows against the n staged keys into sc.
__device__ __forceinline__ void scores(const Args& a, int rows, int n, int j0,
                                       const float* qs, const float* ks,
                                       const int* rpos, float* sc) {
  for (int p = threadIdx.x; p < rows * n; p += kThreads) {
    const int r = p / n, j = p % n;
    const float* qr = qs + r * a.hd;
    const float* kj = ks + j * (a.hd + 1);
    float dot = 0.0f;
    for (int d = 0; d < a.hd; ++d) dot = fmaf(qr[d], kj[d], dot);
    sc[r * a.kt + j] =
        valid_key(j0 + j, rpos[r], a.window) ? dot * a.scale : kMasked;
  }
}

template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  const int b = blockIdx.x / a.hkv, kvh = blockIdx.x % a.hkv;
  const int n_rep = a.h / a.hkv, hd = a.hd;
  // this block's query rows: r0 .. r0 + rows of the KV head's n_rep * S;
  // row g = rep * S + i holds query i of head kvh * n_rep + rep
  const int r0 = blockIdx.y * a.rb;
  const int rows = min(a.rb, n_rep * a.s - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* qs = smem;                          // [rows, hd]
  float* acc = qs + a.rb * hd;               // [rows, hd]
  float* ks = acc + a.rb * hd;               // [kt, hd + 1]
  float* vs = ks + a.kt * (hd + 1);          // [kt, hd]
  float* sc = vs + a.kt * hd;                // [rows, kt]
  float* m_s = sc + a.rb * a.kt;             // [rows]
  float* l_s = m_s + a.rb;                   // [rows]
  int* rpos = reinterpret_cast<int*>(l_s + a.rb);  // [rows] valid-key counts

  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int g = r0 + e / hd, d = e % hd;
    const int head = kvh * n_rep + g / a.s;
    qs[e] = __bfloat162float(
        a.q[((long)(b * a.s + g % a.s) * a.h + head) * hd + d]);
    acc[e] = 0.0f;
  }
  int lo = 1 << 30, hi = 0;
  for (int r = 0; r < rows; ++r) {
    const int p = a.pos[b * a.s + (r0 + r) % a.s];
    lo = min(lo, p);
    hi = max(hi, p);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
    rpos[r] = a.pos[b * a.s + (r0 + r) % a.s];
  }
  // the keys any query row of this block can see
  const int j_lo = a.window ? max(lo - a.window, 0) : 0;
  const int j_hi = min(hi, a.mb * a.bs);
  const void* kp = a.k;
  const void* vp = a.v;
  __syncthreads();

  // pass 1: per-row max and sum of exp, merged online tile by tile
  for (int j0 = j_lo; j0 < j_hi; j0 += a.kt) {
    const int n = min(a.kt, j_hi - j0);
    load_tile<kFp8>(a, b, kvh, j0, n, kp, a.k_scale, ks, hd + 1);
    __syncthreads();
    scores(a, rows, n, j0, qs, ks, rpos, sc);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const float* sr = sc + r * a.kt;
      float tmax = -INFINITY;
      for (int j = lane; j < n; j += 32)
        if (valid_key(j0 + j, rpos[r], a.window)) tmax = fmaxf(tmax, sr[j]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      if (tmax == -INFINITY) continue;       // nothing valid in this tile
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32)
        if (valid_key(j0 + j, rpos[r], a.window)) sum += expf(sr[j] - m_new);
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
  }

  // pass 2: p = bf16(exp(s - m) / l), out += p V
  for (int j0 = j_lo; j0 < j_hi; j0 += a.kt) {
    const int n = min(a.kt, j_hi - j0);
    load_tile<kFp8>(a, b, kvh, j0, n, kp, a.k_scale, ks, hd + 1);
    load_tile<kFp8>(a, b, kvh, j0, n, vp, a.v_scale, vs, hd);
    __syncthreads();
    scores(a, rows, n, j0, qs, ks, rpos, sc);
    __syncthreads();
    for (int p = threadIdx.x; p < rows * n; p += kThreads) {
      const int r = p / n, j = p % n;
      float& s = sc[r * a.kt + j];
      s = valid_key(j0 + j, rpos[r], a.window)
              ? __bfloat162float(__float2bfloat16_rn(expf(s - m_s[r]) / l_s[r]))
              : 0.0f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float* pr = sc + r * a.kt;
      float o = acc[e];
      for (int j = 0; j < n; ++j) o = fmaf(pr[j], vs[j * hd + d], o);
      acc[e] = o;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int g = r0 + e / hd, d = e % hd;
    const int head = kvh * n_rep + g / a.s;
    a.out[((long)(b * a.s + g % a.s) * a.h + head) * hd + d] =
        __float2bfloat16_rn(acc[e]);
  }
}

size_t smem_bytes(int rows, int hd, int kt) {
  return sizeof(float) * ((size_t)2 * rows * hd + (size_t)kt * (hd + 1) +
                          (size_t)kt * hd + (size_t)rows * kt + 2 * rows) +
         sizeof(int) * rows;
}

}  // namespace

// Returns cudaErrorInvalidValue when even an 8-key tile does not fit in
// shared memory (a head dim too large for 16 query rows).
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               int fp8, const void* bt, const void* pos,
                               void* out, int b, int s, int h, int hkv, int hd,
                               int bs, int mb, int window, float scale,
                               void* stream) {
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  const int rows = (h / hkv) * s;
  const int rb = min(rows, kRowsPerBlock);
  int kt = 64;
  while (kt >= 8 && smem_bytes(rb, hd, kt) > (size_t)kMaxSmem) kt /= 2;
  if (kt < 8) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rb, hd, kt);
  const dim3 grid(b * hkv, (rows + rb - 1) / rb);
  Args a{static_cast<const __nv_bfloat16*>(q), k, v,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(bt), static_cast<const int*>(pos),
         static_cast<__nv_bfloat16*>(out), s, h, hkv, hd, bs, mb, window, kt,
         rb, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8) {
    cudaFuncSetAttribute(paged_attention_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    paged_attention_kernel<true><<<grid, kThreads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(paged_attention_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    paged_attention_kernel<false><<<grid, kThreads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}
