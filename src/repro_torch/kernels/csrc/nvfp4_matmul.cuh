// Device code shared by the packed-NVFP4 matmul (nvfp4_matmul.cu, K2) and
// its grouped form (nvfp4_matmul_grouped.cu, K3).
//
// y[g] = x[g] @ W_g with every W_g stored as packed NVFP4 W_g^T.  Inputs:
// x [G, M, K] (bf16 or f32, K the logical K), codes uint8 [G, N, Kp/2] (two
// E2M1 nibbles per byte, even index in the low nibble), scales e4m3
// [G, N, Kp/16] (the compact layout), tensor scales f32 on the device, one
// per group (ts_stride 1) or one shared by all groups (ts_stride 0); Kp >= K
// is the stored, block-padded K.  The group is blockIdx.z; each block of a
// grouped launch moves its base pointers to its group and then runs exactly
// the code of a single-matrix launch, so group g of a grouped launch
// computes bitwise what a single launch on group g's slices computes.
//
// Each weight element is decoded as e2m1 * (scale_e4m3 * tensor_scale),
// rounded to bf16 exactly as the plain version rounds it, and multiplied
// with x in f32.  A product of two bf16 values is exact in f32, so a
// kernel differs from the plain version only in the order of the f32 sum.
// The output is rounded once.
//
// Bound: at decode (M = 1..8 rows per group) bytes, the packed weight
// (0.5625 B/param); at prefill operations.  Two designs, picked by M:
//  * M <= 8 (decode): a GEMV.  Each warp owns two output columns (rows of
//    W^T) and walks K in steps of 512: every lane loads one 16-element block
//    of codes (8 bytes) and its scale per column, decodes it in registers and
//    multiplies it with x, which the block stages in shared memory (f32,
//    transposed and padded so that the 32 lanes read 32 banks).  A warp
//    shuffle reduces the lanes' partial sums in a fixed order.  With 16
//    columns per block even N = 1408 spreads over 88 blocks per group, and
//    every warp keeps its own weight loads in flight.
//  * M > 8 (prefill): a tiled GEMM on f32 FMAs.  A block owns a BM x BN
//    output tile and loops over K in BK steps; per step it reads the tile's
//    codes as 32-bit words (8 nibbles, one block scale each), decodes them
//    once into shared memory, stages x beside them, and every thread
//    accumulates a TM x TN micro-tile in registers.
// Tensor cores (mma.sync / wgmma) and pipelined loads are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// E2M1 nibble -> f32: sign = n>>3, exp = (n>>1)&3, man = n&1
__device__ __forceinline__ float nibble_to_f32(uint32_t n) {
  const float sign = (n & 8u) ? -1.0f : 1.0f;
  const uint32_t e = (n >> 1) & 3u;
  const float man = (float)(n & 1u);
  const float mag = e == 0 ? man * 0.5f
                           : (1.0f + 0.5f * man) * (float)(1u << (e - 1));
  return sign * mag;
}

__device__ __forceinline__ float e4m3_to_f32(uint8_t s) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)s, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool GROUPED, typename TX, typename TO, int BM, int BN, int BK,
          int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
              const uint8_t* __restrict__ scales,
              const float* __restrict__ tensor_scale, TO* __restrict__ out,
              int ts_stride, int m, int n, int k, int kp) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int WPR = BK / 8;  // 32-bit code words per weight row per step
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];

  if (GROUPED) {  // this block's group: move the operands to its slices
    const long long g = blockIdx.z;
    x += g * m * k;
    codes += g * n * (kp / 2);
    scales += g * n * (kp / 16);
    tensor_scale += g * ts_stride;
    out += g * m * n;
  }
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kh = kp / 2;        // code bytes per row
  const int kb = kp / 16;       // scales per row
  const float s_t = tensor_scale[0];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kp; k0 += BK) {
    // x tile -> xs[kk][mm]; zero outside [m) x [k) (the K pad included)
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int mm = idx / BK, kk = idx % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < m && gk < k) ? to_f32(x[(long long)gm * k + gk]) : 0.0f;
    }
    // weight tile -> ws[kk][nn], decoded and rounded to bf16
    for (int idx = tid; idx < BN * WPR; idx += NT) {
      const int r = idx / WPR, c = idx % WPR;
      const int gn = n0 + r, gk = k0 + 8 * c;
      uint32_t word = 0;
      float s = 0.0f;
      if (gn < n && gk < kp) {
        word = *reinterpret_cast<const uint32_t*>(
            codes + (long long)gn * kh + gk / 2);
        s = e4m3_to_f32(scales[(long long)gn * kb + gk / 16]) * s_t;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ws[8 * c + e][r] = round_bf16(nibble_to_f32((word >> (4 * e)) & 0xFu) * s);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn < n) from_f32(acc[i][j], out + (long long)gm * n + gn);
    }
  }
}

template <bool GROUPED, typename TX, typename TO, int BM, int BN, int BK,
          int TM, int TN>
void launch_tiled(const void* x, const void* codes, const void* scales,
                  const void* ts, void* out, int groups, int ts_stride, int m,
                  int n, int k, int kp, cudaStream_t s) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, groups);
  matmul_kernel<GROUPED, TX, TO, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(
          static_cast<const TX*>(x), static_cast<const uint8_t*>(codes),
          static_cast<const uint8_t*>(scales), static_cast<const float*>(ts),
          static_cast<TO*>(out), ts_stride, m, n, k, kp);
}


constexpr int kGemvWarps = 8;
constexpr int kGemvCols = 2;                 // output columns per warp
constexpr int kGemvStep = 32 * 16;           // K elements per warp step

// y[m, n] for m < M <= MAXM; x staged per K step as xs[m][j][lane], the
// element k = step + 16 * lane + j, padded to 33 lanes (conflict-free)
template <bool GROUPED, typename TX, typename TO, int MAXM>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
            const uint8_t* __restrict__ scales,
            const float* __restrict__ tensor_scale, TO* __restrict__ out,
            int ts_stride, int m, int n, int k, int kp) {
  __shared__ float xs[MAXM][16][33];
  if (GROUPED) {  // this block's group: move the operands to its slices
    const long long g = blockIdx.z;
    x += g * m * k;
    codes += g * n * (kp / 2);
    scales += g * n * (kp / 16);
    tensor_scale += g * ts_stride;
    out += g * m * n;
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = (blockIdx.x * kGemvWarps + warp) * kGemvCols;
  const int kh = kp / 2, kb = kp / 16;
  const float s_t = tensor_scale[0];

  float acc[kGemvCols][MAXM];
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
    for (int i = 0; i < MAXM; ++i) acc[c][i] = 0.0f;

  for (int k0 = 0; k0 < kp; k0 += kGemvStep) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < MAXM * kGemvStep; idx += kGemvWarps * 32) {
      const int mm = idx / kGemvStep, kk = idx % kGemvStep;
      const int gk = k0 + kk;
      xs[mm][kk % 16][kk / 16] =
          (mm < m && gk < k) ? to_f32(x[(long long)mm * k + gk]) : 0.0f;
    }
    __syncthreads();
    const int blk = (k0 >> 4) + lane;       // this lane's NVFP4 block
    if (blk >= kb) continue;
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const int gn = n0 + c;
      if (gn >= n) continue;
      const uint2 word = *reinterpret_cast<const uint2*>(
          codes + (long long)gn * kh + (long long)blk * 8);
      const float s = e4m3_to_f32(scales[(long long)gn * kb + blk]) * s_t;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t half = j < 8 ? word.x : word.y;
        const float w = round_bf16(nibble_to_f32((half >> (4 * (j % 8))) & 0xFu) * s);
#pragma unroll
        for (int i = 0; i < MAXM; ++i) acc[c][i] = fmaf(xs[i][j][lane], w, acc[c][i]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c][i] += __shfl_xor_sync(0xffffffffu, acc[c][i], off);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const int gn = n0 + c;
      if (gn >= n) continue;
#pragma unroll
      for (int i = 0; i < MAXM; ++i)
        if (i < m) from_f32(acc[c][i], out + (long long)i * n + gn);
    }
  }
}

template <bool GROUPED, typename TX, typename TO, int MAXM>
void launch_gemv(const void* x, const void* codes, const void* scales,
                 const void* ts, void* out, int groups, int ts_stride, int m,
                 int n, int k, int kp, cudaStream_t s) {
  const int cols = kGemvWarps * kGemvCols;
  dim3 grid((n + cols - 1) / cols, 1, groups);
  gemv_kernel<GROUPED, TX, TO, MAXM><<<grid, kGemvWarps * 32, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(scales), static_cast<const float*>(ts),
      static_cast<TO*>(out), ts_stride, m, n, k, kp);
}

template <bool GROUPED, typename TX, typename TO>
void dispatch(const void* x, const void* codes, const void* scales,
              const void* ts, void* out, int groups, int ts_stride, int m,
              int n, int k, int kp, cudaStream_t s) {
  if (m <= 1)        // decode: GEMV, weight-bytes bound
    launch_gemv<GROUPED, TX, TO, 1>(x, codes, scales, ts, out, groups, ts_stride, m, n, k, kp, s);
  else if (m <= 2)
    launch_gemv<GROUPED, TX, TO, 2>(x, codes, scales, ts, out, groups, ts_stride, m, n, k, kp, s);
  else if (m <= 4)
    launch_gemv<GROUPED, TX, TO, 4>(x, codes, scales, ts, out, groups, ts_stride, m, n, k, kp, s);
  else if (m <= 8)
    launch_gemv<GROUPED, TX, TO, 8>(x, codes, scales, ts, out, groups, ts_stride, m, n, k, kp, s);
  else               // prefill: 64 x 64 tiles, 4 x 4 per thread
    launch_tiled<GROUPED, TX, TO, 64, 64, 32, 4, 4>(x, codes, scales, ts, out,
                                                    groups, ts_stride, m, n,
                                                    k, kp, s);
}

// Both entry points: pick the x and output types, launch, and return
// cudaGetLastError() (a refused launch never runs).  GROUPED (K3) moves
// each block to its group's slices and names the kernels apart from K2's
// in a profile; the arithmetic is the same.
template <bool GROUPED>
int run_matmul(const void* x, int x_is_f32, const void* codes,
               const void* scales, const void* tensor_scale, int ts_stride,
               void* out, int out_is_f32, int groups, int m, int n, int k,
               int kp, void* stream) {
  if (groups == 0 || m == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const void* ts = tensor_scale;
  if (x_is_f32 && out_is_f32)
    dispatch<GROUPED, float, float>(x, codes, scales, ts, out, groups,
                                    ts_stride, m, n, k, kp, s);
  else if (x_is_f32)
    dispatch<GROUPED, float, bf16>(x, codes, scales, ts, out, groups,
                                   ts_stride, m, n, k, kp, s);
  else if (out_is_f32)
    dispatch<GROUPED, bf16, float>(x, codes, scales, ts, out, groups,
                                   ts_stride, m, n, k, kp, s);
  else
    dispatch<GROUPED, bf16, bf16>(x, codes, scales, ts, out, groups,
                                  ts_stride, m, n, k, kp, s);
  return (int)cudaGetLastError();
}

}  // namespace
