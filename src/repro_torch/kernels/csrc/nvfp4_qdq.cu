// NVFP4 fake quantization (quantize + dequantize) blocked along the last dim.
//
// Replaces the Pallas TPU kernel repro/kernels/nvfp4_qdq.py::nvfp4_qdq
// (_qdq_kernel).  It computes repro/core/nvfp4.py::qdq as the reference's
// jitted serving forward applies it to every quantized GEMM input, where XLA
// turns the two divisions by constants into multiplications by their f32
// reciprocals:
//
//   s_tensor = max(amax, 1e-30) * f32(1 / (448 * 6))
//   s_block  = e4m3(clip(block_amax * f32(1 / 6) / s_tensor, 2^-6, 448))
//   y        = x / max(s_block * s_tensor, 1e-30)
//   out      = sign(y) * e2m1_round(clip(|y|, 0, 6)) * (s_block * s_tensor)
//
// in that order, with IEEE division and round-half-to-even (rintf), so the
// output is bitwise equal to the plain version.  The amax is a device
// pointer: stride 0 reads one tensor amax, stride 1 one amax per row (the
// "row" and "token" activation scopes).
//
// Bound: bytes.  It reads x once and writes it once, a few flops per byte.
// Design: one thread owns one 16-element block, loads it as 16-byte vectors,
// reduces its amax in registers and writes its 16 outputs as 16-byte
// vectors: no shared memory, no synchronisation, one pass over memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = 256;
constexpr float kInvE2M1 = 1.0f / 6.0f;          // f32-rounded reciprocals
constexpr float kInvTensor = 1.0f / 2688.0f;

__device__ __forceinline__ float e4m3_round(float s) {
  s = fminf(fmaxf(s, 0.015625f), 448.0f);  // clip to [2^-6, 448]
  __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(s, __NV_SATFINITE, __NV_E4M3);
  __half_raw h = __nv_cvt_fp8_to_halfraw(q, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ float e2m1_quantize(float y) {
  float a = fminf(fmaxf(fabsf(y), 0.0f), 6.0f);
  float r = a <= 2.0f ? rintf(a * 2.0f) * 0.5f
          : (a <= 4.0f ? rintf(a) : rintf(a * 0.5f) * 2.0f);
  // jnp.sign: -1, 1, or the signed zero itself
  float sgn = y > 0.0f ? 1.0f : (y < 0.0f ? -1.0f : y);
  return sgn * r;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {  // 16 floats = four 16-byte vectors
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 t = q[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {  // 16 bf16 = two 16-byte vectors
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 t = q[i];
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[8 * i + j] = __bfloat162float(b[j]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 t;
      __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = __float2bfloat16_rn(v[8 * i + j]);
      q[i] = t;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
qdq_kernel(const T* __restrict__ x, const float* __restrict__ amax,
           int amax_stride, T* __restrict__ out, int rows, int k) {
  const int blocks_per_row = k / kBlock;
  const long long n_blocks = (long long)rows * blocks_per_row;
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const int row = (int)(b / blocks_per_row);

  float v[kBlock];
  Vec<T>::load(x + b * kBlock, v);
  float bmax = 0.0f;
#pragma unroll
  for (int i = 0; i < kBlock; ++i) bmax = fmaxf(bmax, fabsf(v[i]));

  const float s_t = fmaxf(amax[(long long)row * amax_stride], 1e-30f) * kInvTensor;
  const float s_b = e4m3_round(bmax * kInvE2M1 / s_t);
  const float s = s_b * s_t;
  const float d = fmaxf(s, 1e-30f);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) v[i] = e2m1_quantize(v[i] / d) * s;
  Vec<T>::store(out + b * kBlock, v);
}

}  // namespace

extern "C" int nvfp4_qdq(const void* x, int x_is_f32, const void* amax,
                         int amax_stride, void* out, int rows, int k,
                         void* stream) {
  const long long n_blocks = (long long)rows * (k / kBlock);
  if (n_blocks == 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32) {
    qdq_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(amax),
        amax_stride, static_cast<float*>(out), rows, k);
  } else {
    qdq_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(amax),
        amax_stride, static_cast<__nv_bfloat16*>(out), rows, k);
  }
  return (int)cudaGetLastError();
}
