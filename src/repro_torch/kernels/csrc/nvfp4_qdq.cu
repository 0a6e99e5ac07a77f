// NVFP4 fake quantization (quantize + dequantize) blocked along the last dim,
// with the tensor amax taken in the same launch.
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
// output is bitwise equal to the plain version.
//
// The amax belongs to a segment: a contiguous run of seg_blocks 16-value
// blocks of the flattened x (the whole tensor, one leading-axis element, or
// one last-dim vector: the "tensor", "row" and "token" scopes).  It is the
// caller's (one f32 per segment, mode kExternal) or the kernel's own.  The
// kernel takes it as the max of |x| over the bits of |x|: for non-negative
// floats the integer order is the float order and NaN sorts above +inf, so
// the max propagates a NaN as torch.amax does, and the clamps below keep it
// (torch.clamp propagates NaN; fmaxf would drop it).
//
// Bound: bytes.  One read of x and one write of the output, a few flops per
// byte.  A thread owns one 16-value block in registers.  How the amax is
// reduced depends on the segment's size (the wrapper's plan picks the mode):
//
//   kLocal    a segment fits one block of 256 threads (up to 4096 values):
//             a block takes one or more whole segments; a warp-segmented
//             shuffle max and a shared-memory max per segment;
//   kCluster  a segment fits a thread-block cluster of up to 8 blocks (up to
//             32768 values: a decode row of 3584 or 18944): each block
//             reduces its part, the cluster exchanges the partial maxes
//             through distributed shared memory;
//   kTwoPass  larger segments (training's tensor scope, a 512-token row at
//             exact prefill): a cooperative persistent grid; every block
//             writes the partial max of each chunk it owns to the chunk's
//             own workspace slot (no atomics, so no memset), grid.sync(),
//             then takes an even share of the blocks, reduces the partials
//             of their segments and quantizes, re-reading x (from L2 where
//             it fits in 50 MB).
//
// In the first two modes each value is read once and written once.  A view
// of x that starts off a 16-byte boundary is loaded with narrower vectors;
// the output is always 16-byte aligned.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInvE2M1 = 1.0f / 6.0f;          // f32-rounded reciprocals
constexpr float kInvTensor = 1.0f / 2688.0f;

enum Mode { kExternal = 0, kLocal = 1, kCluster = 2, kTwoPass = 3 };

// max(v, lo) that keeps a NaN, as torch.clamp_min does
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float e4m3_round(float s) {
  s = s < 0.015625f ? 0.015625f : (s > 448.0f ? 448.0f : s);  // [2^-6, 448]
  __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(s, __NV_SATFINITE, __NV_E4M3);
  __half_raw h = __nv_cvt_fp8_to_halfraw(q, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ float e2m1_quantize(float y) {
  float a = fminf(fmaxf(fabsf(y), 0.0f), 6.0f);
  float r = a <= 2.0f ? rintf(a * 2.0f) * 0.5f
          : (a <= 4.0f ? rintf(a) : rintf(a * 0.5f) * 2.0f);
  // jnp.sign: -1, 1, or the signed zero itself (a NaN stays NaN)
  float sgn = y > 0.0f ? 1.0f : (y < 0.0f ? -1.0f : y);
  return sgn * r;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-value block as loaded: vectors of V (16, 8, 4 or 2 bytes: the
// largest the address allows).
template <typename T, typename V>
struct Raw {
  V r[kBlock * sizeof(T) / sizeof(V)];
};

template <typename T, typename V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  Raw<T, V> raw;
  const V* q = reinterpret_cast<const V*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(raw.r) / sizeof(V)); ++i) raw.r[i] = q[i];
  return raw;
}

// The block's values in f32; returns the max of the bits of |v|.
template <typename T, typename V>
__device__ __forceinline__ unsigned unpack(const Raw<T, V>& raw, float* v) {
  const T* e = reinterpret_cast<const T*>(raw.r);
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    v[i] = to_f32(e[i]);
    bits = max(bits, abs_bits(v[i]));
  }
  return bits;
}

template <typename T, typename V>
__device__ __forceinline__ unsigned load_block(const T* p, float* v) {
  return unpack<T, V>(load_raw<T, V>(p), v);
}

template <typename T>
__device__ __forceinline__ void store_block(T* p, const float* v) {
  constexpr int kN = kBlock * sizeof(T) / 16;
  uint4 raw[kN];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) e[i] = from_f32<T>(v[i]);
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < kN; ++i) q[i] = raw[i];
}

// QDQ of one block in registers, given its segment's amax and the bits of
// its own block amax.
__device__ __forceinline__ void qdq_block(float* v, unsigned block_bits,
                                          float amax) {
  const float s_t = clamp_min_nan(amax, 1e-30f) * kInvTensor;
  const float s_b = e4m3_round(__uint_as_float(block_bits) * kInvE2M1 / s_t);
  const float s = s_b * s_t;
  const float d = clamp_min_nan(s, 1e-30f);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) v[i] = e2m1_quantize(v[i] / d) * s;
}

// Max of ``bits`` over the lanes of a warp that share ``key`` (segments are
// contiguous runs of lanes; key < 0: no block), merged into slot[key] by the
// run's first lane.
__device__ __forceinline__ void segment_max(unsigned bits, int key,
                                            unsigned* slot) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned ob = __shfl_down_sync(0xffffffffu, bits, o);
    const int ok = __shfl_down_sync(0xffffffffu, key, o);
    if (lane + o < 32 && ok == key) bits = max(bits, ob);
  }
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  if (key >= 0 && (lane == 0 || prev != key)) atomicMax(&slot[key], bits);
}

// Max over the block, returned to every thread.
__device__ __forceinline__ unsigned block_max(unsigned bits, unsigned* red) {
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = bits;
  __syncthreads();
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = max(m, red[w]);
  __syncthreads();                     // red is reused by the next call
  return m;
}

// Modes kExternal, kLocal and kCluster: one pass, each value read once.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
qdq_one_pass(const T* __restrict__ x, const float* __restrict__ ext,
             T* __restrict__ out, long long n_blocks, long long seg_blocks,
             int mode) {
  __shared__ unsigned slot[kThreads];  // one max per segment of this block
  __shared__ unsigned cluster_max;
  const int tid = threadIdx.x;
  long long b = -1;                    // this thread's block
  int key = -1;                        // its segment within this block
  if (mode == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    const long long seg = blockIdx.x / cluster.num_blocks();
    const long long off = (long long)cluster.block_rank() * kThreads + tid;
    if (off < seg_blocks) {
      b = seg * seg_blocks + off;
      key = 0;
    }
  } else if (mode == kLocal) {
    const int per = kThreads / (int)seg_blocks;        // segments per block
    const long long first = (long long)blockIdx.x * per * seg_blocks + tid;
    if (tid < per * seg_blocks && first < n_blocks) {
      b = first;
      key = tid / (int)seg_blocks;
    }
  } else {
    const long long i = (long long)blockIdx.x * kThreads + tid;
    if (i < n_blocks) b = i;
  }
  float v[kBlock];
  unsigned bits = 0;
  if (b >= 0) bits = load_block<T, V>(x + b * kBlock, v);

  float amax;
  if (mode == kExternal) {
    if (b < 0) return;
    amax = ext[b / seg_blocks];
  } else {
    slot[tid] = 0;
    __syncthreads();
    segment_max(bits, key, slot);
    __syncthreads();
    if (mode == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();                  // every block's slot[0] is final
      if (tid < 32) {
        unsigned m = 0;
        for (unsigned r = tid; r < cluster.num_blocks(); r += 32)
          m = max(m, *cluster.map_shared_rank(&slot[0], r));
        m = __reduce_max_sync(0xffffffffu, m);
        if (tid == 0) cluster_max = m;
      }
      __syncthreads();
      cluster.sync();                  // no block leaves while read remotely
      amax = __uint_as_float(cluster_max);
    } else {
      amax = key >= 0 ? __uint_as_float(slot[key]) : 0.0f;
    }
    if (b < 0) return;
  }
  qdq_block(v, bits, amax);
  store_block<T>(out + b * kBlock, v);
}

// Mode kTwoPass.  Pass 1: work item w is chunk w % chunks (chunk_blocks
// blocks) of segment w / chunks; block i takes items i, i + grid, ... and
// writes each item's max to ws[w].  Pass 2: block i takes an even,
// contiguous share of all the blocks; for each segment its share touches it
// reduces that segment's item maxes, then quantizes.  A thread issues
// kPer loads (128 bytes) before it uses one.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads, 4)
qdq_two_pass(const T* __restrict__ x, T* __restrict__ out,
             unsigned* __restrict__ ws, long long n_blocks,
             long long seg_blocks, long long chunk_blocks, int chunks,
             long long n_items) {
  constexpr int kPer = 8 / (int)sizeof(T);
  constexpr int kStep = kThreads * kPer;
  __shared__ unsigned red[kWarps];
  const int tid = threadIdx.x;
  for (long long w = blockIdx.x; w < n_items; w += gridDim.x) {
    const long long seg = w / chunks;
    const long long b0 = seg * seg_blocks + (w % chunks) * chunk_blocks;
    const long long b1 = min(b0 + chunk_blocks, (seg + 1) * seg_blocks);
    unsigned bits = 0;
    for (long long base = b0 + tid; base < b1; base += kStep) {
      Raw<T, V> raw[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (base + j * kThreads < b1)
          raw[j] = load_raw<T, V>(x + (base + j * kThreads) * kBlock);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float v[kBlock];
        if (base + j * kThreads < b1) bits = max(bits, unpack<T, V>(raw[j], v));
      }
    }
    bits = block_max(bits, red);
    if (tid == 0) ws[w] = bits;
  }
  cg::this_grid().sync();
  const long long share = (n_blocks + gridDim.x - 1) / gridDim.x;
  const long long c1 = min((long long)(blockIdx.x + 1) * share, n_blocks);
  for (long long b = (long long)blockIdx.x * share; b < c1;) {
    const long long seg = b / seg_blocks;
    const long long end = min(c1, (seg + 1) * seg_blocks);
    unsigned bits = 0;
    for (int i = tid; i < chunks; i += kThreads)
      bits = max(bits, __ldcg(ws + seg * chunks + i));
    const float amax = __uint_as_float(block_max(bits, red));
    for (long long base = b + tid; base < end; base += kStep) {
      Raw<T, V> raw[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (base + j * kThreads < end)
          raw[j] = load_raw<T, V>(x + (base + j * kThreads) * kBlock);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (base + j * kThreads < end) {
          float v[kBlock];
          qdq_block(v, unpack<T, V>(raw[j], v), amax);
          store_block<T>(out + (base + j * kThreads) * kBlock, v);
        }
      }
    }
    b = end;
  }
}

template <typename T, typename V>
int coop_grid(long long n_items) {
  static int per_sm = -1, sms = 0;     // one device per process
  if (per_sm < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qdq_two_pass<T, V>, kThreads, 0);
  }
  const long long cap = (long long)per_sm * sms;
  return (int)(n_items < cap ? n_items : cap);
}

template <typename T, typename V>
int run(const void* xv, const void* amax, int mode, long long n_blocks,
        long long seg_blocks, long long chunk_blocks, void* ws,
        long long n_items, void* outv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const float* ext = static_cast<const float*>(amax);
  if (mode == kTwoPass) {
    const int grid = coop_grid<T, V>(n_items);
    int chunks = (int)((seg_blocks + chunk_blocks - 1) / chunk_blocks);
    unsigned* w = static_cast<unsigned*>(ws);
    void* args[] = {(void*)&x, (void*)&out, (void*)&w, (void*)&n_blocks,
                    (void*)&seg_blocks, (void*)&chunk_blocks, (void*)&chunks,
                    (void*)&n_items};
    return (int)cudaLaunchCooperativeKernel((const void*)qdq_two_pass<T, V>,
                                            dim3(grid), dim3(kThreads), args,
                                            0, s);
  }
  if (mode == kCluster) {
    const int c = (int)((seg_blocks + kThreads - 1) / kThreads);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_blocks / seg_blocks * c));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, qdq_one_pass<T, V>, x, ext, out,
                                   n_blocks, seg_blocks, mode);
  }
  long long grid;
  if (mode == kLocal) {
    const long long per = kThreads / seg_blocks;
    const long long n_seg = n_blocks / seg_blocks;
    grid = (n_seg + per - 1) / per;
  } else {
    grid = (n_blocks + kThreads - 1) / kThreads;
  }
  qdq_one_pass<T, V><<<(unsigned)grid, kThreads, 0, s>>>(
      x, ext, out, n_blocks, seg_blocks, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int run_aligned(const void* x, const void* amax, int mode, long long n_blocks,
                long long seg_blocks, long long chunk_blocks, void* ws,
                long long n_items, void* out, cudaStream_t s) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (p % 16 == 0)
    return run<T, uint4>(x, amax, mode, n_blocks, seg_blocks, chunk_blocks,
                         ws, n_items, out, s);
  if (p % 8 == 0)
    return run<T, uint2>(x, amax, mode, n_blocks, seg_blocks, chunk_blocks,
                         ws, n_items, out, s);
  if (p % 4 == 0)
    return run<T, uint32_t>(x, amax, mode, n_blocks, seg_blocks, chunk_blocks,
                            ws, n_items, out, s);
  if constexpr (sizeof(T) == 2)
    return run<T, uint16_t>(x, amax, mode, n_blocks, seg_blocks, chunk_blocks,
                            ws, n_items, out, s);
  return (int)cudaErrorMisalignedAddress;
}

}  // namespace

// x [n_blocks * 16] (bf16 or f32); amax: one f32 per segment (mode
// kExternal) or null; mode and sizes from the wrapper's plan; ws: n_items
// 32-bit slots (mode kTwoPass) or null; out: 16-byte aligned.
extern "C" int nvfp4_qdq(const void* x, int x_is_f32, const void* amax,
                         int mode, long long n_blocks, long long seg_blocks,
                         long long chunk_blocks, void* ws, long long n_items,
                         void* out, void* stream) {
  if (n_blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    return run_aligned<float>(x, amax, mode, n_blocks, seg_blocks,
                              chunk_blocks, ws, n_items, out, s);
  return run_aligned<__nv_bfloat16>(x, amax, mode, n_blocks, seg_blocks,
                                    chunk_blocks, ws, n_items, out, s);
}
