// Streaming token-level KL(p_t || p_s) over the vocabulary, forward (K5)
// and backward (K6).
//
// Replaces the Pallas TPU kernels of repro/kernels/kl_loss.py: the forward
// _kl_fwd_kernel (called from _kl_fwd) and the backward _kl_bwd_kernel
// (called from _kl_vjp_bwd).
//
// Forward, per token row of teacher logits t and student logits s [T, V]:
//
//   z_t = logsumexp(t),  z_s = logsumexp(s)
//   kl  = sum_v e^(t_v - m_t) (t_v - s_v) / l_t - z_t + z_s
//
// where m_t is the row max and l_t = sum_v e^(t_v - m_t).  On the TPU a
// sequential vocabulary grid axis carries (m, l, acc) in scratch from step
// to step; Hopper blocks run in no order, so here one thread block owns one
// row.  Its threads stream the row with 16-byte loads of t and s, each
// keeping its own online state (m_t, l_t, acc, m_s, l_s); the block then
// merges the states with warp shuffles and shared memory:
//
//   m = max(m_a, m_b),  l = l_a e^(m_a - m) + l_b e^(m_b - m),
//   acc = acc_a e^(m_a - m) + acc_b e^(m_b - m).
//
// A row whose start is not 16-byte aligned (V not a multiple of the vector
// width) is read as a scalar head, aligned vectors, and a scalar tail; the
// TPU version pads the vocabulary with -1e30 instead.
//
// Backward: ds = (e^(s - z_s) - e^(t - z_t)) * g_tok[row], written in s's
// dtype, one elementwise pass with the row's z_t, z_s and g_tok in
// registers.
//
// Bound: bytes.  The forward reads 2 T V elements and writes 3 T floats;
// the backward reads 2 T V and writes T V.  Both touch every logit once
// and keep everything else in registers.  expf is the accurate one (no
// --use_fast_math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInit = -1e30f;   // the TPU kernel's initial running max

template <typename T>
struct Vec;

template <>
struct Vec<float> {  // four floats per 16-byte load
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};

template <>
struct Vec<__nv_bfloat16> {  // eight bf16 per 16-byte load
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(b[j]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint4*>(p) = q;
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// How a row splits into a scalar head (up to the first 16-byte boundary),
// whole 16-byte vectors, and a scalar tail.
template <typename T>
struct RowSplit {
  int head, n_vec, tail_start;
  __device__ RowSplit(const T* row, int v) {
    constexpr int kN = Vec<T>::kN;
    const int mis = (int)((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
    head = mis ? min(kN - mis, v) : 0;
    n_vec = (v - head) / kN;
    tail_start = head + n_vec * kN;
  }
};

struct State {
  float mt, lt, acc, ms, ls;
};

__device__ __forceinline__ State empty_state() {
  return {kNegInit, 0.0f, 0.0f, kNegInit, 0.0f};
}

// Fold n values of t and s into the running state: one rescale per chunk.
template <int N>
__device__ __forceinline__ void fold(State& st, const float* t, const float* s) {
  float mt = st.mt, ms = st.ms;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mt = fmaxf(mt, t[j]);
    ms = fmaxf(ms, s[j]);
  }
  const float ct = expf(st.mt - mt), cs = expf(st.ms - ms);
  float lt = 0.0f, acc = 0.0f, ls = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float et = expf(t[j] - mt);
    lt += et;
    acc += et * (t[j] - s[j]);
    ls += expf(s[j] - ms);
  }
  st.lt = st.lt * ct + lt;
  st.acc = st.acc * ct + acc;
  st.ls = st.ls * cs + ls;
  st.mt = mt;
  st.ms = ms;
}

__device__ __forceinline__ State merge(const State& a, const State& b) {
  const float mt = fmaxf(a.mt, b.mt), ms = fmaxf(a.ms, b.ms);
  const float ca = expf(a.mt - mt), cb = expf(b.mt - mt);
  const float da = expf(a.ms - ms), db = expf(b.ms - ms);
  return {mt, a.lt * ca + b.lt * cb, a.acc * ca + b.acc * cb,
          ms, a.ls * da + b.ls * db};
}

__device__ __forceinline__ State shfl_xor(const State& a, int lane_mask) {
  return {__shfl_xor_sync(0xffffffffu, a.mt, lane_mask),
          __shfl_xor_sync(0xffffffffu, a.lt, lane_mask),
          __shfl_xor_sync(0xffffffffu, a.acc, lane_mask),
          __shfl_xor_sync(0xffffffffu, a.ms, lane_mask),
          __shfl_xor_sync(0xffffffffu, a.ls, lane_mask)};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kl_fwd_kernel(const T* __restrict__ t, const T* __restrict__ s,
              float* __restrict__ kl, float* __restrict__ zt,
              float* __restrict__ zs, int v) {
  constexpr int kN = Vec<T>::kN;
  const long long row = blockIdx.x;
  const T* tr = t + row * v;
  const T* sr = s + row * v;
  const RowSplit<T> sp(tr, v);
  State st = empty_state();

  // scalar head and tail: at most kN - 1 elements each
  for (int i = threadIdx.x; i < sp.head; i += kThreads) {
    const float a = Vec<T>::get(tr + i), b = Vec<T>::get(sr + i);
    fold<1>(st, &a, &b);
  }
  for (int i = sp.tail_start + threadIdx.x; i < v; i += kThreads) {
    const float a = Vec<T>::get(tr + i), b = Vec<T>::get(sr + i);
    fold<1>(st, &a, &b);
  }
  // aligned vectors, two per step so that four loads are in flight
  const T* tv = tr + sp.head;
  const T* sv = sr + sp.head;
  int i = threadIdx.x;
  for (; i + kThreads < sp.n_vec; i += 2 * kThreads) {
    float a[2 * kN], b[2 * kN];
    Vec<T>::load(tv + (long long)i * kN, a);
    Vec<T>::load(tv + (long long)(i + kThreads) * kN, a + kN);
    Vec<T>::load(sv + (long long)i * kN, b);
    Vec<T>::load(sv + (long long)(i + kThreads) * kN, b + kN);
    fold<2 * kN>(st, a, b);
  }
  if (i < sp.n_vec) {
    float a[kN], b[kN];
    Vec<T>::load(tv + (long long)i * kN, a);
    Vec<T>::load(sv + (long long)i * kN, b);
    fold<kN>(st, a, b);
  }

  // merge: within each warp, then across the warps through shared memory
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_xor(st, off));
  __shared__ State part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < kWarps ? part[lane] : empty_state();
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      st = merge(st, shfl_xor(st, off));
    if (lane == 0) {
      const float z_t = st.mt + logf(st.lt);
      const float z_s = st.ms + logf(st.ls);
      kl[row] = st.acc / st.lt - z_t + z_s;
      zt[row] = z_t;
      zs[row] = z_s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kl_bwd_kernel(const T* __restrict__ t, const T* __restrict__ s,
              const float* __restrict__ zt, const float* __restrict__ zs,
              const float* __restrict__ g, T* __restrict__ ds, int v) {
  constexpr int kN = Vec<T>::kN;
  const long long row = blockIdx.x;
  const float z_t = zt[row], z_s = zs[row], gr = g[row];
  const T* tr = t + row * v;
  const T* sr = s + row * v;
  T* dr = ds + row * v;            // same dtype and row offsets as s
  const RowSplit<T> sp(sr, v);

  for (int i = threadIdx.x; i < sp.head; i += kThreads) {
    const float d = expf(Vec<T>::get(sr + i) - z_s) - expf(Vec<T>::get(tr + i) - z_t);
    Vec<T>::put(dr + i, d * gr);
  }
  for (int i = sp.tail_start + threadIdx.x; i < v; i += kThreads) {
    const float d = expf(Vec<T>::get(sr + i) - z_s) - expf(Vec<T>::get(tr + i) - z_t);
    Vec<T>::put(dr + i, d * gr);
  }
  const T* tv = tr + sp.head;
  const T* sv = sr + sp.head;
  T* dv = dr + sp.head;
  for (int i = threadIdx.x; i < sp.n_vec; i += kThreads) {
    float a[kN], b[kN];
    Vec<T>::load(tv + (long long)i * kN, a);
    Vec<T>::load(sv + (long long)i * kN, b);
#pragma unroll
    for (int j = 0; j < kN; ++j) b[j] = (expf(b[j] - z_s) - expf(a[j] - z_t)) * gr;
    Vec<T>::store(dv + (long long)i * kN, b);
  }
}

}  // namespace

extern "C" int kl_fwd(const void* t, const void* s, int is_f32, void* kl,
                      void* zt, void* zs, int rows, int v, void* stream) {
  if (rows == 0 || v == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    kl_fwd_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(t), static_cast<const float*>(s),
        static_cast<float*>(kl), static_cast<float*>(zt),
        static_cast<float*>(zs), v);
  } else {
    kl_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t),
        static_cast<const __nv_bfloat16*>(s), static_cast<float*>(kl),
        static_cast<float*>(zt), static_cast<float*>(zs), v);
  }
  return (int)cudaGetLastError();
}

extern "C" int kl_bwd(const void* t, const void* s, int is_f32,
                      const void* zt, const void* zs, const void* g, void* ds,
                      int rows, int v, void* stream) {
  if (rows == 0 || v == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    kl_bwd_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(t), static_cast<const float*>(s),
        static_cast<const float*>(zt), static_cast<const float*>(zs),
        static_cast<const float*>(g), static_cast<float*>(ds), v);
  } else {
    kl_bwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t),
        static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(zt),
        static_cast<const float*>(zs), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(ds), v);
  }
  return (int)cudaGetLastError();
}
