// Paged attention for the serving engine: page-table gather, FP8-KV
// dequantization and grouped-query attention in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention (body _attend_kernel).  For q [B, S, H, hd] bf16 against
// the pool pages k, v [n_blocks, bs, Hkv, hd] (bf16, or e4m3 with f32 scales
// [n_blocks, bs, Hkv]) through block_tables [B, MB] and the per-query valid
// key counts pos ([B] or [B, S], int32 or int64), each query row of head h
// (KV head h / n_rep) gets, in the oracle's (models/attention.py::
// paged_attend) rounding points:
//
//   s_j = (q . k_j) * scale                    f32, scale = f32(1/sqrt(hd))
//   key j valid iff j < pos and (window == 0 or j >= pos - window)
//   m = max_j s_j,  l = sum_j exp(s_j - m)     over the valid keys
//   p_j = bf16(exp(s_j - m) / l)
//   out = bf16(sum_j p_j v_j)                  f32 accumulation
//
// with FP8 pages dequantized as bf16(f32(e4m3) * scale) before use.
//
// The TPU kernel walks the pages of one (request, KV head) in order and
// runs the softmax once over the whole f32 score strip on its last grid
// step.  Hopper has no sequential grid axis, and one (request, KV head) is
// too little work for one SM at decode (8 x 4 of them for acereason-7b on
// 132 SMs).  So the keys are split over a thread-block cluster:
//
//   grid (n_split, B * Hkv, row blocks), cluster (n_split, 1, 1).  A
//   cluster owns one (request, KV head, block of up to 16 query rows; row
//   g = rep * S + i holds query i of head kvh * n_rep + rep).  Each row's
//   own keys [j_lo, j_hi), from its window's start to its pos, are cut at
//   multiples of 16 into n_split contiguous parts, part r to block r; a
//   block stages the union of its rows' parts, and a row whose part is
//   empty gets m = -inf, l = 0 and a zero partial from that block.
//
// A row's parts, and so the order of every sum it takes, depend only on
// its own pos: a query's output is bitwise the one a one-query call at the
// same pos gives, whatever other queries share its cluster (the
// speculative verify's k + 1 queries against the plain decode's one).
// For that, the sum of exp is kept per thread (keys j = lane mod 16, in
// key order) across the chunks of a long part and reduced once, and the
// p V tiles start at multiples of 16: tiles outside a row's part add its
// exact zeros.
//
// and the softmax is taken in three exchanges through distributed shared
// memory, with no rescaling:
//
//   1. each block forms its scores and its row maxes; the cluster takes the
//      max (exact in any order);
//   2. each block sums exp(s - m) with the global m; the cluster adds the
//      block sums in split order;
//   3. each block forms p = bf16(exp(s - m) / l) and its p V partial; the
//      partials are summed in split order, each block summing a share of
//      the output elements, and written out.
//
// So the kernel keeps every rounding point of the oracle and differs from
// its plain version only in the order of f32 sums (the dot products, the
// sum of exp, p V).
//
// A block keeps its score strip (16 rows x its keys, f32) in shared memory
// across the exchanges and stages its K and V rows once, into one buffer:
// K, then V over it once the scores are formed (cp.async, bf16 as stored;
// FP8 rows dequantized to bf16 once per element on the way), so V lands
// while the first two exchanges run.  Where a block's part outgrows its chunk of kc keys (long
// contexts), it loops over chunks and recomputes the scores from K in each
// exchange: correct, not fast.  It loads the request's table row once, with
// the positions and q (one round trip before the first page), and reads
// only the keys of its part: pages past every query's pos are never read.
//
// Each exchange pushes: a block writes its values into a slot of every
// owner's shared memory (remote stores, not waited on), then one cluster
// barrier, then each block combines its slots locally in split order.
//
// q K^T and p V run on the tensor cores (mma.sync m16n8k16, bf16 inputs,
// f32 accumulation): q is bf16, K bf16 after the FP8 dequant, p bf16 after
// its rounding, exactly the oracle's inputs.
//
// Bound: bytes at decode (the valid K and V rows, 2 KB per token and layer
// for acereason-7b).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // query rows per cluster (MMA M)
constexpr int kMaxSplit = 8;            // blocks per cluster (portable)
constexpr int kMaxNT = 4;               // p V n-tiles per warp: hd <= 256
constexpr int kMaxSmem = 232448;        // 227 KB per block on Hopper

struct Args {
  const bf16* q;            // [B, S, H, hd], strides q_sb, q_ss, q_sh
  long long q_sb, q_ss, q_sh;
  const void* k;            // [n_blocks, bs, Hkv, hd] bf16 or e4m3
  const void* v;
  const float* k_scale;     // [n_blocks, bs, Hkv] (FP8 pages only)
  const float* v_scale;
  const int* bt;            // [B, MB], row stride bt_sb
  long long bt_sb;
  const void* pos;          // [B] or [B, S] int32 / int64
  long long pos_sb, pos_ss;
  int pos_i64;
  bf16* out;                // [B, S, H, hd] contiguous
  int s, h, hkv, hd, bs, mb, window, kc, q_vec;
  float scale;
};

__device__ __forceinline__ float e4m3_to_f32(uint8_t x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x),
                                         __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int load_pos(const Args& a, int b, int i) {
  const long long at = b * a.pos_sb + i * a.pos_ss;
  return a.pos_i64 ? (int)static_cast<const long long*>(a.pos)[at]
                   : static_cast<const int*>(a.pos)[at];
}

// barrier.cluster in two halves: a relaxed arrive (orders no memory) early,
// the wait just before the first write into another block's shared memory,
// which must not come before every block of the cluster has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <bool kFp8>
__global__ void __launch_bounds__(kThreads, 4)   // 4 blocks an SM at decode
paged_attention_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y / a.hkv, kvh = blockIdx.y % a.hkv;
  const int n_rep = a.h / a.hkv, hd = a.hd, kc = a.kc;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, n_rep * a.s - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;   // MMA fragment coordinates
  const int ldq = hd + 8;                 // bf16 row stride of qs and kv
  const int ldp = kc + 8;                 // bf16 row stride of ps

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);          // [16, ldq]
  bf16* kv = qs + kRows * ldq;                       // [kc, ldq] K, then V
  bf16* ps = kv + kc * ldq;                          // [16, ldp] p
  float* sc = reinterpret_cast<float*>(ps + kRows * ldp);  // [16, kc]
  float* o_all = sc + kRows * kc;        // [16 hd + 8] partials, by sender
  float* m_all = o_all + kRows * hd + kMaxSplit;     // [8, 16] by sender
  float* l_all = m_all + kMaxSplit * kRows;          // [8, 16] by sender
  float* m_loc = l_all + kMaxSplit * kRows;          // [16] this block's
  float* l_loc = m_loc + kRows;
  float* m_s = l_loc + kRows;                        // [16] the cluster's
  float* l_s = m_s + kRows;
  int* rpos = reinterpret_cast<int*>(l_s + kRows);   // [16] valid-key counts
  int* plo_s = rpos + kRows;                         // [16] rows' parts
  int* phi_s = plo_s + kRows;
  int* tbl = phi_s + kRows;                          // [MB] the table row

  // positions, the table row and q in one round trip
  if (tid < kRows) {
    rpos[tid] = tid < rows ? load_pos(a, b, (r0 + tid) % a.s) : 0;
    m_loc[tid] = -INFINITY;
    l_loc[tid] = 0.0f;
  }
  for (int i = tid; i < a.mb; i += kThreads) tbl[i] = a.bt[b * a.bt_sb + i];
  if (a.q_vec) {                          // 16-byte rows of q
    const int pieces = hd / 8;
    for (int e = tid; e < kRows * pieces; e += kThreads) {
      const int r = e / pieces, part = e % pieces;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows) {
        const int gr = r0 + r;
        const int head = kvh * n_rep + gr / a.s;
        val = *reinterpret_cast<const uint4*>(
            a.q + b * a.q_sb + (gr % a.s) * a.q_ss + head * a.q_sh + part * 8);
      }
      *reinterpret_cast<uint4*>(qs + r * ldq + part * 8) = val;
    }
  } else {
    for (int e = tid; e < kRows * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      bf16 val = __float2bfloat16_rn(0.0f);
      if (r < rows) {
        const int gr = r0 + r;
        const int head = kvh * n_rep + gr / a.s;
        val = a.q[b * a.q_sb + (gr % a.s) * a.q_ss + head * a.q_sh + d];
      }
      qs[r * ldq + d] = val;
    }
  }
  __syncthreads();

  // each row's part of its own keys: [plo, phi) for this block
  if (tid < kRows) {
    int lo = 0, hi = 0;
    if (tid < rows) {
      const int p = rpos[tid];
      const int j_lo = a.window ? max(p - a.window, 0) : 0;
      const int j_hi = min(p, a.mb * a.bs);
      const int base = j_lo - j_lo % 16;
      const int span = max(j_hi - base, 0);
      const int cs = ((span + n_split - 1) / n_split + 15) / 16 * 16;
      lo = max(j_lo, base + rank * cs);
      hi = min(j_hi, base + (rank + 1) * cs);
    }
    plo_s[tid] = lo;
    phi_s[tid] = max(hi, lo);
  }
  __syncthreads();
  // the block stages the union of its rows' parts, from a multiple of 16
  int ulo = INT_MAX, uhi = 0;
  for (int r = 0; r < rows; ++r)
    if (phi_s[r] > plo_s[r]) {
      ulo = min(ulo, plo_s[r]);
      uhi = max(uhi, phi_s[r]);
    }
  const int t0 = uhi > 0 ? ulo - ulo % 16 : 0;     // first key of its tiles
  const int chunks = uhi > 0 ? (uhi - t0 + kc - 1) / kc : 0;
  const bool resident = chunks == 1;

  // stage keys [c0, c0 + kc) of one KV head into dst (bf16 rows); keys
  // outside the union of the rows' parts are zeros
  auto stage = [&](const void* pages, const float* scales, bf16* dst, int c0) {
    const int pieces = hd / 8;
    for (int e = tid; e < kc * pieces; e += kThreads) {
      const int j = e / pieces, part = e % pieces;
      const int key = c0 + j;
      bf16* d = dst + j * ldq + part * 8;
      if (key < ulo || key >= uhi) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const int page = tbl[key / a.bs];
      const long long row = ((long long)page * a.bs + key % a.bs) * a.hkv + kvh;
      if (kFp8) {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            static_cast<const uint8_t*>(pages) + row * hd + part * 8);
        const uint8_t* e8 = reinterpret_cast<const uint8_t*>(&raw);
        const float s = scales[row];
        uint4 o;
        bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ob[i] = __float2bfloat16_rn(e4m3_to_f32(e8[i]) * s);
        *reinterpret_cast<uint4*>(d) = o;
      } else {
        cp_async16(d, static_cast<const bf16*>(pages) + row * hd + part * 8);
      }
    }
    cp_async_commit();
  };

  // scaled, masked scores of the 16 rows against the staged keys
  auto scores = [&](int c0) {
    for (int nt = warp; nt < kc / 8; nt += kWarps) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const bf16* q0 = qs + g * ldq + 2 * c;
      const bf16* q1 = q0 + 8 * ldq;
      const bf16* kr = kv + (nt * 8 + g) * ldq + 2 * c;
      for (int kk = 0; kk < hd; kk += 16)
        mma16816(d, ld32(q0 + kk), ld32(q1 + kk), ld32(q0 + kk + 8),
                 ld32(q1 + kk + 8), ld32(kr + kk), ld32(kr + kk + 8));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i >= 2 ? 8 : 0), col = nt * 8 + 2 * c + (i & 1);
        const int key = c0 + col;
        const bool ok = key >= plo_s[r] && key < phi_s[r];
        sc[r * kc + col] = ok ? d[i] * a.scale : -INFINITY;
      }
    }
  };

  // 16 threads a row: r = tid / 16
  const int rr = tid / 16, l16 = tid % 16;
  auto row_max = [&]() {
    float m = -INFINITY;
    for (int j = l16; j < kc; j += 16) m = fmaxf(m, sc[rr * kc + j]);
#pragma unroll
    for (int o = 8; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (l16 == 0) m_loc[rr] = fmaxf(m_loc[rr], m);
  };
  // the sum of exp: a running sum per thread (its keys j = l16 mod 16 in
  // key order, whatever the chunks), reduced across the 16 once
  float lsum = 0.0f;
  auto row_sum = [&]() {
    const float m = m_s[rr];
    for (int j = l16; j < kc; j += 16) {
      const float s = sc[rr * kc + j];
      if (s != -INFINITY) lsum += expf(s - m);
    }
  };
  auto row_sum_done = [&]() {
    float sum = lsum;
#pragma unroll
    for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (l16 == 0) l_loc[rr] = sum;
  };
  auto probs = [&]() {
    const float m = m_s[rr], l = l_s[rr];
    for (int j = l16; j < kc; j += 16) {
      const float s = sc[rr * kc + j];
      ps[rr * ldp + j] =
          __float2bfloat16_rn(s != -INFINITY ? expf(s - m) / l : 0.0f);
    }
  };
  float acc[kMaxNT][4];
#pragma unroll
  for (int t = 0; t < kMaxNT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.0f;
  auto pv = [&]() {
    for (int k0 = 0; k0 < kc; k0 += 16) {
      const bf16* p0 = ps + g * ldp + k0 + 2 * c;
      const bf16* p1 = p0 + 8 * ldp;
      const uint32_t a0 = ld32(p0), a1 = ld32(p1), a2 = ld32(p0 + 8),
                     a3 = ld32(p1 + 8);
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) {
        const int nt = warp + t * kWarps;
        if (nt * 8 < hd) {
          const bf16* v0 = kv + (k0 + 2 * c) * ldq + nt * 8 + g;
          mma16816(acc[t], a0, a1, a2, a3, pack2(v0[0], v0[ldq]),
                   pack2(v0[8 * ldq], v0[9 * ldq]));
        }
      }
    }
  };
  // send this block's 16 per-row values to every block's slot ``rank``
  auto broadcast = [&](const float* mine, float* all) {
    if (tid < kRows * n_split)
      cluster.map_shared_rank(all, tid / kRows)[rank * kRows + tid % kRows] =
          mine[tid % kRows];
  };

  // exchange 1: the row max
  if (resident) {
    stage(a.k, a.k_scale, kv, t0);
    cp_async_wait<0>();
    __syncthreads();
    scores(t0);
    __syncthreads();
    stage(a.v, a.v_scale, kv, t0);      // lands behind the exchanges
    row_max();
  } else {
    for (int ci = 0; ci < chunks; ++ci) {
      stage(a.k, a.k_scale, kv, t0 + ci * kc);
      cp_async_wait<0>();
      __syncthreads();
      scores(t0 + ci * kc);
      __syncthreads();
      row_max();
      __syncthreads();
    }
  }
  __syncthreads();
  cluster_wait();                       // every block has started
  broadcast(m_loc, m_all);
  cluster.sync();
  if (tid < kRows) {
    float m = -INFINITY;
    for (int rk = 0; rk < n_split; ++rk) m = fmaxf(m, m_all[rk * kRows + tid]);
    m_s[tid] = m;
  }
  __syncthreads();

  // exchange 2: the sum of exp, added in split order
  if (resident) {
    row_sum();
  } else {
    for (int ci = 0; ci < chunks; ++ci) {
      stage(a.k, a.k_scale, kv, t0 + ci * kc);
      cp_async_wait<0>();
      __syncthreads();
      scores(t0 + ci * kc);
      __syncthreads();
      row_sum();
      __syncthreads();
    }
  }
  row_sum_done();
  __syncthreads();
  broadcast(l_loc, l_all);
  cluster.sync();
  if (tid < kRows) {
    float l = 0.0f;
    for (int rk = 0; rk < n_split; ++rk) l += l_all[rk * kRows + tid];
    l_s[tid] = l;
  }
  __syncthreads();

  // exchange 3: p, the p V partials; block ``rank`` owns the output
  // elements [rank * share, (rank + 1) * share) and adds what every block
  // sends it in split order
  if (resident) {
    probs();
    cp_async_wait<0>();
    __syncthreads();
    pv();
  } else {
    for (int ci = 0; ci < chunks; ++ci) {
      stage(a.k, a.k_scale, kv, t0 + ci * kc);
      cp_async_wait<0>();
      __syncthreads();
      scores(t0 + ci * kc);
      __syncthreads();
      stage(a.v, a.v_scale, kv, t0 + ci * kc);
      probs();
      cp_async_wait<0>();
      __syncthreads();
      pv();
      __syncthreads();
    }
  }
  const int total = rows * hd;
  const int share = (total + n_split - 1) / n_split;
#pragma unroll
  for (int t = 0; t < kMaxNT; ++t) {
    const int nt = warp + t * kWarps;
    if (nt * 8 < hd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i >= 2 ? 8 : 0);
        if (r < rows) {
          const int e = r * hd + nt * 8 + 2 * c + (i & 1);
          const int owner = e / share;
          cluster.map_shared_rank(o_all, owner)[rank * share + e - owner * share] =
              acc[t][i];
        }
      }
    }
  }
  cluster.sync();
  const int e_end = min(total, (rank + 1) * share);
  for (int e = rank * share + tid; e < e_end; e += kThreads) {
    const int off = e - rank * share;
    float o = 0.0f;
    for (int rk = 0; rk < n_split; ++rk) o += o_all[rk * share + off];
    const int gr = r0 + e / hd, d = e % hd;
    const int head = kvh * n_rep + gr / a.s;
    a.out[(((long long)b * a.s + gr % a.s) * a.h + head) * hd + d] =
        __float2bfloat16_rn(o);
  }
}

size_t smem_bytes(int hd, int kc, int mb) {
  const size_t ldq = hd + 8;
  return 2 * (kRows * ldq + (size_t)kc * ldq + kRows * (size_t)(kc + 8)) +
         4 * (kRows * (size_t)kc + kRows * (size_t)hd + kMaxSplit +
              2 * kMaxSplit * kRows + 4 * kRows) +
         4 * (3 * kRows + (size_t)mb);
}

template <bool kFp8>
int launch(const Args& a, int b, int n_split, cudaStream_t st) {
  static size_t smem_set = 0;           // the attribute, once per size
  const size_t smem = smem_bytes(a.hd, a.kc, a.mb);
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<kFp8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int rows = (a.h / a.hkv) * a.s;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, b * a.hkv, (rows + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_attention_kernel<kFp8>, a);
}

}  // namespace

// The plan (n_split, kc) comes from kernels/paged_attention.py::split_plan;
// q_vec: q's rows start on 16-byte boundaries.  Returns
// cudaErrorInvalidValue for shapes the kernel does not take (hd not a multiple of 16 or above 256, a chunk that does not fit).
extern "C" int paged_attention(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, const void* v, const void* k_scale, const void* v_scale,
    int fp8, const void* bt, long long bt_sb, const void* pos,
    long long pos_sb, long long pos_ss, int pos_i64, void* out, int b, int s,
    int h, int hkv, int hd, int bs, int mb, int window, int n_split, int kc,
    int q_vec, float scale, void* stream) {
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  if (hd % 16 || hd > 8 * kWarps * kMaxNT || kc % 16 || kc < 16 ||
      n_split < 1 || n_split > kMaxSplit ||
      smem_bytes(hd, kc, mb) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), q_sb, q_ss, q_sh, k, v,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(bt), bt_sb, pos, pos_sb, pos_ss, pos_i64,
         static_cast<bf16*>(out), s, h, hkv, hd, bs, mb, window, kc, q_vec,
         scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp8 ? launch<true>(a, b, n_split, st) : launch<false>(a, b, n_split, st);
}
