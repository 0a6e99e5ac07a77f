// y[g] = x[g] @ W_g over a stack of packed NVFP4 weights, one launch (K3).
//
// Replaces the Pallas TPU kernel
// repro/kernels/nvfp4_matmul.py::nvfp4_matmul_grouped (_grouped_kernel).
// x [G, M, K] (laid out by the wrapper, as K2's), codes uint8
// [G, N, Kp/2], scales e4m3 [G, N, Kp/16], f32 tensor scales: one per group
// (ts_stride 1, the pack(..., n_lead=1) layout) or one for the whole stack
// (ts_stride 0).  This is the MoE expert GEMM: G experts, M token rows per
// expert (the dispatch capacity times the rows dispatched together), and
// every expert's weight tile is decoded on chip, so a step streams the
// packed 0.5625 B/param instead of a bf16 copy of every expert.
//
// Bound: bytes at decode (M = 8 per expert in the engine: the whole packed
// stack, 97.3 MB for a [60, 1408, 2048] Qwen1.5-MoE stack), operations at
// prefill.  The design is K2's (nvfp4_matmul.cuh: swap-AB mma.sync over a
// cp.async ring, exact register decode, mma.sync at decode and wgmma at
// prefill, per-64-k promotion, one K order for every M) with the group in blockIdx.z: every group runs exactly K2's
// code on its slices, so K3 on group g equals K2 on group g bitwise.  A
// block's shape may differ from K2's (it is chosen from the whole grid),
// which moves no element's K order.  Every group is computed, reached by a
// token or not, as the reference computes them.
#include "nvfp4_matmul.cuh"

extern "C" int nvfp4_matmul_grouped(const void* x, int x_is_f32,
                                    const void* codes, const void* scales,
                                    const void* tensor_scale, int ts_stride,
                                    void* out, int out_is_f32, int groups,
                                    int m, int n, int k, int kp, void* stream) {
  return run_matmul<true>(x, x_is_f32, codes, scales, tensor_scale, ts_stride,
                          out, out_is_f32, groups, m, n, k, kp, stream);
}
