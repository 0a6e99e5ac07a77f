// y = x @ W with W stored as packed NVFP4 W^T, dequantized on the fly (K2).
//
// Replaces the Pallas TPU kernel
// repro/kernels/nvfp4_matmul.py::nvfp4_matmul (_matmul_kernel, _dequant_tile).
// x [M, K] (laid out by the wrapper, kernels/nvfp4_matmul.py::_kernel_x),
// codes uint8 [N, Kp/2],
// scales e4m3 [N, Kp/16], one f32 tensor scale.  This entry point is the
// one-group launch of the device code in nvfp4_matmul.cuh, which the
// grouped form (nvfp4_matmul_grouped.cu, K3) shares, and which K4 runs on a
// rank's tile.
//
// Design (nvfp4_matmul.cuh): a tensor-core GEMM for every M, swap-AB
// (weight rows x tokens), codes, scales and x streamed through a cp.async
// ring, A fragments decoded from it into registers with byte-table
// lookups, bitwise equal to the plain version's bf16 weights.  Bound: the
// packed weight's bytes at decode, where M <= 32 runs mma.sync with K split
// into fixed ranges over the warps of a block (the ranges summed in
// order); operations at prefill (M > 32), wgmma over 128- or 192-row x
// 64-token tiles, x by TMA.  Tolerance: each 64-k chunk's MMAs start from zero and an f32 add
// promotes them, so truncation inside the tensor core never spans more
// than 64 products; one rounding of the output.  Row invariance: the K
// order depends on Kp alone, the same at every M and in both forms.
#include "nvfp4_matmul.cuh"

extern "C" int nvfp4_matmul(const void* x, int x_is_f32, const void* codes,
                            const void* scales, const void* tensor_scale,
                            void* out, int out_is_f32, int m, int n, int k,
                            int kp, void* stream) {
  return run_matmul<false>(x, x_is_f32, codes, scales, tensor_scale, 0, out,
                           out_is_f32, 1, m, n, k, kp, stream);
}
