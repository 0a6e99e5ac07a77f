// y = x @ W with W stored as packed NVFP4 W^T, dequantized on the fly (K2).
//
// Replaces the Pallas TPU kernel
// repro/kernels/nvfp4_matmul.py::nvfp4_matmul (_matmul_kernel, _dequant_tile).
// x [M, K], codes uint8 [N, Kp/2], scales e4m3 [N, Kp/16], one f32 tensor
// scale.  The device code (a GEMV for M <= 8, a tiled f32-FMA GEMM above,
// and what bounds each) lives in nvfp4_matmul.cuh, which the grouped form
// (nvfp4_matmul_grouped.cu, K3) shares: this entry point is its one-group
// launch.
#include "nvfp4_matmul.cuh"

extern "C" int nvfp4_matmul(const void* x, int x_is_f32, const void* codes,
                            const void* scales, const void* tensor_scale,
                            void* out, int out_is_f32, int m, int n, int k,
                            int kp, void* stream) {
  return run_matmul<false>(x, x_is_f32, codes, scales, tensor_scale, 0, out,
                           out_is_f32, 1, m, n, k, kp, stream);
}
