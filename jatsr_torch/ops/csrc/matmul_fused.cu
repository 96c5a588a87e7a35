// The s8 product on an A quantised by the caller, for Hopper:
// w8a8_dot(impl="pallas") and the serving DiT's qkv projection on the
// third serving path.
//
// matmul_prequant replaces the TPU kernel int8_matmul (_kernel) in the JAX
// package's ops/int8_matmul.py.  Its scale is the caller's unfloored
// a_scale:  out = bf16(((float)(a_q @ w_q) * a_scale) * ws), no bias
// (QuantDense adds its bias afterwards, in bf16).  At the qkv shape
// (M = 2112, K = 1280, N = 1792) the product is 9.69 G int8 operations
// (4.90 us at 1979 TOP/s) against 12.6 MB (3.77 us at 3.35 TB/s): the
// tensor cores bound it.  One launch of int8_gemm.cuh's mma.sync GEMM with
// the dequant epilogue without a bias; the TPU kernel's (512 x 1024) blocks
// are VMEM tiling with no change to the numbers.  (The fused W8A8 product,
// int8_matmul_fused, is w8a8_fused.cu.)

#include "int8_gemm.cuh"

// aq [M, K] s8, s [M] f32 (the caller's row scales), wq [K, N] s8, ws [N]
// f32 -> out [M, N] bf16.  Needs K % 64 == 0 and N % 128 == 0.
extern "C" int matmul_prequant(const void* aq, const void* s, const void* wq, const void* ws,
                               void* out, int M, int K, int N, void* stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_dequant<false><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const int8_t*)aq, (const int8_t*)wq, (const float*)ws, nullptr, (const float*)s,
      (__nv_bfloat16*)out, M, K, N);
  return cudaGetLastError();
}
