// W8A8 product with the activation's per-row quantisation in front, for
// Hopper: the serving DiT's out_proj and w8a8_dot(impl="fused").
//
// Replaces the TPU kernel int8_matmul_fused (_fused_kernel) in the JAX
// package's ops/int8_matmul.py.  Same math and rounding points:
//   s    = max(max|a_row| * INV127, 1e-12)        the floored scale
//   a_q  = rint(a / s)                            a true divide, half to even
//   out  = bf16(((float)(a_q @ w_q) * s) * ws)    the same floored s
// Only abs, max, multiply, divide and round touch the values, so the result
// equals the two-stage path (quantise, then product) bit for bit.
//
// What bounds it on the H100: at the out_proj shape (M = 2112, K = N = 1280)
// the product is 6.92 G int8 operations (3.50 us at the 1979 TOP/s peak)
// against 12.5 MB of compulsory traffic (3.72 us at 3.35 TB/s): bytes bound
// it, narrowly.
//
// Design: quant_rows (one warp per row) writes the codes and scales to
// scratch, then the s8 GEMM of int8_gemm.cuh with the dequant epilogue
// without a bias.  The TPU kernel quantises inside the product's row block
// and keeps the codes in VMEM; here they make one round trip through
// device memory (2.7 MB at the serving shape, L2-resident).

//
// matmul_prequant, the same GEMM and epilogue on an A quantised by the
// caller, replaces the TPU kernel int8_matmul (_kernel) in the same file of
// the JAX package: w8a8_dot(impl="pallas").  Its scale is the caller's
// unfloored a_scale:  out = bf16(((float)(a_q @ w_q) * a_scale) * ws), no
// bias (QuantDense adds its bias afterwards, in bf16).  At the qkv shape
// (M = 2112, K = 1280, N = 1792) the product is 9.69 G int8 operations
// (4.90 us at 1979 TOP/s) against 12.6 MB (3.77 us at 3.35 TB/s): the
// tensor cores bound it.  One launch; the TPU kernel's (512 x 1024) blocks
// are VMEM tiling with no change to the numbers.

#include "int8_gemm.cuh"

// a [M, K] bf16; wq [K, N] s8; ws [N] f32.  Scratch: aq [M, K] s8, s [M]
// f32.  Output: out [M, N] bf16.  Needs K % 64 == 0 and N % 128 == 0.
extern "C" int matmul_fused(const void* a, const void* wq, const void* ws, void* aq,
                            void* s, void* out, int M, int K, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  quant_rows<<<(M + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)a, (int8_t*)aq,
                                          (float*)s, nullptr, M, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_dequant<false><<<grid, 128, 0, st>>>((const int8_t*)aq, (const int8_t*)wq,
                                            (const float*)ws, nullptr, (const float*)s,
                                            (__nv_bfloat16*)out, M, K, N);
  return cudaGetLastError();
}

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
