// W8A8 dense + dequant + bias + GELU + whole-row requantize, for Hopper.
//
// Replaces the TPU kernel int8_dense_gelu_quant (_dense_gelu_quant_kernel)
// in the JAX package's ops/int8_matmul.py: the serving patch embed and, with
// the fused prologue off, the block MLP's first half.  Same math and
// rounding points:
//   s    = max(max|a_row| * INV127, 1e-12)        per row of A (fp32)
//   a_q  = rint(a / s)                            a divide, half to even
//   acc  = a_q @ w_q                              s8 x s8 -> s32, exact
//   y    = ((float)acc * s) * ws + b              fp32, no FMA contraction
//   g    = gelu(y)                                tanh / A&S erf / sigmoid
//          (fast_epilogue=0 rounds y and g to bf16, as the unfused path)
//   gs   = max(max|g_row| * INV127, 1e-12)        over the WHOLE N row
//   g_q  = rint(g / gs)
//
// What bounds it on the H100: at the mlp_in shape (M=2070, K=1280, N=5120)
// the product is 27.1 G int8 operations (13.7 us at the 1979 TOP/s int8
// peak) against 22.5 MB of compulsory traffic (6.7 us at 3.35 TB/s), so
// the tensor cores bound it.  At the patch-embed shape (K=8192, N=512) it
// is 17.4 G operations (8.8 us) against 39 MB (11.7 us): bytes bound it.
//
// Design.  The TPU kernel owns whole rows (block (bm, N) in VMEM), so its
// requant sees the full row max.  A CTA here tiles N, so the row max needs
// a second pass: three launches on one stream, all in one C call, built
// from the pieces in int8_gemm.cuh.
//   1. quant_rows: one warp per row, absmax and int8 codes of A; it also
//      zeroes the row-max accumulator of pass 2.
//   2. gemm_gelu: the s8 GEMM tile loop; the epilogue writes fp32 g to a
//      scratch [M, N] and takes the row max with atomicMax.
//   3. requant: one CTA per row turns g into int8 codes and writes gs.
// The fp32 [M, N] scratch round trip (2 x 42 MB at mlp_in) is the known
// cost the TPU kernel avoids; a later version keeps whole rows on chip.

#include "int8_gemm.cuh"

// a [M, K] bf16; wq [K, N] s8; ws, bias [N] f32.  Scratch: aq [M, K] s8,
// s [M] f32, g [M, N] f32, rowmax [M] s32.  Outputs: gq [M, N] s8, gs [M] f32.
// Needs K % 64 == 0 and N % 128 == 0 (the wrapper checks).
extern "C" int dense_gelu_quant(const void* a, const void* wq, const void* ws,
                                const void* bias, void* aq, void* s, void* g,
                                void* rowmax, void* gq, void* gs, int M, int K,
                                int N, int gelu_impl, int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  quant_rows<<<(M + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)a, (int8_t*)aq,
                                          (float*)s, (int*)rowmax, M, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  launch_gemm_gelu(gelu_impl, fast != 0, st, (const int8_t*)aq, (const int8_t*)wq,
                   (const float*)ws, (const float*)bias, (const float*)s, (float*)g,
                   (int*)rowmax, M, K, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  requant<<<M, 256, 0, st>>>((const float*)g, (const int*)rowmax, (int8_t*)gq,
                             (float*)gs, N);
  return cudaGetLastError();
}
