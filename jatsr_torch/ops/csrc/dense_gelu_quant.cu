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
// Design: B1's GEMM without its prologue, three launches in one C call.
//   1. s8_rows.cuh's row quant (the row in registers up to K = 8192, the
//      patch embed's): a_q [M, K] s8 and s [M].  The fp32 mode (fp32 rows,
//      the JAX model's at dtype="float32") takes its fp32 row quant: the
//      row in registers up to K = 2048, read twice past it.
//   2. and 3. s8_gelu.cuh's two passes on s8_wgmma.cuh's tile (wgmma fed by
//      TMA, 128 x 128 tiles, two CTAs an SM) on a_q and the weight K-major,
//      wt [N, K], which the caller makes once: pass 1 the rows' maxima
//      over each 128-wide tile, pass 2 g again, the codes and gs.  Both
//      are launched with programmatic stream serialisation: their CTAs set
//      up and issue the weight's first copy while the launch before drains.
// No g goes through device memory, only the [M, N / 128] partial maxima.
// At the patch embed the 128 x 128 tile leaves 68 CTAs for 132 SMs, each
// 64 stages deep (PERF.md has what that costs).

#include "s8_gelu.cuh"
#include "s8_rows.cuh"
#include "s8_split.cuh"

namespace {

template <int GELU, int PASS, bool BF16>
__global__ void __launch_bounds__(S8_THREADS, 2) dgq_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, const float* __restrict__ bias,
    float* __restrict__ part, int8_t* __restrict__ gq, float* __restrict__ gs, int M, int K,
    int N) {
  s8_gelu_tile<GELU, PASS, BF16, true>(am, bm, s, ws, bias, part, gq, gs, M, K, N);
}

template <int GELU, bool BF16>
cudaError_t launch_passes_t(const CUtensorMap& am, const CUtensorMap& bm, const void* s,
                            const void* ws, const void* bias, void* part, void* gq, void* gs,
                            int M, int K, int N, int passes, cudaStream_t st) {
  const dim3 grid(N / S8_BN, (M + S8_BM - 1) / S8_BM);
  auto S = (const float*)s;
  auto WS = (const float*)ws;
  auto B = (const float*)bias;
  auto P = (float*)part;
  auto Q = (int8_t*)gq;
  auto GS = (float*)gs;
  cudaError_t e = cudaSuccess;
  if (passes & 1)
    e = s8_launch<dgq_kernel<GELU, 1, BF16>>(grid, S8_THREADS, S8_SMEM, true, st, am, bm, S, WS,
                                             B, P, Q, GS, M, K, N);
  if (e == cudaSuccess && (passes & 2))
    e = s8_launch<dgq_kernel<GELU, 2, BF16>>(grid, S8_THREADS, S8_SMEM, true, st, am, bm, S, WS,
                                             B, P, Q, GS, M, K, N);
  return e;
}

template <bool BF16>
cudaError_t launch_passes_b(const CUtensorMap& am, const CUtensorMap& bm, const void* s,
                            const void* ws, const void* bias, void* part, void* gq, void* gs,
                            int M, int K, int N, int gelu_impl, int passes, cudaStream_t st) {
  if (gelu_impl == 1)
    return launch_passes_t<1, BF16>(am, bm, s, ws, bias, part, gq, gs, M, K, N, passes, st);
  if (gelu_impl == 2)
    return launch_passes_t<2, BF16>(am, bm, s, ws, bias, part, gq, gs, M, K, N, passes, st);
  return launch_passes_t<0, BF16>(am, bm, s, ws, bias, part, gq, gs, M, K, N, passes, st);
}

cudaError_t launch_passes(const void* aq, const void* s, const void* wt, const void* ws,
                          const void* bias, void* part, void* gq, void* gs, int M, int K, int N,
                          int gelu_impl, int fast, int passes, cudaStream_t st) {
  if (K % S8_BK || N % S8_BN) return cudaErrorInvalidValue;
  CUtensorMap am, bm;
  const cudaError_t e = s8_maps(&am, &bm, aq, wt, M, K, N);
  if (e != cudaSuccess) return e;
  if (fast)
    return launch_passes_b<false>(am, bm, s, ws, bias, part, gq, gs, M, K, N, gelu_impl, passes,
                                  st);
  return launch_passes_b<true>(am, bm, s, ws, bias, part, gq, gs, M, K, N, gelu_impl, passes, st);
}

}  // namespace

// The quant launch alone: a [M, K] bf16 -> aq [M, K] s8, s [M] f32.
extern "C" int dgq_quant(const void* a, void* aq, void* s, int M, int K, void* stream) {
  return launch_quant_rows<false>(a, aq, s, M, K, (cudaStream_t)stream);
}

// The GEMM passes alone, on a quant launch's aq and s: wt [N, K] s8 (the
// weight K-major), ws and bias [N] f32; part [M, N / 128] f32 scratch ->
// gq [M, N] s8, gs [M] f32.  `passes`: 1 the row maxima, 2 the codes (on
// part from pass 1), 3 both.
extern "C" int dgq_passes(const void* aq, const void* s, const void* wt, const void* ws,
                          const void* bias, void* part, void* gq, void* gs, int M, int K, int N,
                          int gelu_impl, int fast, int passes, void* stream) {
  return launch_passes(aq, s, wt, ws, bias, part, gq, gs, M, K, N, gelu_impl, fast, passes,
                       (cudaStream_t)stream);
}

// a [M, K] bf16, or (a_f32) fp32; wt [N, K] s8 (the weight K-major); ws,
// bias [N] f32.  Scratch: aq [M, K] s8, s [M] f32, part [M, N / 128] f32.
// Outputs: gq [M, N] s8, gs [M] f32.  Needs K % 128 == 0 and N % 128 == 0
// (the wrapper checks).  Three launches.  The fp32 mode (an fp32 a: the JAX
// model's patch embed and mlp_in at dtype="float32") quantises its rows by
// s8_rows.cuh's fp32 row quant (B4's fp32 mode's: the same floored scale
// and codes on values read without a widening); the passes are the same.
extern "C" int dense_gelu_quant_dt(const void* a, const void* wt, const void* ws,
                                   const void* bias, void* aq, void* s, void* part, void* gq,
                                   void* gs, int M, int K, int N, int gelu_impl, int fast,
                                   int a_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = a_f32 ? launch_quant_rows_f32(a, aq, s, M, K, st)
                              : launch_quant_rows<false>(a, aq, s, M, K, st);
  if (e != cudaSuccess) return e;
  return launch_passes(aq, s, wt, ws, bias, part, gq, gs, M, K, N, gelu_impl, fast, 3, st);
}

// B5 in bf16 (tools/torch_b5_b13_split.py calls it in this tree and its
// parents').
extern "C" int dense_gelu_quant(const void* a, const void* wt, const void* ws, const void* bias,
                                void* aq, void* s, void* part, void* gq, void* gs, int M, int K,
                                int N, int gelu_impl, int fast, void* stream) {
  return dense_gelu_quant_dt(a, wt, ws, bias, aq, s, part, gq, gs, M, K, N, gelu_impl, fast, 0,
                             stream);
}

// ---- B5 column-parallel (tensor parallelism, s8_split.cuh) -----------------
// A rank's columns of mlp_in behind the unfused prologue: a [M, K] bf16, the
// whole (replicated) row; wt [N, K] s8 the rank's N columns K-major, ws and
// bias [N] f32.  Part 1: the row quant, pass 1 on the rank's columns and
// each row's max over its partials -> aq, s, part [M, N / 128], rm [M]:
// three launches.  The caller takes the max of rm over the ranks; part 2:
// every partial of a row set to it, then pass 2 -> gq [M, N] s8, gs [M]:
// two launches.
extern "C" int dgq_split1(const void* a, const void* wt, const void* ws, const void* bias,
                          void* aq, void* s, void* part, void* rm, int M, int K, int N,
                          int gelu_impl, int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_quant_rows<false>(a, aq, s, M, K, st);
  if (e == cudaSuccess)
    e = launch_passes(aq, s, wt, ws, bias, part, nullptr, nullptr, M, K, N, gelu_impl, fast, 1,
                      st);
  return e != cudaSuccess ? e : launch_rowmax_reduce(part, rm, M, N / S8_BN, st);
}

extern "C" int dgq_split2(const void* aq, const void* s, const void* wt, const void* ws,
                          const void* bias, void* part, const void* rm, void* gq, void* gs, int M,
                          int K, int N, int gelu_impl, int fast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = launch_rowmax_fill(rm, part, M, N / S8_BN, st);
  return e != cudaSuccess ? e
                          : launch_passes(aq, s, wt, ws, bias, part, gq, gs, M, K, N, gelu_impl,
                                          fast, 2, st);
}
