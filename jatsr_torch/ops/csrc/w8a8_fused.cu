// The W8A8 products in front of which a row quant runs, for Hopper: the
// fused one (B4: the serving DiT's out_proj and w8a8_dot(impl="fused")) and
// the product on a pre-quantised A (B14: w8a8_dot(impl="pallas") and the
// serving DiT's qkv projection on the third serving path).
//
// B4 replaces the TPU kernel int8_matmul_fused (_fused_kernel) in the JAX
// package's ops/int8_matmul.py.  Same math and rounding points:
//   s    = max(max|a_row| * INV127, 1e-12)        the floored scale
//   a_q  = rint(a / s)                            a true divide, half to even
//   out  = OUT(((float)(a_q @ w_q) * s) * ws)     the same floored s, no bias
// with a bf16 or fp32 (the JAX kernel's two) and OUT bf16 or fp32 (its
// out_dtype, which w8a8_dot sets to the lhs's dtype).  Only abs, max,
// multiply, divide and round touch the values, so the result equals the
// two-stage path (quantise, then product) bit for bit.
//
// B14 replaces the TPU kernel int8_matmul (_kernel) of the same file: the
// product on the caller's a_q with the caller's scale, unfloored,
//   out  = OUT(((float)(a_q @ w_q) * a_scale) * ws)   OUT bf16 or fp32
// (QuantDense adds its bias afterwards, in bf16).  The TPU kernel's (512 x
// 1024) blocks are VMEM tiling with no change to the numbers.  In front of
// it w8a8_dot(impl="pallas") quantises lhs as the JAX package does in XLA:
// the codes by the floored scale, a_scale the unfloored max|a_row| *
// INV127 (the divide would otherwise be a chain of torch launches).
//
// What bounds them on the H100: at the out_proj shape (M = 2112, K = N =
// 1280) B4's product is 6.92 G int8 operations (3.50 us at the 1979 TOP/s
// peak) against 12.5 MB of compulsory traffic (3.72 us at 3.35 TB/s): bytes
// bound it, narrowly; in fp32 (a and out) 23.3 MB (6.95 us) bound it.  At
// the qkv shape (N = 1792) B14's is 9.69 G operations (4.90 us) against
// 12.6 MB (3.77 us): the tensor cores bound it.
//
// Design: two launches.
//   1. s8_rows.cuh's quant_rows_v (B4; quant_rows_f32_v on fp32 rows) or
//      quant_rows_raw_v (B14): one warp a row, the row kept in registers
//      between the max and the codes; it writes a_q [M, K] s8 and s [M]
//      (2.7 MB at the serving shape, L2-resident).  Its first instruction
//      lets the next launch start (griddepcontrol).
//   2. s8_dequant.cuh's GEMM (wgmma fed by TMA, 128 x 128 tiles, two CTAs
//      an SM) on a_q and the weight K-major, wt [N, K], without the bias:
//      one kernel body for both products.  It is launched with programmatic
//      stream serialisation behind the quant launch: its CTAs start while
//      that launch drains and wait only before the first copy of a_q and
//      before reading s.  B14's GEMM always starts so (int8_matmul): the
//      launches that let the next one start early (the row quants,
//      mlp_full.cu's first product) write no weight, the one thing it
//      reads before the wait.
// Folding the quantisation into the GEMM's A stages (every CTA of a row
// tile taking its rows' max over all K first) would read A from L2 once per
// column tile and twice per CTA: PERF.md has the sums.

#include "s8_dequant.cuh"
#include "s8_split.cuh"

// The quant launch alone: a [M, K] bf16 -> aq [M, K] s8, s [M] f32 (the
// floored scales).  Needs K % 8 == 0, 16-byte aligned rows.
extern "C" int w8a8_quant(const void* a, void* aq, void* s, int M, int K, void* stream) {
  return launch_quant_rows<false>(a, aq, s, M, K, (cudaStream_t)stream);
}

// B4's GEMM launch alone, on a quant launch's aq and s: wt [N, K] s8 (the
// weight K-major), ws [N] f32 -> out [M, N] bf16.  Needs N % 128 == 0 and
// K % 16 == 0.
extern "C" int w8a8_gemm(const void* aq, const void* s, const void* wt, const void* ws, void* out,
                         int M, int K, int N, void* stream) {
  return s8_dequant<false, __nv_bfloat16>(aq, s, wt, ws, nullptr, out, M, K, N, false,
                                          (cudaStream_t)stream);
}

// B4: a [M, K] bf16 or (a_f32) fp32; wt [N, K] s8 (the weight K-major); ws
// [N] f32.  Scratch: aq [M, K] s8, s [M] f32.  Output: out [M, N] bf16 or
// (out_f32) fp32.  Needs K % 64 == 0, K >= 128 and N % 128 == 0.  Two
// launches, the second overlapping the first's tail.  An fp32 a takes
// s8_rows.cuh's fp32 row quant (the same scale and codes, read without a
// widening); an fp32 out the GEMM's fp32 instance, B14's.
extern "C" int w8a8_fused_dt(const void* a, const void* wt, const void* ws, void* aq, void* s,
                             void* out, int M, int K, int N, int a_f32, int out_f32,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = a_f32 ? launch_quant_rows_f32(a, aq, s, M, K, st)
                              : launch_quant_rows<false>(a, aq, s, M, K, st);
  if (e != cudaSuccess) return e;
  return out_f32 ? s8_dequant<false, float>(aq, s, wt, ws, nullptr, out, M, K, N, true, st)
                 : s8_dequant<false, __nv_bfloat16>(aq, s, wt, ws, nullptr, out, M, K, N, true,
                                                    st);
}

// B4 in bf16 (tools/torch_b4_b7_split.py calls it in this tree and its
// parents').
extern "C" int w8a8_fused(const void* a, const void* wt, const void* ws, void* aq, void* s,
                          void* out, int M, int K, int N, void* stream) {
  return w8a8_fused_dt(a, wt, ws, aq, s, out, M, K, N, 0, 0, stream);
}

// B14's quant launch (w8a8_dot(impl="pallas")): a [M, K] bf16 -> aq [M, K]
// s8 (codes by the floored scale), s [M] f32 (the unfloored scales).  Needs
// K % 8 == 0, 16-byte aligned rows.  Its first instruction lets the next
// launch start.
extern "C" int prequant_quant(const void* a, void* aq, void* s, int M, int K, void* stream) {
  return launch_quant_rows<false, true>(a, aq, s, M, K, (cudaStream_t)stream);
}

// B14: aq [M, K] s8, s [M] f32 (the caller's row scales), wt [N, K] s8 (the
// weight K-major), ws [N] f32 -> out [M, N], bf16 or (out_f32) fp32.  Needs
// N % 128 == 0 and K % 16 == 0.  With pdl it starts under programmatic
// stream serialisation: its CTAs read wt before they wait for the launch in
// front, which must not be writing it.
extern "C" int matmul_prequant(const void* aq, const void* s, const void* wt, const void* ws,
                               void* out, int M, int K, int N, int out_f32, int pdl,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? s8_dequant<false, float>(aq, s, wt, ws, nullptr, out, M, K, N, pdl, st)
                 : s8_dequant<false, __nv_bfloat16>(aq, s, wt, ws, nullptr, out, M, K, N, pdl,
                                                    st);
}

// ---- B4 row-parallel (tensor parallelism, s8_split.cuh) --------------------
// A rank's heads of out_proj's input: a [M, K] bf16 (K its columns), wt
// [N, K] s8 its rows of the kernel K-major, ws [N] f32 (whole).  Part 1:
// amax [M] f32, max|a_row| over the rank's columns (one launch).  The
// caller takes the max over the ranks; part 2: the codes at the whole row's
// scale and the s8 wgmma GEMM writing int32 -> aq [M, K] s8, s [M] f32, acc
// [M, N] s32 (two launches, the second under programmatic stream
// serialisation).  The caller adds acc over the ranks; part 3: out [M, N]
// bf16 or (out_f32) fp32 = ((float)acc * s) * ws (one launch).
extern "C" int w8a8_split1(const void* a, void* amax, int M, int K, void* stream) {
  return launch_row_absmax(a, amax, M, K, (cudaStream_t)stream);
}

extern "C" int w8a8_split2(const void* a, const void* amax, const void* wt, void* aq, void* s,
                           void* acc, int M, int K, int N, void* stream) {
  return launch_quant_acc(a, amax, wt, aq, s, acc, M, K, N, (cudaStream_t)stream);
}

extern "C" int w8a8_split3(const void* acc, const void* s, const void* ws, void* out, int M,
                           int N, int out_f32, void* stream) {
  return launch_dequant_acc(acc, s, ws, out, M, N, out_f32, (cudaStream_t)stream);
}

// ---- B14 row-parallel (tensor parallelism, s8_split.cuh) -------------------
// w8a8_dot(impl="pallas") on a rank's columns of the input (out_proj's
// heads, the unfused mlp_out's hidden columns) and its rows of the kernel.
// Part 1 is w8a8_split1 (the rank's row maxima); the caller takes the max
// over the ranks; part 2: the codes by the whole row's floored scale and the
// s8 wgmma GEMM writing int32 -> aq [M, K] s8, s [M] f32 (the UNFLOORED
// scale, amax * INV127, as B14 rescales by it), acc [M, N] s32 (two
// launches); the caller adds acc over the ranks; part 3 is w8a8_split3 on
// that s: out = OUT(((float)acc * s) * ws), B14's epilogue.
extern "C" int prequant_split2(const void* a, const void* amax, const void* wt, void* aq,
                               void* s, void* acc, int M, int K, int N, void* stream) {
  return launch_quant_acc<true>(a, amax, wt, aq, s, acc, M, K, N, (cudaStream_t)stream);
}
