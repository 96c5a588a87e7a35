// W8A8 product with the activation's per-row quantisation in front, for
// Hopper: the serving DiT's out_proj and w8a8_dot(impl="fused").
//
// Replaces the TPU kernel int8_matmul_fused (_fused_kernel) in the JAX
// package's ops/int8_matmul.py.  Same math and rounding points:
//   s    = max(max|a_row| * INV127, 1e-12)        the floored scale
//   a_q  = rint(a / s)                            a true divide, half to even
//   out  = bf16(((float)(a_q @ w_q) * s) * ws)    the same floored s, no bias
// Only abs, max, multiply, divide and round touch the values, so the result
// equals the two-stage path (quantise, then product) bit for bit.  Nothing
// is added to the product, not even 0 (which would turn -0 into +0).
//
// What bounds it on the H100: at the out_proj shape (M = 2112, K = N = 1280)
// the product is 6.92 G int8 operations (3.50 us at the 1979 TOP/s peak)
// against 12.5 MB of compulsory traffic (3.72 us at 3.35 TB/s): bytes bound
// it, narrowly.
//
// Design: two launches.
//   1. s8_rows.cuh's quant_rows_v: one warp a row, the row kept in
//      registers between the max and the codes; it writes a_q [M, K] s8 and
//      s [M] (2.7 MB at the serving shape, L2-resident).  Its first
//      instruction lets the next launch start (griddepcontrol).
//   2. the s8 GEMM of s8_wgmma.cuh (wgmma fed by TMA, 128 x 128 tiles, two
//      CTAs an SM) on a_q and the weight K-major, wt [N, K], which the
//      caller makes once (wgmma reads 8-bit operands K-major only); the
//      dequant epilogue of B3's GEMM without the bias.  It is launched with
//      programmatic stream serialisation: its CTAs start while the quant
//      launch drains, set up their barriers and issue the first weight
//      copy, and wait (griddepcontrol.wait) only before the first copy of
//      a_q and before reading s.
// Folding the quantisation into the GEMM's A stages (every CTA of a row
// tile taking its rows' max over all K first) would read A from L2 once per
// column tile and twice per CTA: PERF.md has the sums.

#include "s8_rows.cuh"

namespace {

// out = bf16(((float)acc * s) * ws) on s8_wgmma.cuh's tile.  Needs N % 128
// == 0; K is covered by ceil(K / 128) stages (the boxes zero-fill past K).
__global__ void __launch_bounds__(S8_THREADS, 2) s8_fused_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
    int M, int K, int N) {
  const int n0 = blockIdx.x * S8_BN, m0 = blockIdx.y * S8_BM;
  s8_gemm_tile(
      (K + S8_BK - 1) / S8_BK,
      [&](int kb, unsigned char* a, unsigned char* b, uint64_t* bar) {
        tma_load_2d(b, &bm, bar, kb * S8_BK, n0);  // the weight: no dependence
        if (kb == 0) griddep_wait();               // the codes: the quant launch's
        tma_load_2d(a, &am, bar, kb * S8_BK, m0);
      },
      [](int, int) {},
      [&](const int (&acc)[S8_ACC], int row, int col, unsigned char* stage) {
        griddep_wait();  // the row scales, written by the quant launch
        // The tile in bf16 through shared memory (rows of 272 bytes: the
        // 8 rows of a store hit distinct banks), then 16-byte stores.
        constexpr int STR = S8_BN * 2 + 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          const float sr = r < M ? s[r] : 0.f;
#pragma unroll
          for (int i = 0; i < S8_BN / 8; ++i) {
            const float2 w = *reinterpret_cast<const float2*>(ws + n0 + 8 * i + col);
            const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), sr), w.x);
            const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), sr), w.y);
            *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8 * h) * STR + (8 * i + col) * 2) =
                __floats2bfloat162_rn(y0, y1);
          }
        }
        __syncthreads();
        for (int x = threadIdx.x; x < S8_BM * S8_BN / 8; x += S8_THREADS) {
          const int rr = x / (S8_BN / 8), cc = (x % (S8_BN / 8)) * 8;
          if (m0 + rr < M)
            *reinterpret_cast<uint4*>(out + (size_t)(m0 + rr) * N + n0 + cc) =
                *reinterpret_cast<const uint4*>(stage + rr * STR + cc * 2);
        }
      });
}

cudaError_t launch_gemm(const void* aq, const void* s, const void* wt, const void* ws, void* out,
                        int M, int K, int N, bool pdl, cudaStream_t st) {
  CUtensorMap am, bm;
  cudaError_t e = s8_tensor_map(&am, aq, M, K, S8_BM);
  if (e == cudaSuccess) e = s8_tensor_map(&bm, wt, N, K, S8_BN);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + S8_BN - 1) / S8_BN, (M + S8_BM - 1) / S8_BM);
  return s8_launch<s8_fused_kernel>(grid, S8_THREADS, S8_SMEM, pdl, st, am, bm, (const float*)s,
                                    (const float*)ws, (__nv_bfloat16*)out, M, K, N);
}

}  // namespace

// The quant launch alone: a [M, K] bf16 -> aq [M, K] s8, s [M] f32 (the
// floored scales).  Needs K % 8 == 0, 16-byte aligned rows.
extern "C" int w8a8_quant(const void* a, void* aq, void* s, int M, int K, void* stream) {
  return launch_quant_rows<false>(a, aq, s, M, K, (cudaStream_t)stream);
}

// The GEMM launch alone, on a quant launch's aq and s: wt [N, K] s8 (the
// weight K-major), ws [N] f32 -> out [M, N] bf16.  Needs N % 128 == 0 and
// K % 16 == 0.
extern "C" int w8a8_gemm(const void* aq, const void* s, const void* wt, const void* ws, void* out,
                         int M, int K, int N, void* stream) {
  return launch_gemm(aq, s, wt, ws, out, M, K, N, false, (cudaStream_t)stream);
}

// a [M, K] bf16; wt [N, K] s8 (the weight K-major); ws [N] f32.  Scratch:
// aq [M, K] s8, s [M] f32.  Output: out [M, N] bf16.  Needs K % 64 == 0,
// K >= 128 and N % 128 == 0.  Two launches, the second overlapping the
// first's tail.
extern "C" int w8a8_fused(const void* a, const void* wt, const void* ws, void* aq, void* s,
                          void* out, int M, int K, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = launch_quant_rows<false>(a, aq, s, M, K, st);
  return e != cudaSuccess ? e : launch_gemm(aq, s, wt, ws, out, M, K, N, true, st);
}
