// The s8 wgmma GEMM with the dequant epilogue, for Hopper:
//   out = OUT(((float)(a_q @ w_q) * s) * ws [+ b])
// fp32, each operation rounded (__fmul_rn, __fadd_rn: no FMA contraction),
// then one rounding to OUT, bf16 or fp32.  Nothing is added without a bias,
// not even 0 (which would turn -0 into +0).  One kernel body for every
// dequantising s8 product behind a row quant: B4 (the fused W8A8 product)
// and B14 (the product on a pre-quantised A) in w8a8_fused.cu, without a
// bias; B12's out projection in flash_qkv.cu and attention_wide.cu, with
// one.  Each csrc/*.cu that includes this file is built into its own shared
// library, so everything here lives in an anonymous namespace.
//
// s8_wgmma.cuh's tile (wgmma fed by TMA, 128 x 128 outputs a CTA, two
// CTAs an SM), behind s8_rows.cuh's row quant, on a_q [M, K] and the weight
// K-major, wt [N, K], which the caller makes once (wgmma reads 8-bit
// operands K-major only).  The tile goes through shared memory for 16-byte
// stores.  Launched with programmatic stream serialisation behind the
// row-quant launch that writes a_q and s, its CTAs start while that launch
// drains, set up their barriers and issue the first weight copies, and wait
// (griddepcontrol.wait) only before the first copy of a_q and before
// reading s; without it the wait returns at once.

#pragma once

#include "s8_rows.cuh"

namespace {

// Needs N % 128 == 0; K is covered by ceil(K / 128) stages (the boxes
// zero-fill past K).  The bias comes last, so that B4's instance
// (<false, __nv_bfloat16>) keeps its parameters where they were.
template <bool BIAS, class OUT>
__global__ void __launch_bounds__(S8_THREADS, 2) s8_dequant_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, OUT* __restrict__ out, int M,
    int K, int N, const float* __restrict__ bias) {
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
        // The tile through shared memory, then 16-byte stores.  bf16: rows
        // of 272 bytes, the 8 rows of a warp's 4-byte stores on distinct
        // banks; fp32: rows of 544 bytes, a warp's 8-byte stores in two
        // wavefronts, the least for 256 bytes.
        constexpr int W = sizeof(OUT);
        constexpr int STR = S8_BN * W + 8 * W;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          const float sr = r < M ? s[r] : 0.f;
#pragma unroll
          for (int i = 0; i < S8_BN / 8; ++i) {
            const float2 w = *reinterpret_cast<const float2*>(ws + n0 + 8 * i + col);
            float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), sr), w.x);
            float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), sr), w.y);
            if constexpr (BIAS) {
              const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + 8 * i + col);
              y0 = __fadd_rn(y0, bb.x);
              y1 = __fadd_rn(y1, bb.y);
            }
            unsigned char* dst = stage + (row + 8 * h) * STR + (8 * i + col) * W;
            if constexpr (W == 2)
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
            else
              *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          }
        }
        __syncthreads();
        constexpr int CH = S8_BN * W / 16, E = 16 / W;  // 16-byte chunks a row, values a chunk
        for (int x = threadIdx.x; x < S8_BM * CH; x += S8_THREADS) {
          const int rr = x / CH, cc = (x % CH) * E;
          if (m0 + rr < M)
            *reinterpret_cast<uint4*>(out + (size_t)(m0 + rr) * N + n0 + cc) =
                *reinterpret_cast<const uint4*>(stage + rr * STR + cc * W);
        }
      });
}

// aq [M, K] s8 and s [M] f32 (a quant launch's), wt [N, K] s8 (the weight
// K-major), ws [N] and, with BIAS, bias [N] f32 -> out [M, N] OUT.  Needs N
// % 128 == 0 and K % 16 == 0 (TMA's row stride).  With pdl, launched under
// programmatic stream serialisation.
template <bool BIAS, class OUT>
cudaError_t s8_dequant(const void* aq, const void* s, const void* wt, const void* ws,
                       const void* bias, void* out, int M, int K, int N, bool pdl,
                       cudaStream_t st) {
  CUtensorMap am, bm;
  cudaError_t e = s8_tensor_map(&am, aq, M, K, S8_BM);
  if (e == cudaSuccess) e = s8_tensor_map(&bm, wt, N, K, S8_BN);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + S8_BN - 1) / S8_BN, (M + S8_BM - 1) / S8_BM);
  return s8_launch<s8_dequant_kernel<BIAS, OUT>>(grid, S8_THREADS, S8_SMEM, pdl, st, am, bm,
                                                 (const float*)s, (const float*)ws, (OUT*)out,
                                                 M, K, N, (const float*)bias);
}

// a [M, K] bf16 -> aq [M, K] s8, s [M] f32 by s8_rows.cuh's divide form (the
// floored scale), then the GEMM on them under programmatic stream
// serialisation: B12's out projection, with the bias (B4 composes the same
// two launches in w8a8_fused.cu, in bf16 or fp32).
template <bool BIAS>
cudaError_t s8_quant_dequant(const void* a, void* aq, void* s, const void* wt, const void* ws,
                             const void* bias, void* out, int M, int K, int N, cudaStream_t st) {
  const cudaError_t e = launch_quant_rows<false>(a, aq, s, M, K, st);
  return e != cudaSuccess
             ? e
             : s8_dequant<BIAS, __nv_bfloat16>(aq, s, wt, ws, bias, out, M, K, N, true, st);
}

}  // namespace
