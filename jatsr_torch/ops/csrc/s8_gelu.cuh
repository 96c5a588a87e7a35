// The GELU epilogue of the s8 wgmma GEMMs, and the two-pass GEMM with the
// whole-row requant that B1 (norm_mod.cu) and B5 (dense_gelu_quant.cu)
// run on s8_wgmma.cuh's tile; B13's first product (mlp_full.cu) takes its
// GELU values from here too.  Each csrc/*.cu that includes this file is
// built into its own shared library, so everything here lives in an
// anonymous namespace.
//
//   y  = ((float)acc * s) * ws + b                fp32, no FMA contraction
//   g  = gelu(y)                                  int8_gemm.cuh's tanh, A&S
//                                                 erf or sigmoid form
// With BF16, y and then g are rounded to bf16 (the unfused path's round
// points: B5 under fast_epilogue=False, and B13).
//
// The two passes keep g out of device memory: pass 1 computes each 128 x
// 128 tile's g and writes its rows' max |g| to a [M, N / 128] fp32 partial
// (no atomics); pass 2 recomputes g by the same instructions (so the same
// bits), takes each row's exact max over its partials (a max is exact in
// any order), gs = max(rowmax * INV127, 1e-12), and writes the codes
// rint(g / gs) and gs.  The tensor work doubles; nothing of g but the
// codes and the partials goes through device memory.

#pragma once

#include "int8_gemm.cuh"
#include "s8_wgmma.cuh"

namespace {

// g of one accumulator at row scale s, column scale w and bias b.
template <int GELU, bool BF16>
__device__ __forceinline__ float s8_gelu_of(int acc, float s, float w, float b) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s), w), b);
  if (BF16) y = bf16r(y);
  const float g = gelu<GELU>(y);
  return BF16 ? bf16r(g) : g;
}

// Pass PASS of two over the tile (blockIdx.y, blockIdx.x) of a_q [M, K] @
// wt [N, K]^T (both K-major, by the tensor maps am and bm), K % 128 == 0,
// N % 128 == 0.  With PDL the launch may start before the one that writes
// a_q and s (pass 1) or the partials (pass 2) has finished: the weight's
// first copy goes out at once, the codes' and every read of s or of the
// partials wait for it (griddepcontrol.wait).
template <int GELU, int PASS, bool BF16, bool PDL>
__device__ __forceinline__ void s8_gelu_tile(const CUtensorMap& am, const CUtensorMap& bm,
                                             const float* __restrict__ s,
                                             const float* __restrict__ ws,
                                             const float* __restrict__ bias,
                                             float* __restrict__ part, int8_t* __restrict__ gq,
                                             float* __restrict__ gs, int M, int K, int N) {
  const int n0 = blockIdx.x * S8_BN, m0 = blockIdx.y * S8_BM, nt = gridDim.x;
  float sc[2] = {1.f, 1.f};  // pass 2: the scales of the thread's two rows
  s8_gemm_tile(
      K / S8_BK,
      [&](int kb, unsigned char* a, unsigned char* b, uint64_t* bar) {
        if (PDL) {
          tma_load_2d(b, &bm, bar, kb * S8_BK, n0);  // the weight: no dependence
          if (kb == 0) griddep_wait();
          tma_load_2d(a, &am, bar, kb * S8_BK, m0);
        } else {
          tma_load_2d(a, &am, bar, kb * S8_BK, m0);
          tma_load_2d(b, &bm, bar, kb * S8_BK, n0);
        }
      },
      [&](int row, int col) {
        if (PDL) griddep_wait();  // s, and in pass 2 the partials
        if (PASS == 1) return;
        // The rows' maxima over their partials, a quad's four lanes taking
        // every fourth (a max is exact in any order), read while the
        // products run.
        float rm[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          if (r >= M) continue;
          const float* pr = part + (size_t)r * nt;
#pragma unroll 4
          for (int j = col / 2; j < nt; j += 4) rm[h] = fmaxf(rm[h], pr[j]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rm[h] = fmaxf(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 1));
          rm[h] = fmaxf(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 2));
          sc[h] = fmaxf(__fmul_rn(rm[h], INV127), 1e-12f);
          const int r = m0 + row + 8 * h;
          if (blockIdx.x == 0 && col == 0 && r < M) gs[r] = sc[h];
        }
      },
      [&](const int (&acc)[S8_ACC], int row, int col, unsigned char* stage) {
        // Pass 2 stages the codes in shared memory (rows of 144 bytes: the
        // 8 rows of a store hit distinct banks), then 16-byte stores.
        constexpr int STR = S8_BN + 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          const bool ok = r < M;  // uniform over a quad: the shuffles below
          const float sr = ok ? s[r] : 0.f;
          float amax = 0.f;
#pragma unroll
          for (int i = 0; i < S8_BN / 8; ++i) {
            const int c = n0 + 8 * i + col;
            const float2 w = *reinterpret_cast<const float2*>(ws + c);
            const float2 bb = *reinterpret_cast<const float2*>(bias + c);
            const float g0 = s8_gelu_of<GELU, BF16>(acc[4 * i + 2 * h], sr, w.x, bb.x);
            const float g1 = s8_gelu_of<GELU, BF16>(acc[4 * i + 2 * h + 1], sr, w.y, bb.y);
            if (PASS == 1) {
              amax = fmaxf(amax, fmaxf(fabsf(g0), fabsf(g1)));
            } else {
              const uint32_t q0 = (uint32_t)__float2int_rn(__fdiv_rn(g0, sc[h])) & 0xffu;
              const uint32_t q1 = (uint32_t)__float2int_rn(__fdiv_rn(g1, sc[h])) & 0xffu;
              *reinterpret_cast<uint16_t*>(stage + (row + 8 * h) * STR + 8 * i + col) =
                  (uint16_t)(q0 | (q1 << 8));
            }
          }
          if (PASS == 1) {
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
            if (ok && col == 0) part[(size_t)r * nt + blockIdx.x] = amax;
          }
        }
        if (PASS == 2) {
          __syncthreads();
          for (int x = threadIdx.x; x < S8_BM * S8_BN / 16; x += S8_THREADS) {
            const int rr = x / (S8_BN / 16), cc = (x % (S8_BN / 16)) * 16;
            if (m0 + rr < M)
              *reinterpret_cast<uint4*>(gq + (size_t)(m0 + rr) * N + n0 + cc) =
                  *reinterpret_cast<const uint4*>(stage + rr * STR + cc);
          }
        }
      });
}

// The tensor maps of a_q [M, K] and the K-major weight wt [N, K].
cudaError_t s8_maps(CUtensorMap* am, CUtensorMap* bm, const void* aq, const void* wt, int M,
                    int K, int N) {
  cudaError_t e = s8_tensor_map(am, aq, M, K, S8_BM);
  return e != cudaSuccess ? e : s8_tensor_map(bm, wt, N, K, S8_BN);
}

}  // namespace
