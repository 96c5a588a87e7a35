// The whole serving MLP, quant(a) -> dot1 -> dequant + bias + GELU ->
// per-(row, slab) requant -> dot2 -> dequant + bias, for Hopper.
//
// Replaces the TPU kernel int8_mlp (_mlp_full_kernel) in the JAX package's
// ops/int8_matmul.py: the block MLP under fused_mlp_impl="full".  Same math
// and rounding points (the 4H hidden width is cut into n_slabs slabs of
// equal, 128-aligned width, _pick_slabs):
//   s    = max(max|a_row| * INV127, 1e-12);  a_q = rint(a * (1 / s))
//          a RECIPROCAL multiply, not the divide of B1-B5
//   y    = bf16(((float)(a_q @ w1) * s) * w1s + b1)
//   g    = bf16(gelu(y))                      tanh / A&S erf / sigmoid
//   gs   = max(max|g_row,slab| * INV127, 1e-12) per (row, slab)
//   g_q  = rint(g * (1 / gs))
//   acc2 = acc2 + (float)(g_q,slab @ w2,slab) * gs   fp32, slab by slab, in
//          slab order
//   out  = bf16(acc2 * w2s + b2)
// Every fp32 operation is __fmul_rn / __fadd_rn / __fdiv_rn (no FMA).
//
// What bounds it on the H100: at the v3 block (M = 2112, H = 1280, 4H =
// 5120, 4 slabs of 1280) the two products are 55.4 G int8 operations (28.0
// us at 1979 TOP/s) against 18.9 MB of compulsory traffic (a, both weight
// matrices, the output: 5.6 us at 3.35 TB/s): the tensor cores bound it.
//
// Design.  The TPU kernel holds both weight matrices (13.1 MB) in VMEM and
// a row block's hidden activation in registers; a CTA here has 227 KB of
// shared memory, and a slab's row max spans ten 128-wide output tiles.  So
// four launches in one C call, built from the s8 GEMM of int8_gemm.cuh:
//   1. quant_rows_rcp: one warp per row, codes and scale of A; it also
//      zeroes the row's slab maxima.
//   2. gemm_gelu_slabs: the first product, its epilogue writes bf16 g (g is
//      bf16-valued, so nothing is lost) and takes each (row, slab) max
//      with atomicMax (all values >= 0, so int order is float order).
//   3. requant_slabs: one CTA per row turns g into codes and writes gs.
//   4. gemm_slabs_dequant: the second product, one K slice per slab; at
//      each slab's end the int32 partial becomes fp32 and is added to the
//      running sum times its row's gs, in slab order.
// g (21.6 MB bf16) and g_q (10.8 MB) make one round trip through device
// memory, the known cost the TPU kernel avoids.

#include "int8_gemm.cuh"

namespace {

// Eight int8 codes of bf16 values times rcp, packed little-endian.
__device__ __forceinline__ uint2 quant8_rcp(uint4 v, float rcp) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int q = __float2int_rn(__fmul_rn(__bfloat162float(e[i]), rcp));
    w[i >> 2] |= (uint32_t)(q & 0xff) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

__global__ void quant_rows_rcp(const __nv_bfloat16* __restrict__ a, int8_t* __restrict__ aq,
                               float* __restrict__ s, int* __restrict__ rowmax, int n_slabs,
                               int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  const __nv_bfloat16* ar = a + (size_t)row * K;
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(ar + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  }
  amax = warp_max(amax);
  const float sc = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  const float rcp = __fdiv_rn(1.0f, sc);
  int8_t* qr = aq + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256)
    *reinterpret_cast<uint2*>(qr + k) = quant8_rcp(*reinterpret_cast<const uint4*>(ar + k), rcp);
  for (int j = lane; j < n_slabs; j += 32) rowmax[(size_t)row * n_slabs + j] = 0;
  if (lane == 0) s[row] = sc;
}

// The first product; a CTA's 128 columns lie in one slab (slab % 128 == 0).
template <int GELU>
__global__ void __launch_bounds__(128) gemm_gelu_slabs(
    const int8_t* __restrict__ aq, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, const float* __restrict__ bias,
    const float* __restrict__ s, __nv_bfloat16* __restrict__ g,
    int* __restrict__ rowmax, int slab, int n_slabs, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[BM * SSTR];
  __shared__ __align__(16) int8_t Wt[BN * SSTR];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[2][8][4];
  gemm_tile(aq, K, wq, M, K, N, m0, n0, As, Wt, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int j = n0 / slab;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + gid + half * 8;
      const float srow = (row < M) ? s[row] : 0.f;
      float amax = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + tig * 2;
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), srow),
                                        ws[col + e]),
                              bias[col + e]);
          out[e] = bf16r(gelu<GELU>(bf16r(y)));
          amax = fmaxf(amax, fabsf(out[e]));
        }
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(g + (size_t)row * N + col) =
              __floats2bfloat162_rn(out[0], out[1]);
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      if (tig == 0 && row < M) atomicMax(rowmax + (size_t)row * n_slabs + j, __float_as_int(amax));
    }
  }
}

__device__ __forceinline__ float slab_scale(const int* rowmax, int i) {
  return fmaxf(__fmul_rn(__int_as_float(rowmax[i]), INV127), 1e-12f);
}

// One CTA per row: g -> codes by the reciprocal of the slab's scale.
__global__ void requant_slabs(const __nv_bfloat16* __restrict__ g,
                              const int* __restrict__ rowmax, int8_t* __restrict__ gq,
                              float* __restrict__ gs, int slab, int n_slabs, int N) {
  const int row = blockIdx.x;
  const __nv_bfloat16* gr = g + (size_t)row * N;
  int8_t* qr = gq + (size_t)row * N;
  const int* rm = rowmax + (size_t)row * n_slabs;
  for (int c = threadIdx.x * 8; c < N; c += blockDim.x * 8) {  // 8 | slab
    const float rcp = __fdiv_rn(1.0f, slab_scale(rm, c / slab));
    *reinterpret_cast<uint2*>(qr + c) = quant8_rcp(*reinterpret_cast<const uint4*>(gr + c), rcp);
  }
  for (int j = threadIdx.x; j < n_slabs; j += blockDim.x)
    gs[(size_t)row * n_slabs + j] = slab_scale(rm, j);
}

// The second product: gq [M, K] (K = n_slabs * slab) @ wq [K, N], the
// int32 partial of each slab folded into fp32 with its row's gs.
__global__ void __launch_bounds__(128) gemm_slabs_dequant(
    const int8_t* __restrict__ gq, const int8_t* __restrict__ wq,
    const float* __restrict__ gs, const float* __restrict__ ws,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int slab,
    int n_slabs, int M, int N) {
  __shared__ __align__(16) int8_t As[BM * SSTR];
  __shared__ __align__(16) int8_t Wt[BN * SSTR];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = slab * n_slabs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, wm = warp >> 1, wn = warp & 1;
  float acc2[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc2[i][t][r] = 0.f;

  for (int j = 0; j < n_slabs; ++j) {
    int acc[2][8][4];
    gemm_tile(gq + (size_t)j * slab, K, wq + (size_t)j * slab * N, M, slab, N, m0, n0, As, Wt,
              acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + gid + half * 8;
        const float sc = (row < M) ? gs[(size_t)row * n_slabs + j] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& a2 = acc2[mt][nt][half * 2 + e];
            a2 = __fadd_rn(a2, __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), sc));
          }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + gid + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + tig * 2;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = __fadd_rn(__fmul_rn(acc2[mt][nt][half * 2 + e], ws[col + e]), bias[col + e]);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(y[0], y[1]);
      }
    }
  }
}

}  // namespace

// a [M, K] bf16; w1q [K, N1] s8, w1s and b1 [N1] f32; w2q [N1, N2] s8, w2s and
// b2 [N2] f32.  Scratch: aq [M, K] s8, s [M] f32, g [M, N1] bf16, rowmax
// [M, n_slabs] s32, gq [M, N1] s8, gs [M, n_slabs] f32.  Output: out [M, N2]
// bf16.  Needs K % 64 == 0, N1 = n_slabs * slab with slab % 128 == 0, and
// N2 % 128 == 0 (the wrapper checks).
extern "C" int int8_mlp(const void* a, const void* w1q, const void* w1s, const void* b1,
                        const void* w2q, const void* w2s, const void* b2, void* aq, void* s,
                        void* g, void* rowmax, void* gq, void* gs, void* out, int M, int K,
                        int N1, int N2, int n_slabs, int gelu_impl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int slab = N1 / n_slabs;
  quant_rows_rcp<<<(M + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)a, (int8_t*)aq, (float*)s,
                                              (int*)rowmax, n_slabs, M, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto gemm1 = gelu_impl == 1 ? gemm_gelu_slabs<1>
               : gelu_impl == 2 ? gemm_gelu_slabs<2> : gemm_gelu_slabs<0>;
  gemm1<<<dim3(N1 / BN, (M + BM - 1) / BM), 128, 0, st>>>(
      (const int8_t*)aq, (const int8_t*)w1q, (const float*)w1s, (const float*)b1,
      (const float*)s, (__nv_bfloat16*)g, (int*)rowmax, slab, n_slabs, M, K, N1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  requant_slabs<<<M, 256, 0, st>>>((const __nv_bfloat16*)g, (const int*)rowmax, (int8_t*)gq,
                                   (float*)gs, slab, n_slabs, N1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gemm_slabs_dequant<<<dim3(N2 / BN, (M + BM - 1) / BM), 128, 0, st>>>(
      (const int8_t*)gq, (const int8_t*)w2q, (const float*)gs, (const float*)w2s,
      (const float*)b2, (__nv_bfloat16*)out, slab, n_slabs, M, N2);
  return cudaGetLastError();
}
