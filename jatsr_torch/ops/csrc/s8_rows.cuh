// Per-row int8 quantisation of a bf16 activation, in front of the s8 wgmma
// GEMMs of s8_wgmma.cuh: B4 and B14 (w8a8_fused.cu), B5
// (dense_gelu_quant.cu), B12's out projection (flash_qkv.cu,
// attention_wide.cu) and B13 (mlp_full.cu).  Each csrc/*.cu that includes
// this file is built into its own shared library, so everything here lives
// in an anonymous namespace.
//
//   s    = max(max|a_row| * INV127, 1e-12)        the floored scale
//   a_q  = rint(a / s)                            B4, B5, B12, B14: a true divide
//   a_q  = rint(a * (1 / s))                      B13: a reciprocal multiply
// Both round half to even.  The scale written is s, but for B14's
// (w8a8_dot(impl="pallas")): the unfloored max|a_row| * INV127, which its
// GEMM rescales by, as the JAX package's w8a8_dot does (the RAW forms).
// One warp a row; V 16-byte vectors a lane (K <= 256 V), all loaded at once
// and kept in registers between the max and the codes, so the row is read
// once with every load of a lane in flight together.  The kernel's first
// instruction lets the next launch start (griddepcontrol): the GEMM behind
// it waits only where it reads a_q and s.

#pragma once

#include "int8_gemm.cuh"
#include "s8_wgmma.cuh"

namespace {

// Eight int8 codes of v * rcp, packed little-endian into two words.
__device__ __forceinline__ uint2 quant8_rcp(const float v[8], float rcp) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = __float2int_rn(__fmul_rn(v[i], rcp));
    w[i >> 2] |= (uint32_t)(q & 0xff) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

template <int V, bool RCP, bool RAW = false>
__device__ __forceinline__ void quant_row_v(const __nv_bfloat16* __restrict__ a,
                                            int8_t* __restrict__ aq, float* __restrict__ s,
                                            int M, int K) {
  griddep_launch();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const __nv_bfloat16* ar = a + (size_t)row * K;
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = (i * 32 + lane) * 8;
    v[i] = k < K ? __ldg(reinterpret_cast<const uint4*>(ar + k)) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
  amax = warp_max(amax);
  const float sc = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  const float rcp = RCP ? __fdiv_rn(1.0f, sc) : 0.f;
  int8_t* qr = aq + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k >= K) continue;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
    *reinterpret_cast<uint2*>(qr + k) = RCP ? quant8_rcp(f, rcp) : quant8(f, sc);
  }
  if (lane == 0) s[row] = RAW ? __fmul_rn(amax, INV127) : sc;
}

// The divide form (B4, B5, B12).  The codes are quant8's: rint(a / s).
template <int V>
__global__ void __launch_bounds__(256) quant_rows_v(const __nv_bfloat16* __restrict__ a,
                                                    int8_t* __restrict__ aq,
                                                    float* __restrict__ s, int M, int K) {
  quant_row_v<V, false>(a, aq, s, M, K);
}

// The divide form with the unfloored scale (B14).
template <int V>
__global__ void __launch_bounds__(256) quant_rows_raw_v(const __nv_bfloat16* __restrict__ a,
                                                        int8_t* __restrict__ aq,
                                                        float* __restrict__ s, int M, int K) {
  quant_row_v<V, false, true>(a, aq, s, M, K);
}

// The reciprocal form (B13).
template <int V>
__global__ void __launch_bounds__(256) quant_rows_rcp_v(const __nv_bfloat16* __restrict__ a,
                                                        int8_t* __restrict__ aq,
                                                        float* __restrict__ s, int M, int K) {
  quant_row_v<V, true>(a, aq, s, M, K);
}

// A wide row (the patch embed's 8192) a CTA of 256 threads, V 16-byte
// vectors a thread (K <= 2048 V), the row max through shared memory: eight
// warps a row keep more loads and divides in flight than one.  The divide
// form.
template <int V, bool RAW>
__device__ __forceinline__ void quant_row_block(const __nv_bfloat16* __restrict__ a,
                                                int8_t* __restrict__ aq, float* __restrict__ s,
                                                int K) {
  griddep_launch();
  __shared__ float part[8];
  const int row = blockIdx.x;
  const __nv_bfloat16* ar = a + (size_t)row * K;
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = (i * 256 + threadIdx.x) * 8;
    v[i] = k < K ? __ldg(reinterpret_cast<const uint4*>(ar + k)) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < 8; ++w) amax = fmaxf(amax, part[w]);
  const float sc = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  int8_t* qr = aq + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = (i * 256 + threadIdx.x) * 8;
    if (k >= K) continue;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
    *reinterpret_cast<uint2*>(qr + k) = quant8(f, sc);
  }
  if (threadIdx.x == 0) s[row] = RAW ? __fmul_rn(amax, INV127) : sc;
}

template <int V>
__global__ void __launch_bounds__(256) quant_rows_block(const __nv_bfloat16* __restrict__ a,
                                                        int8_t* __restrict__ aq,
                                                        float* __restrict__ s, int K) {
  quant_row_block<V, false>(a, aq, s, K);
}

template <int V>
__global__ void __launch_bounds__(256) quant_rows_block_raw(const __nv_bfloat16* __restrict__ a,
                                                            int8_t* __restrict__ aq,
                                                            float* __restrict__ s, int K) {
  quant_row_block<V, true>(a, aq, s, K);
}

// int8_gemm.cuh's two reads of a row, with the unfloored scale (B14 past K
// = 8192).
__global__ void quant_rows_raw(const __nv_bfloat16* __restrict__ a, int8_t* __restrict__ aq,
                               float* __restrict__ s, int M, int K) {
  quant_row_twice<true>(a, aq, s, nullptr, M, K);
}

// ---- B4's fp32 mode: the divide form on fp32 rows ---------------------------
// w8a8_dot(impl="fused") with an fp32 lhs.  The same floored scale and codes
// as quant_rows_v's, on values that need no widening: each lane's groups of
// eight, two 16-byte loads each.  Templates, so that only w8a8_fused.cu
// builds them.

__device__ __forceinline__ float absmax8(const float4& x, const float4& y) {
  return fmaxf(fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))),
               fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)), fmaxf(fabsf(y.z), fabsf(y.w))));
}

__device__ __forceinline__ uint2 quant8_f32(const float4& x, const float4& y, float sc) {
  const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  return quant8(f, sc);
}

// One warp a row, the row in registers (V groups a lane: K <= 256 V).  RCP:
// B13's reciprocal form (its fp32 mode), rint(a * (1 / s)).
template <int V, bool RCP = false>
__global__ void __launch_bounds__(256) quant_rows_f32_v(const float* __restrict__ a,
                                                        int8_t* __restrict__ aq,
                                                        float* __restrict__ s, int M, int K) {
  griddep_launch();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* ar = reinterpret_cast<const float4*>(a + (size_t)row * K);
  float4 v[2 * V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = (i * 32 + lane) * 8;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    v[2 * i] = k < K ? __ldg(ar + k / 4) : z;
    v[2 * i + 1] = k < K ? __ldg(ar + k / 4 + 1) : z;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) amax = fmaxf(amax, absmax8(v[2 * i], v[2 * i + 1]));
  amax = warp_max(amax);
  const float sc = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  const float rcp = RCP ? __fdiv_rn(1.0f, sc) : 0.f;
  int8_t* qr = aq + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k >= K) continue;
    if constexpr (RCP) {
      const float4 x = v[2 * i], y = v[2 * i + 1];
      const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      *reinterpret_cast<uint2*>(qr + k) = quant8_rcp(f, rcp);
    } else {
      *reinterpret_cast<uint2*>(qr + k) = quant8_f32(v[2 * i], v[2 * i + 1], sc);
    }
  }
  if (lane == 0) s[row] = sc;
}

// One warp a row of any length, read twice (the second read from L1 or L2).
template <int UNUSED = 0>
__global__ void __launch_bounds__(256) quant_rows_f32_twice(const float* __restrict__ a,
                                                            int8_t* __restrict__ aq,
                                                            float* __restrict__ s, int M,
                                                            int K) {
  griddep_launch();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* ar = reinterpret_cast<const float4*>(a + (size_t)row * K);
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 256)
    amax = fmaxf(amax, absmax8(__ldg(ar + k / 4), __ldg(ar + k / 4 + 1)));
  amax = warp_max(amax);
  const float sc = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  int8_t* qr = aq + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256)
    *reinterpret_cast<uint2*>(qr + k) = quant8_f32(__ldg(ar + k / 4), __ldg(ar + k / 4 + 1), sc);
  if (lane == 0) s[row] = sc;
}

// a [M, K] fp32 -> aq [M, K] s8, s [M] f32 (the floored scales), for any K %
// 8 == 0 (16-byte aligned rows): the row in registers up to K = 2048, read
// twice past it.  The reciprocal form (RCP, B13) up to K = 4096, the row in
// registers (the caller checks).  Its first instruction lets the next
// launch start.
template <bool RCP = false>
cudaError_t launch_quant_rows_f32(const void* a, void* aq, void* s, int M, int K,
                                  cudaStream_t st) {
  const dim3 grid((M + 7) / 8), block(256);
  auto A = (const float*)a;
  auto Q = (int8_t*)aq;
  auto S = (float*)s;
  if constexpr (RCP) {
    if (K <= 2048)
      quant_rows_f32_v<8, true><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else if (K <= 4096)
      quant_rows_f32_v<16, true><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else
      return cudaErrorInvalidValue;
  } else if (K <= 2048)
    quant_rows_f32_v<8><<<grid, block, 0, st>>>(A, Q, S, M, K);
  else
    quant_rows_f32_twice<><<<grid, block, 0, st>>>(A, Q, S, M, K);
  return cudaGetLastError();
}

// Launches the divide form (RCP false) for any K % 8 == 0: up to 4096 a
// warp a row, the row in its registers; up to 8192 (the patch embed's K) a
// CTA a row; past that int8_gemm.cuh's two reads (which do not start the
// next launch early).  RAW writes the unfloored scale (B14).  The
// reciprocal form (RCP) up to K = 4096 (the caller checks).  A template, so
// that a library builds only the kernels it launches.
template <bool RCP, bool RAW = false>
cudaError_t launch_quant_rows(const void* a, void* aq, void* s, int M, int K, cudaStream_t st) {
  static_assert(!(RCP && RAW), "B13's reciprocal form floors its scale");
  const dim3 grid((M + 7) / 8), block(256);
  auto A = (const __nv_bfloat16*)a;
  auto Q = (int8_t*)aq;
  auto S = (float*)s;
  if constexpr (RCP) {
    if (K <= 2048)
      quant_rows_rcp_v<8><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else if (K <= 4096)
      quant_rows_rcp_v<16><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else
      return cudaErrorInvalidValue;
  } else if constexpr (RAW) {
    if (K <= 2048)
      quant_rows_raw_v<8><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else if (K <= 4096)
      quant_rows_raw_v<16><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else if (K <= 8192)
      quant_rows_block_raw<4><<<M, block, 0, st>>>(A, Q, S, K);
    else
      quant_rows_raw<<<grid, block, 0, st>>>(A, Q, S, M, K);
  } else {
    if (K <= 2048)
      quant_rows_v<8><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else if (K <= 4096)
      quant_rows_v<16><<<grid, block, 0, st>>>(A, Q, S, M, K);
    else if (K <= 8192)
      quant_rows_block<4><<<M, block, 0, st>>>(A, Q, S, K);
    else
      quant_rows<<<grid, block, 0, st>>>(A, Q, S, nullptr, M, K);
  }
  return cudaGetLastError();
}

}  // namespace
