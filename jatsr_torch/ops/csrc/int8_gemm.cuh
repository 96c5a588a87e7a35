// The pieces the port's W8A8 kernels share: per-row int8 quantisation
// (the codes of eight values, a warp's row max, and quant_rows, which reads
// a row twice: s8_rows.cuh launches it past K = 8192) and the GELU forms
// that s8_gelu.cuh's wgmma epilogues evaluate.  Each csrc/*.cu that
// includes this file is built into its own shared library, so everything
// here lives in an anonymous namespace.
//
// Rounding points, as the JAX package's Pallas kernels have them:
//   s    = max(max|a_row| * INV127, 1e-12)        INV127 is a multiply
//   a_q  = rint(a / s)                            a true divide, half to even
// Every fp32 operation uses __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc
// cannot contract a multiply and an add into an FMA and move a rounding.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

constexpr float INV127 = 1.0f / 127.0f;  // == f32(1) / f32(127), rounded once

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight int8 codes of v / sc, packed little-endian into two words.
__device__ __forceinline__ uint2 quant8(const float v[8], float sc) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int q = __float2int_rn(__fdiv_rn(v[i], sc));
    w[i >> 2] |= (uint32_t)(q & 0xff) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- per-row int8 quantisation of bf16 A ------------------------------------
// One warp per row; two reads of the row.  rowmax (may be null) is zeroed.
// With RAW the scale written is the unfloored max|a_row| * INV127 (the codes
// still divide by the floored one): B14's quant, which w8a8_dot rescales by.
template <bool RAW>
__device__ __forceinline__ void quant_row_twice(const __nv_bfloat16* __restrict__ a,
                                                int8_t* __restrict__ aq, float* __restrict__ s,
                                                int* __restrict__ rowmax, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  const __nv_bfloat16* ar = a + (size_t)row * K;
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 256) {  // 8 bf16 = 16 bytes per load
    uint4 v = *reinterpret_cast<const uint4*>(ar + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  }
  amax = warp_max(amax);
  const float sc = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  int8_t* qr = aq + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(ar + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
    *reinterpret_cast<uint2*>(qr + k) = quant8(f, sc);
  }
  if (lane == 0) {
    s[row] = RAW ? __fmul_rn(amax, INV127) : sc;
    if (rowmax) rowmax[row] = 0;
  }
}

__global__ void quant_rows(const __nv_bfloat16* __restrict__ a,
                           int8_t* __restrict__ aq, float* __restrict__ s,
                           int* __restrict__ rowmax, int M, int K) {
  quant_row_twice<false>(a, aq, s, rowmax, M, K);
}

// ---- the GELU forms of the s8 wgmma epilogues (s8_gelu.cuh) ---------------------
__device__ __forceinline__ float a_s_erf(float x) {
  // Abramowitz-Stegun 7.1.26, in the order the JAX kernel evaluates it.
  float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  float ax = fabsf(x);
  float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  float e = expf(__fmul_rn(-ax, ax));
  return __fmul_rn(sign, __fadd_rn(1.0f, -__fmul_rn(p, e)));
}

template <int GELU>
__device__ __forceinline__ float gelu(float y) {
  if (GELU == 1) {  // erf
    float h = __fmul_rn(0.5f, y);
    return __fmul_rn(h, __fadd_rn(1.0f, a_s_erf(__fmul_rn(y, 0.70710678118654752f))));
  } else if (GELU == 2) {  // sigmoid
    float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, y))));
    return __fmul_rn(y, sg);
  }
  // tanh: 0.5*y*(1 + tanh(c*(y + 0.044715*y*y*y)))
  const float c = 0.79788456080286536f;  // sqrt(2/pi)
  float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  float inner = __fmul_rn(c, __fadd_rn(y, cube));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, tanhf(inner)));
}

}  // namespace
