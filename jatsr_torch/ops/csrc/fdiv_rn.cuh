// The correctly rounded fp32 quotient e / l without a call, for the
// attention kernels' softmax weights (attention_natural.cu, B15 and B16;
// attention_train.cu, B10's backward).
//
// __frcp_rn and __fdiv_rn branch to out-of-line slow paths, and a call in a
// kernel's inner loop made it spill.  Here: once per row y = rcp_rn(l)
// (the approximate reciprocal and one Newton step); per score q0 = e * y,
// r = fma(-l, q0, e), w = fma(r, y, q0) (Markstein's correction, the
// correctly rounded quotient while r stays exact: 2^-100 <= e <= 1 and
// 1 <= l <= 768); smaller non-zero e take a scaled form of the same, also
// inline.  Bit-equal to __fdiv_rn (tests/test_torch_cuda.py holds them on
// 2^24 pairs and on every fp32 l in [1, 768]).
#pragma once

#include <cuda_runtime.h>

// rcp_rn(l) for l in [1, 768]: the approximate reciprocal and one Newton
// step, r = 1 - l y exact.
__device__ __forceinline__ float reciprocal(float l) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(l));
  return __fmaf_rn(__fmaf_rn(-l, y, 1.f), y, y);
}

// e / l from y = rcp_rn(l) by Markstein's correction: the correctly
// rounded quotient where the residual is exact, e = 0 or 2^-100 <= e <= 1
// (l in [1, 768]).
__device__ __forceinline__ float markstein(float e, float l, float y) {
  const float q0 = __fmul_rn(e, y);
  return __fmaf_rn(__fmaf_rn(-l, q0, e), y, q0);
}

// A score whose markstein() may not be the rounded quotient.
__device__ __forceinline__ bool tiny(float e) { return e != 0.f && e < 0x1p-100f; }

// e / l, correctly rounded, for e in [0, 1], l in [1, 768] and
// y = rcp_rn(l), with no call (__fdiv_rn's slow path is one).
__device__ __forceinline__ float quotient(float e, float l, float y) {
  if (!tiny(e)) return markstein(e, l, y);
  // Rare: e < 2^-100.  The same on es = e 2^100 (exact), then scaled back:
  // exact where the quotient is normal; where it is subnormal, es / l is
  // rounded to a multiple of 2^-49 by the sign of the residual at the
  // midpoints beside the candidate c (each residual's sign is exact).
  const float es = __fmul_rn(e, 0x1p100f);
  const float qs = markstein(es, l, y);
  if (qs >= 0x1p-26f) return __fmul_rn(qs, 0x1p-100f);
  const float c = __fmul_rn(__fmul_rn(qs, 0x1p-100f), 0x1p100f);
  const bool odd = __float2int_rz(__fmul_rn(c, 0x1p49f)) & 1;
  const float hi = __fmaf_rn(-l, __fadd_rn(c, 0x1p-50f), es);
  const float lo = __fmaf_rn(-l, __fsub_rn(c, 0x1p-50f), es);
  float t = c;
  if (hi > 0.f || (hi == 0.f && odd)) t = __fadd_rn(c, 0x1p-49f);
  else if (lo < 0.f || (lo == 0.f && odd)) t = __fsub_rn(c, 0x1p-49f);
  return __fmul_rn(t, 0x1p-100f);
}
