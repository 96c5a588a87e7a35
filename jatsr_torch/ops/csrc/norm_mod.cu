// Fused norm + AdaLN modulate + row quantisation in front of the s8 GEMM,
// for Hopper: the serving DiT block's qkv projection and MLP first half.
//
// Replaces two TPU kernels of the JAX package's ops/int8_matmul.py:
//   int8_norm_mod_dot (_norm_mod_dot_kernel): the qkv projection,
//     out = bf16(((float)acc * s) * ws + b)
//   int8_norm_mod_dense_gelu_quant (_norm_mod_gelu_kernel): mlp_in,
//     g = gelu(((float)acc * s) * ws + b) in fp32, then int8 codes over the
//     whole 4H row, as int8_dense_gelu_quant's fast epilogue.
// Both start from the raw bf16 residual stream x and one sample's AdaLN
// (scale, shift) rows, with _norm_mod's rounding points:
//   stats  fp32: mean(x), mean(x*x) (true divides by H)
//   rms    xn = x * (1 / sqrt(mean(x*x) + 1e-6))
//   layer  xn = (x - mu) * (1 / sqrt(mean(x*x) - mu*mu + 1e-6))  (no clamp)
//   y      = b16(b16(b16(xn) * b16(1 + scale)) + shift)
//   s      = max(max|y_row| * INV127, 1e-12);  a_q = rint(y / s)
// 1/sqrt is two correctly rounded operations, as the plain version's
// 1 / torch.sqrt; XLA's rsqrt on the CPU may differ from it in the last
// bit, which can move a code by one (the tests state that tolerance).
//
// What bounds it on the H100, at the serving shape (x [6, 352, 1280]):
// the qkv product (N = 1792) is 9.69 G int8 operations, 4.90 us at the
// 1979 TOP/s peak, against 15.3 MB of compulsory traffic (4.56 us at
// 3.35 TB/s); mlp_in (N = 5120) is 27.7 G operations (14.0 us) against
// 22.8 MB (6.8 us).  The tensor cores bound both.
//
// Design.  The TPU grid is (batch, row block) so that a block never spans
// two samples.  Here the rows are M = B * Np, and the prologue computes
// each row's sample as row / Np; the modulation rows have an explicit batch
// stride, 0 for the sampler's shared [1, H] row, H for [B, H].
//   1. norm_mod_quant: one warp per row; three passes over the row (stats,
//      absmax of y, codes), recomputing y, with x read from L1/L2.
//   2. the s8 GEMM of int8_gemm.cuh with the dequant + bias epilogue (qkv),
//      or with the GELU epilogue and the whole-row requant (mlp_in).
// The int8 rows go through device memory between the passes; keeping a
// CTA's rows in shared memory is a later version's work.

#include "int8_gemm.cuh"

namespace {

template <bool RMS>
__global__ void norm_mod_quant(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ scale,
                               const float* __restrict__ shift, int mod_stride,
                               int rows_per_sample, int8_t* __restrict__ aq,
                               float* __restrict__ s, int* __restrict__ rowmax,
                               int M, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * H;
  const size_t sample = (size_t)(row / rows_per_sample);
  const float* sc = scale + sample * mod_stride;
  const float* sh = shift + sample * mod_stride;

  auto load8 = [&](int k, float f[8]) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
  };

  float s1 = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < H; k += 256) {
    float f[8];
    load8(k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1 = __fadd_rn(s1, f[i]);
      s2 = __fadd_rn(s2, __fmul_rn(f[i], f[i]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
  }
  const float hf = (float)H;
  const float ms = __fdiv_rn(s2, hf);
  const float mu = RMS ? 0.f : __fdiv_rn(s1, hf);
  const float var = RMS ? ms : __fadd_rn(ms, -__fmul_rn(mu, mu));
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));

  auto norm_mod8 = [&](int k, float y[8]) {
    load8(k, y);
    const float4 a0 = *reinterpret_cast<const float4*>(sc + k);
    const float4 a1 = *reinterpret_cast<const float4*>(sc + k + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sh + k);
    const float4 b1 = *reinterpret_cast<const float4*>(sh + k + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xn = RMS ? __fmul_rn(y[i], r) : __fmul_rn(__fadd_rn(y[i], -mu), r);
      const float m = bf16r(__fmul_rn(bf16r(xn), bf16r(__fadd_rn(1.0f, a[i]))));
      y[i] = bf16r(__fadd_rn(m, b[i]));
    }
  };

  float amax = 0.f;
  for (int k = lane * 8; k < H; k += 256) {
    float y[8];
    norm_mod8(k, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(y[i]));
  }
  amax = warp_max(amax);
  const float q = fmaxf(__fmul_rn(amax, INV127), 1e-12f);
  int8_t* qr = aq + (size_t)row * H;
  for (int k = lane * 8; k < H; k += 256) {
    float y[8];
    norm_mod8(k, y);
    *reinterpret_cast<uint2*>(qr + k) = quant8(y, q);
  }
  if (lane == 0) {
    s[row] = q;
    if (rowmax) rowmax[row] = 0;
  }
}

cudaError_t launch_prologue(const void* x, const void* scale, const void* shift,
                            int mod_stride, int np, void* aq, void* s, void* rowmax,
                            int M, int H, int rms, cudaStream_t st) {
  const dim3 grid((M + 7) / 8), block(256);
  auto X = (const __nv_bfloat16*)x;
  auto SC = (const float*)scale;
  auto SH = (const float*)shift;
  if (rms)
    norm_mod_quant<true><<<grid, block, 0, st>>>(X, SC, SH, mod_stride, np, (int8_t*)aq,
                                                 (float*)s, (int*)rowmax, M, H);
  else
    norm_mod_quant<false><<<grid, block, 0, st>>>(X, SC, SH, mod_stride, np, (int8_t*)aq,
                                                  (float*)s, (int*)rowmax, M, H);
  return cudaGetLastError();
}

}  // namespace

// x [M = B*np, H] bf16; scale, shift [B or 1, H] f32 with row stride
// mod_stride (0 or H); wq [H, N] s8; ws, bias [N] f32.  Scratch: aq [M, H]
// s8, s [M] f32.  Output: out [M, N] bf16.  Needs H % 64 == 0, N % 128 == 0.
extern "C" int norm_mod_dot(const void* x, const void* scale, const void* shift,
                            int mod_stride, const void* wq, const void* ws,
                            const void* bias, void* aq, void* s, void* out, int M,
                            int np, int H, int N, int rms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_prologue(x, scale, shift, mod_stride, np, aq, s, nullptr, M,
                                  H, rms, st);
  if (e != cudaSuccess) return e;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_dequant<true><<<grid, 128, 0, st>>>((const int8_t*)aq, (const int8_t*)wq,
                                           (const float*)ws, (const float*)bias,
                                           (const float*)s, (__nv_bfloat16*)out, M, H, N);
  return cudaGetLastError();
}

// As norm_mod_dot, with the GELU epilogue (fp32) and the whole-row requant.
// Scratch: aq [M, H] s8, s [M] f32, g [M, N] f32, rowmax [M] s32.  Outputs:
// gq [M, N] s8, gs [M] f32.
extern "C" int norm_mod_dense_gelu_quant(const void* x, const void* scale,
                                         const void* shift, int mod_stride,
                                         const void* wq, const void* ws,
                                         const void* bias, void* aq, void* s, void* g,
                                         void* rowmax, void* gq, void* gs, int M,
                                         int np, int H, int N, int rms, int gelu_impl,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_prologue(x, scale, shift, mod_stride, np, aq, s, rowmax, M,
                                  H, rms, st);
  if (e != cudaSuccess) return e;
  launch_gemm_gelu(gelu_impl, true, st, (const int8_t*)aq, (const int8_t*)wq,
                   (const float*)ws, (const float*)bias, (const float*)s, (float*)g,
                   (int*)rowmax, M, H, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  requant<<<M, 256, 0, st>>>((const float*)g, (const int*)rowmax, (int8_t*)gq,
                             (float*)gs, N);
  return cudaGetLastError();
}
