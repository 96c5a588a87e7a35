// Fused norm + AdaLN modulate + row quantisation in front of the s8 GEMM,
// for Hopper: the serving DiT block's qkv projection and MLP first half.
//
// Replaces two TPU kernels of the JAX package's ops/int8_matmul.py:
//   int8_norm_mod_dot (_norm_mod_dot_kernel): the qkv projection,
//     out = bf16(((float)acc * s) * ws + b)
//   int8_norm_mod_dense_gelu_quant (_norm_mod_gelu_kernel): mlp_in,
//     g = gelu(((float)acc * s) * ws + b) in fp32, then int8 codes over the
//     whole 4H row, as int8_dense_gelu_quant's fast epilogue.
// Both start from the raw residual stream x (bf16; fp32 in the fp32 mode,
// the JAX model's at dtype="float32") and one sample's AdaLN (scale, shift)
// rows, with _norm_mod's rounding points, the same in either mode:
//   stats  fp32: mean(x), mean(x*x) (true divides by H)
//   rms    xn = x * (1 / sqrt(mean(x*x) + 1e-6))
//   layer  xn = (x - mu) * (1 / sqrt(mean(x*x) - mu*mu + 1e-6))  (no clamp)
//   y      = b16(b16(b16(xn) * b16(1 + scale)) + shift)
//   s      = max(max|y_row| * INV127, 1e-12);  a_q = rint(y / s)
// 1/sqrt is two correctly rounded operations, as the plain version's
// 1 / torch.sqrt; XLA's rsqrt on the CPU may differ from it in the last
// bit, which can move a code by one (the tests state that tolerance).
// Then acc = a_q @ w_q in int32 (exact), y = ((float)acc * s) * ws + b with
// no FMA contraction, and for mlp_in g = gelu(y) in fp32 (int8_gemm.cuh's
// forms), gs = max(max|g_row| * INV127, 1e-12) over the whole row, codes
// rint(g / gs).
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
//      absmax of y, codes), recomputing y, with x read from L1/L2 (fp32 x:
//      the same, from two 16-byte loads of four values each); it
//      writes a_q [M, H] s8 and s (2.7 MB: ~1.6 us of traffic, a launch of
//      its own).
//   2. the s8 GEMM of s8_wgmma.cuh (wgmma fed by TMA, 128 x 128 tiles) on
//      a_q and the K-major weight [N, H]:
//      qkv (B3): the dequant + bias epilogue straight to bf16 (the fp32
//      mode writes fp32, its out_dtype, through s8_dequant.cuh's fp32
//      instance with the bias: the same operations, one rounding);
//      mlp_in (B1): s8_gelu.cuh's two passes of the products, so that the
//      fp32 g never goes through device memory.  Pass 1 computes each
//      tile's g and writes its rows' max |g| (a [M, N / 128] fp32 partial,
//      no atomics); pass 2 recomputes g (the same instructions, so the same
//      bits), takes its rows' exact max over the partials and writes the s8
//      codes and gs (the pass is shared with B5).  The tensor work doubles
//      (28 us at the int8 peak) and the 43 MB
//      g round trip of the mma.sync version (written, then read back by a
//      requant launch) is gone.  A cluster spanning a whole row, with the
//      maxima exchanged through distributed shared memory, would run the
//      products once; it is not built (PERF.md says why).

#include <type_traits>

#include "s8_dequant.cuh"
#include "s8_gelu.cuh"
#include "s8_split.cuh"

namespace {

// F32 (the fp32 mode, last so that the bf16 instances keep their names but
// for the flag): x is fp32, read as two 16-byte loads of four values; the
// statistics, roundings and codes are the same.
template <bool RMS, bool F32 = false>
__global__ void norm_mod_quant(const std::conditional_t<F32, float, __nv_bfloat16>* __restrict__ x,
                               const float* __restrict__ scale,
                               const float* __restrict__ shift, int mod_stride,
                               int rows_per_sample, int8_t* __restrict__ aq,
                               float* __restrict__ s, int M, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  const auto* xr = x + (size_t)row * H;
  const size_t sample = (size_t)(row / rows_per_sample);
  const float* sc = scale + sample * mod_stride;
  const float* sh = shift + sample * mod_stride;

  auto load8 = [&](int k, float f[8]) {
    if constexpr (F32) {
      const float4 a = *reinterpret_cast<const float4*>(xr + k);
      const float4 b = *reinterpret_cast<const float4*>(xr + k + 4);
      f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
      f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
    } else {
      uint4 v = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
    }
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
  if (lane == 0) s[row] = q;
}

template <bool F32>
void launch_prologue_t(const void* x, const float* sc, const float* sh, int mod_stride, int np,
                       void* aq, void* s, int M, int H, int rms, cudaStream_t st) {
  const dim3 grid((M + 7) / 8), block(256);
  auto X = (const std::conditional_t<F32, float, __nv_bfloat16>*)x;
  if (rms)
    norm_mod_quant<true, F32><<<grid, block, 0, st>>>(X, sc, sh, mod_stride, np, (int8_t*)aq,
                                                      (float*)s, M, H);
  else
    norm_mod_quant<false, F32><<<grid, block, 0, st>>>(X, sc, sh, mod_stride, np, (int8_t*)aq,
                                                       (float*)s, M, H);
}

// x bf16, or fp32 with x_f32.
cudaError_t launch_prologue(const void* x, const void* scale, const void* shift,
                            int mod_stride, int np, void* aq, void* s, int M, int H,
                            int rms, cudaStream_t st, int x_f32 = 0) {
  auto SC = (const float*)scale;
  auto SH = (const float*)shift;
  if (x_f32)
    launch_prologue_t<true>(x, SC, SH, mod_stride, np, aq, s, M, H, rms, st);
  else
    launch_prologue_t<false>(x, SC, SH, mod_stride, np, aq, s, M, H, rms, st);
  return cudaGetLastError();
}


// B3's GEMM: out = bf16(((float)acc * s) * ws + b).  Needs N % 128 == 0.
__global__ void __launch_bounds__(S8_THREADS, 2) s8_dot_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  const int n0 = blockIdx.x * S8_BN, m0 = blockIdx.y * S8_BM;
  s8_gemm_tile(
      K / S8_BK,
      [&](int kb, unsigned char* a, unsigned char* b, uint64_t* bar) {
        tma_load_2d(a, &am, bar, kb * S8_BK, m0);
        tma_load_2d(b, &bm, bar, kb * S8_BK, n0);
      },
      [](int, int) {},
      [&](const int (&acc)[S8_ACC], int row, int col, unsigned char* stage) {
        // The tile in bf16 through shared memory (rows of 272 bytes: the
        // 8 rows of a store hit distinct banks), then 16-byte stores.
        constexpr int STR = S8_BN * 2 + 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          const float sr = r < M ? s[r] : 0.f;
#pragma unroll
          for (int i = 0; i < S8_BN / 8; ++i) {
            const int c = n0 + 8 * i + col;
            const float2 w = *reinterpret_cast<const float2*>(ws + c);
            const float2 bb = *reinterpret_cast<const float2*>(bias + c);
            const float y0 =
                __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), sr), w.x), bb.x);
            const float y1 =
                __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), sr), w.y), bb.y);
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

// B1's GEMM, pass PASS of two (s8_gelu.cuh): g = gelu(((float)acc * s) *
// ws + b) in fp32; pass 1 writes each tile's row maxima to part, pass 2 the
// codes rint(g / gs) and gs.  Needs N % 128 == 0.
template <int GELU, int PASS>
__global__ void __launch_bounds__(S8_THREADS, 2) s8_gelu_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, const float* __restrict__ bias,
    float* __restrict__ part, int8_t* __restrict__ gq, float* __restrict__ gs, int M, int K,
    int N) {
  s8_gelu_tile<GELU, PASS, false, false>(am, bm, s, ws, bias, part, gq, gs, M, K, N);
}

template <class Kernel>
cudaError_t s8_smem(Kernel kernel, int& set) {
  if (set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S8_SMEM);
  if (e == cudaSuccess) set = 1;
  return e;
}

cudaError_t launch_dot(const void* aq, const void* s, const void* wt, const void* ws,
                       const void* bias, void* out, int M, int K, int N, cudaStream_t st) {
  CUtensorMap am, bm;
  cudaError_t e = s8_maps(&am, &bm, aq, wt, M, K, N);
  if (e != cudaSuccess) return e;
  static int set = 0;
  e = s8_smem(s8_dot_kernel, set);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + S8_BN - 1) / S8_BN, (M + S8_BM - 1) / S8_BM);
  s8_dot_kernel<<<grid, S8_THREADS, S8_SMEM, st>>>(am, bm, (const float*)s, (const float*)ws,
                                                   (const float*)bias, (__nv_bfloat16*)out, M, K,
                                                   N);
  return cudaGetLastError();
}

template <int GELU, int PASS>
cudaError_t launch_gelu_pass(const CUtensorMap& am, const CUtensorMap& bm, const void* s,
                             const void* ws, const void* bias, void* part, void* gq, void* gs,
                             int M, int K, int N, cudaStream_t st) {
  static int set = 0;
  const cudaError_t e = s8_smem(s8_gelu_kernel<GELU, PASS>, set);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + S8_BN - 1) / S8_BN, (M + S8_BM - 1) / S8_BM);
  s8_gelu_kernel<GELU, PASS><<<grid, S8_THREADS, S8_SMEM, st>>>(
      am, bm, (const float*)s, (const float*)ws, (const float*)bias, (float*)part, (int8_t*)gq,
      (float*)gs, M, K, N);
  return cudaGetLastError();
}

template <int GELU>
cudaError_t launch_gelu_t(const CUtensorMap& am, const CUtensorMap& bm, const void* s,
                          const void* ws, const void* bias, void* part, void* gq, void* gs, int M,
                          int K, int N, int passes, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  if (passes & 1) e = launch_gelu_pass<GELU, 1>(am, bm, s, ws, bias, part, gq, gs, M, K, N, st);
  if (e == cudaSuccess && (passes & 2))
    e = launch_gelu_pass<GELU, 2>(am, bm, s, ws, bias, part, gq, gs, M, K, N, st);
  return e;
}

cudaError_t launch_gelu(const void* aq, const void* s, const void* wt, const void* ws,
                        const void* bias, void* part, void* gq, void* gs, int M, int K, int N,
                        int gelu_impl, int passes, cudaStream_t st) {
  CUtensorMap am, bm;
  const cudaError_t e = s8_maps(&am, &bm, aq, wt, M, K, N);
  if (e != cudaSuccess) return e;
  if (gelu_impl == 1)
    return launch_gelu_t<1>(am, bm, s, ws, bias, part, gq, gs, M, K, N, passes, st);
  if (gelu_impl == 2)
    return launch_gelu_t<2>(am, bm, s, ws, bias, part, gq, gs, M, K, N, passes, st);
  return launch_gelu_t<0>(am, bm, s, ws, bias, part, gq, gs, M, K, N, passes, st);
}

}  // namespace

// The prologue alone: x [M = B*np, H] bf16; scale, shift [B or 1, H] f32
// with row stride mod_stride (0 or H) -> aq [M, H] s8, s [M] f32.
extern "C" int norm_mod_prologue(const void* x, const void* scale, const void* shift,
                                 int mod_stride, int np, void* aq, void* s, int M, int H, int rms,
                                 void* stream) {
  return launch_prologue(x, scale, shift, mod_stride, np, aq, s, M, H, rms,
                         (cudaStream_t)stream);
}

// B3's GEMM alone on a prologue's aq [M, K] s8 and s [M] f32: wt [N, K] s8
// (the weight K-major); ws, bias [N] f32 -> out [M, N] bf16.  Needs
// K % 128 == 0 and N % 128 == 0.
extern "C" int s8_dot(const void* aq, const void* s, const void* wt, const void* ws,
                      const void* bias, void* out, int M, int K, int N, void* stream) {
  return launch_dot(aq, s, wt, ws, bias, out, M, K, N, (cudaStream_t)stream);
}

// B1's GEMM alone on a prologue's aq and s: wt, ws, bias as s8_dot; part
// [M, ceil(N / 128)] f32 scratch -> gq [M, N] s8, gs [M] f32.  `passes`: 1
// the row maxima, 2 the codes (on part from pass 1), 3 both.
extern "C" int s8_gelu_quant(const void* aq, const void* s, const void* wt, const void* ws,
                             const void* bias, void* part, void* gq, void* gs, int M, int K,
                             int N, int gelu_impl, int passes, void* stream) {
  return launch_gelu(aq, s, wt, ws, bias, part, gq, gs, M, K, N, gelu_impl, passes,
                     (cudaStream_t)stream);
}

// x [M = B*np, H] bf16, or (x_f32) fp32; scale, shift [B or 1, H] f32 with
// row stride mod_stride (0 or H); wt [N, H] s8 (the weight K-major); ws,
// bias [N] f32.  Scratch: aq [M, H] s8, s [M] f32.  Output: out [M, N] bf16,
// or (out_f32) fp32.  Needs H % 128 == 0, N % 128 == 0.  Two launches.  The
// fp32 mode's GEMM is s8_dequant.cuh's fp32 instance with the bias (the
// same y = ((float)acc * s) * ws + b, one rounding to fp32), behind the
// fp32 prologue.
extern "C" int norm_mod_dot_dt(const void* x, const void* scale, const void* shift,
                               int mod_stride, const void* wt, const void* ws,
                               const void* bias, void* aq, void* s, void* out, int M,
                               int np, int H, int N, int rms, int x_f32, int out_f32,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_prologue(x, scale, shift, mod_stride, np, aq, s, M, H, rms, st, x_f32);
  if (e != cudaSuccess) return e;
  if (out_f32) return s8_dequant<true, float>(aq, s, wt, ws, bias, out, M, H, N, false, st);
  return launch_dot(aq, s, wt, ws, bias, out, M, H, N, st);
}

// B3 in bf16 (tools/torch_prologue_split.py calls it in this tree and its
// parents').
extern "C" int norm_mod_dot(const void* x, const void* scale, const void* shift,
                            int mod_stride, const void* wt, const void* ws,
                            const void* bias, void* aq, void* s, void* out, int M,
                            int np, int H, int N, int rms, void* stream) {
  return norm_mod_dot_dt(x, scale, shift, mod_stride, wt, ws, bias, aq, s, out, M, np, H, N, rms,
                         0, 0, stream);
}

// As norm_mod_dot, with the GELU epilogue (fp32) and the whole-row requant;
// x bf16, or (x_f32) fp32.  Scratch: aq [M, H] s8, s [M] f32, part [M, N /
// 128] f32.  Outputs: gq [M, N] s8, gs [M] f32.  Three launches: the
// prologue, the two passes.
extern "C" int norm_mod_dense_gelu_quant_dt(const void* x, const void* scale,
                                            const void* shift, int mod_stride,
                                            const void* wt, const void* ws,
                                            const void* bias, void* aq, void* s, void* part,
                                            void* gq, void* gs, int M, int np, int H, int N,
                                            int rms, int gelu_impl, int x_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_prologue(x, scale, shift, mod_stride, np, aq, s, M, H, rms, st, x_f32);
  if (e != cudaSuccess) return e;
  return launch_gelu(aq, s, wt, ws, bias, part, gq, gs, M, H, N, gelu_impl, 3, st);
}

// B1 in bf16 (tools/torch_prologue_split.py).
extern "C" int norm_mod_dense_gelu_quant(const void* x, const void* scale,
                                         const void* shift, int mod_stride,
                                         const void* wt, const void* ws,
                                         const void* bias, void* aq, void* s, void* part,
                                         void* gq, void* gs, int M, int np, int H, int N,
                                         int rms, int gelu_impl, void* stream) {
  return norm_mod_dense_gelu_quant_dt(x, scale, shift, mod_stride, wt, ws, bias, aq, s, part, gq,
                                      gs, M, np, H, N, rms, gelu_impl, 0, stream);
}

// ---- B1 column-parallel (tensor parallelism, s8_split.cuh) -----------------
// A rank's columns of mlp_in: wt [N, H] s8 is its N columns K-major, ws and
// bias its [N] f32.  Part 1: the prologue (bf16 x), pass 1 on the rank's
// columns and each row's max over its partials -> aq [M, H] s8, s [M] f32,
// part [M, N / 128] f32 and rm [M] f32: three launches.  The caller takes
// the max of rm over the ranks, then part 2: every partial of a row set to
// that max, then pass 2 -> gq [M, N] s8, gs [M] f32: two launches.
extern "C" int norm_mod_gelu_split1(const void* x, const void* scale, const void* shift,
                                    int mod_stride, const void* wt, const void* ws,
                                    const void* bias, void* aq, void* s, void* part, void* rm,
                                    int M, int np, int H, int N, int rms, int gelu_impl,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_prologue(x, scale, shift, mod_stride, np, aq, s, M, H, rms, st);
  if (e == cudaSuccess)
    e = launch_gelu(aq, s, wt, ws, bias, part, nullptr, nullptr, M, H, N, gelu_impl, 1, st);
  return e != cudaSuccess ? e : launch_rowmax_reduce(part, rm, M, N / S8_BN, st);
}

extern "C" int norm_mod_gelu_split2(const void* aq, const void* s, const void* wt,
                                    const void* ws, const void* bias, void* part, const void* rm,
                                    void* gq, void* gs, int M, int H, int N, int gelu_impl,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = launch_rowmax_fill(rm, part, M, N / S8_BN, st);
  return e != cudaSuccess
             ? e
             : launch_gelu(aq, s, wt, ws, bias, part, gq, gs, M, H, N, gelu_impl, 2, st);
}
