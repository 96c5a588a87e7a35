// The pieces the port's W8A8 kernels share: per-row int8 quantisation, the
// mma.sync s8 GEMM tile loop with its dequant epilogue (to bf16, with or
// without a bias: B12's out projection and B14), and the GELU forms that
// s8_gelu.cuh's wgmma epilogues evaluate.  Each csrc/*.cu that includes this
// file is built into its own shared library, so everything here lives in an
// anonymous namespace.
//
// Rounding points, as the JAX package's Pallas kernels have them:
//   s    = max(max|a_row| * INV127, 1e-12)        INV127 is a multiply
//   a_q  = rint(a / s)                            a true divide, half to even
//   acc  = a_q @ w_q                              s8 x s8 -> s32, exact
//   y    = ((float)acc * s) * ws [+ b]            fp32, no FMA contraction
// Every fp32 operation uses __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc
// cannot contract a multiply and an add into an FMA and move a rounding.
//
// The GEMM: 64x128 output tiles, 4 warps of 32x64, mma.sync m16n8k32 s8
// (Hopper's wgmma and TMA are left to a later version).  The [K, N] weight
// is transposed to K-major in shared memory through a 4x4 byte transpose in
// registers; the next K slab is loaded into registers during the products.
// Needs K % 64 == 0 and N % 128 == 0; M is masked.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

constexpr float INV127 = 1.0f / 127.0f;  // == f32(1) / f32(127), rounded once
constexpr int BM = 64, BN = 128, BK = 64;
constexpr int SSTR = BK + 16;  // smem row stride in bytes: conflict-free

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
__global__ void quant_rows(const __nv_bfloat16* __restrict__ a,
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
    s[row] = sc;
    if (rowmax) rowmax[row] = 0;
  }
}

// ---- the s8 GEMM tile loop ---------------------------------------------------
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = aq[m0:m0+64, :K] @ wq[:K, n0:n0+128] for a CTA of 128 threads; lda
// is aq's row stride (K, or wider for a K slice of a wider A).  Warp w owns
// rows wm*32 .. +31 (wm = w >> 1) and columns wn*64 .. +63 (wn = w & 1);
// acc[mt][nt][half*2 + e] is row wm*32 + mt*16 + gid + half*8, column
// wn*64 + nt*8 + tig*2 + e (gid = lane >> 2, tig = lane & 3).
__device__ __forceinline__ void gemm_tile(const int8_t* __restrict__ aq, int lda,
                                          const int8_t* __restrict__ wq,
                                          int M, int K, int N, int m0, int n0,
                                          int8_t* As, int8_t* Wt, int acc[2][8][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  uint4 ra[2];        // A tile: 64 rows x 4 x 16 bytes, two per thread
  uint32_t rw[4][4];  // W tile: 16 x 32 blocks of 4x4 bytes, four per thread

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int idx = tid + 128 * i, row = idx >> 2, c = idx & 3;
      ra[i] = (m0 + row < M)
                  ? *reinterpret_cast<const uint4*>(aq + (size_t)(m0 + row) * lda + k0 + c * 16)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + 128 * i, kb = idx & 15, nb = idx >> 4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        rw[i][r] = *reinterpret_cast<const uint32_t*>(
            wq + (size_t)(k0 + kb * 4 + r) * N + n0 + nb * 4);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int idx = tid + 128 * i, row = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(As + row * SSTR + c * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + 128 * i, kb = idx & 15, nb = idx >> 4;
      // rw[i][r] holds W[k=kb*4+r][n=nb*4 .. nb*4+3]; out[j] = W[kb*4..+3][nb*4+j]
      uint32_t lo01 = __byte_perm(rw[i][0], rw[i][1], 0x5140);
      uint32_t lo23 = __byte_perm(rw[i][2], rw[i][3], 0x5140);
      uint32_t hi01 = __byte_perm(rw[i][0], rw[i][1], 0x7362);
      uint32_t hi23 = __byte_perm(rw[i][2], rw[i][3], 0x7362);
      uint32_t o[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                       __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(Wt + (nb * 4 + j) * SSTR + kb * 4) = o[j];
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight during the mma below
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = As + (wm * 32 + mt * 16 + gid) * SSTR + ks + tig * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* p = Wt + (wn * 64 + nt * 8 + gid) * SSTR + ks + tig * 4;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }
}

// ---- epilogue 1: dequant [+ bias] -> bf16 -------------------------------------
template <bool BIAS>
__global__ void __launch_bounds__(128) gemm_dequant(
    const int8_t* __restrict__ aq, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, const float* __restrict__ bias,
    const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[BM * SSTR];
  __shared__ __align__(16) int8_t Wt[BN * SSTR];  // K-major: Wt[n][k]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[2][8][4];
  gemm_tile(aq, K, wq, M, K, N, m0, n0, As, Wt, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + gid + half * 8;
      if (row >= M) continue;
      const float srow = s[row];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + tig * 2;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), srow), ws[col + e]);
          if (BIAS) y[e] = __fadd_rn(y[e], bias[col + e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(y[0], y[1]);
      }
    }
  }
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
