// The split entries of the s8 kernels for tensor parallelism, for Hopper:
// a model group of M ranks holds 1/M of a projection, and its ranks meet
// in collectives between the launches below (jatsr_torch/ops/split.py).
// Each keeps the whole-width kernel's numbers bit for bit, because every
// split lands where the arithmetic is exact:
//
//   column-parallel B1 and B5 (mlp_in's columns split): the GELU row's
//     codes take the row maximum over the whole MLP width.  Pass 1 of
//     s8_gelu.cuh runs on the rank's columns as it is; rowmax_reduce takes
//     each row's max over its partials; the ranks take the max of those
//     (a max is exact in any order); rowmax_fill writes that global max
//     into every partial of the row, so that pass 2, as it is, reads it.
//   row-parallel B4 (out_proj's input rows split by heads, its kernel's
//     rows over K): row_absmax takes max|a| over the rank's columns; the
//     ranks take the max; quant_rows_given quantises at the scale of the
//     whole row, s = max(amax * INV127, 1e-12), as s8_rows.cuh's divide
//     form does; s8_acc_kernel is the s8 wgmma GEMM of s8_wgmma.cuh
//     writing the int32 accumulators; the ranks add them (exact); then
//     dequant_acc writes OUT(((float)acc * s) * ws), B4's epilogue.
//   row-parallel B14 (w8a8_dot(impl="pallas") on out_proj or the unfused
//     mlp_out): the same launches, but quant_rows_given's RAW form writes
//     the unfloored amax * INV127, which B14's epilogue rescales by (the
//     codes still divide by the floored scale).
//   row-parallel B12 (the out projection inside the attention kernel):
//     the rank's heads' attention, row_absmax of its o, the ranks' max,
//     quant_rows_given and s8_acc_kernel on its rows of wo, the ranks' sum,
//     then dequant_acc with the bias: bf16(((float)acc * so) * wos + bo),
//     s8_dequant.cuh's epilogue with its bias, added once.
//   B13 (mlp_full.cu): each rank's int32 product of each slab it holds
//     goes through s8_acc_kernel into its own [M, N2] plane (column views
//     of the codes and of w2 K-major: s8_tensor_map_ld); the ranks add the
//     planes, and the fold runs once over all of them in slab order.
//
// Every kernel here is a template, so that a library builds only those it
// launches and no instance that existed before changes.  Each csrc/*.cu
// that includes this file is built into its own shared library, so
// everything here lives in an anonymous namespace.

#pragma once

#include "s8_rows.cuh"

namespace {

// part [M, nt] -> rm [M]: each row's max over its nt partials (all >= 0),
// a warp a row.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256) rowmax_reduce(const float* __restrict__ part,
                                                     float* __restrict__ rm, int M, int nt) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  float m = 0.f;
  for (int j = lane; j < nt; j += 32) m = fmaxf(m, part[(size_t)row * nt + j]);
  m = warp_max(m);
  if (lane == 0) rm[row] = m;
}

// rm [M] -> part [M, nt]: every partial of row r set to rm[r].
template <int UNUSED = 0>
__global__ void __launch_bounds__(256) rowmax_fill(const float* __restrict__ rm,
                                                   float* __restrict__ part, int M, int nt) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (size_t)M * nt) part[i] = rm[i / nt];
}

template <int UNUSED = 0>
cudaError_t launch_rowmax_reduce(const void* part, void* rm, int M, int nt, cudaStream_t st) {
  rowmax_reduce<><<<(M + 7) / 8, 256, 0, st>>>((const float*)part, (float*)rm, M, nt);
  return cudaGetLastError();
}

template <int UNUSED = 0>
cudaError_t launch_rowmax_fill(const void* rm, void* part, int M, int nt, cudaStream_t st) {
  const size_t n = (size_t)M * nt;
  rowmax_fill<><<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)rm, (float*)part, M,
                                                              nt);
  return cudaGetLastError();
}

// a [M, K] bf16 -> amax [M] f32, max|a_row| (unscaled), a warp a row, 16
// bytes a lane a step.  Needs K % 8 == 0.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256) row_absmax(const __nv_bfloat16* __restrict__ a,
                                                  float* __restrict__ amax, int M, int K) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const __nv_bfloat16* ar = a + (size_t)row * K;
  float m = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(ar + k));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  }
  m = warp_max(m);
  if (lane == 0) amax[row] = m;
}

// a [M, K] bf16 and the whole row's amax [M] -> aq [M, K] s8 (rint(a / s)),
// s [M] f32, s = max(amax * INV127, 1e-12): quant_rows_v's scale and codes
// at a scale taken over more columns than a holds (RAW: the scale written
// is the unfloored amax * INV127, quant_rows_raw_v's).  Its first
// instruction lets the next launch start.
template <int UNUSED = 0, bool RAW = false>
__global__ void __launch_bounds__(256) quant_rows_given(const __nv_bfloat16* __restrict__ a,
                                                        const float* __restrict__ amax,
                                                        int8_t* __restrict__ aq,
                                                        float* __restrict__ s, int M, int K) {
  griddep_launch();
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const float sc = fmaxf(__fmul_rn(amax[row], INV127), 1e-12f);
  const __nv_bfloat16* ar = a + (size_t)row * K;
  int8_t* qr = aq + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(ar + k));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
    *reinterpret_cast<uint2*>(qr + k) = quant8(f, sc);
  }
  if (lane == 0) s[row] = RAW ? __fmul_rn(amax[row], INV127) : sc;
}

// The s8 wgmma GEMM of s8_wgmma.cuh on aq [M, K] and the weight K-major
// wt [N, K], writing the int32 accumulators acc [M, N].  Needs N % 128 ==
// 0 and K % 16 == 0.  Under programmatic stream serialisation its CTAs
// issue the weight's first copies before they wait for the codes.
template <int UNUSED = 0>
__global__ void __launch_bounds__(S8_THREADS, 2) s8_acc_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    int* __restrict__ acc_out, int M, int K, int N) {
  const int n0 = blockIdx.x * S8_BN, m0 = blockIdx.y * S8_BM;
  s8_gemm_tile(
      (K + S8_BK - 1) / S8_BK,
      [&](int kb, unsigned char* a, unsigned char* b, uint64_t* bar) {
        tma_load_2d(b, &bm, bar, kb * S8_BK, n0);  // the weight: no dependence
        if (kb == 0) griddep_wait();               // the codes: the quant launch's
        tma_load_2d(a, &am, bar, kb * S8_BK, m0);
      },
      [](int, int) {},
      [&](const int (&acc)[S8_ACC], int row, int col, unsigned char*) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          if (r >= M) continue;
          int* dst = acc_out + (size_t)r * N + n0 + col;
#pragma unroll
          for (int i = 0; i < S8_BN / 8; ++i)
            *reinterpret_cast<int2*>(dst + 8 * i) = make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      });
}

// acc [M, N] int32, s [M], ws [N] f32 -> out [M, N] OUT: ((float)acc * s)
// * ws, each product rounded, with BIAS then + bias [N] rounded, then one
// rounding to OUT (bf16 or fp32): s8_dequant_kernel's epilogue.
template <class OUT, bool BIAS = false>
__global__ void __launch_bounds__(256) dequant_acc(const int* __restrict__ acc,
                                                   const float* __restrict__ s,
                                                   const float* __restrict__ ws,
                                                   OUT* __restrict__ out, int M, int N,
                                                   const float* __restrict__ bias) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int r = (int)(i / N), c = (int)(i % N);
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), s[r]), ws[c]);
  if constexpr (BIAS) y = __fadd_rn(y, bias[c]);
  if constexpr (sizeof(OUT) == 2)
    out[i] = __float2bfloat16_rn(y);
  else
    out[i] = y;
}

template <int UNUSED = 0>
cudaError_t launch_row_absmax(const void* a, void* amax, int M, int K, cudaStream_t st) {
  if (K % 8) return cudaErrorInvalidValue;
  row_absmax<><<<(M + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)a, (float*)amax, M, K);
  return cudaGetLastError();
}

// s8_acc_kernel on the codes aq [M, K] (row stride lda bytes) and the
// weight K-major wt [N, K] (row stride ldw): acc [M, N] int32.  Column
// views need 16-byte aligned bases and strides.  With pdl, launched under
// programmatic stream serialisation (its CTAs read wt before they wait).
template <int UNUSED = 0>
cudaError_t launch_s8_acc(const void* aq, int lda, const void* wt, int ldw, void* acc, int M,
                          int K, int N, bool pdl, cudaStream_t st) {
  if (K % 16 || N % S8_BN || lda % 16 || ldw % 16) return cudaErrorInvalidValue;
  CUtensorMap am, bm;
  cudaError_t e = s8_tensor_map_ld(&am, aq, M, K, lda, S8_BM);
  if (e == cudaSuccess) e = s8_tensor_map_ld(&bm, wt, N, K, ldw, S8_BN);
  if (e != cudaSuccess) return e;
  const dim3 grid(N / S8_BN, (M + S8_BM - 1) / S8_BM);
  return s8_launch<s8_acc_kernel<>>(grid, S8_THREADS, S8_SMEM, pdl, st, am, bm, (int*)acc, M, K,
                                    N);
}

// quant_rows_given (RAW: the unfloored scale written), then s8_acc_kernel
// behind it under programmatic stream serialisation: two launches.
template <bool RAW = false>
cudaError_t launch_quant_acc(const void* a, const void* amax, const void* wt, void* aq, void* s,
                             void* acc, int M, int K, int N, cudaStream_t st) {
  if (K % 16 || N % S8_BN) return cudaErrorInvalidValue;
  quant_rows_given<0, RAW><<<(M + 7) / 8, 256, 0, st>>>(
      (const __nv_bfloat16*)a, (const float*)amax, (int8_t*)aq, (float*)s, M, K);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : launch_s8_acc(aq, K, wt, K, acc, M, K, N, true, st);
}

// dequant_acc in bf16 or (out_f32) fp32; a non-null bias is added (B12's
// epilogue, bf16 only).
template <int UNUSED = 0>
cudaError_t launch_dequant_acc(const void* acc, const void* s, const void* ws, void* out, int M,
                               int N, int out_f32, cudaStream_t st, const void* bias = nullptr) {
  const size_t n = (size_t)M * N;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  auto A = (const int*)acc;
  auto S = (const float*)s;
  auto WS = (const float*)ws;
  auto BI = (const float*)bias;
  if (bias && out_f32) return cudaErrorInvalidValue;
  if (bias)
    dequant_acc<__nv_bfloat16, true><<<blocks, 256, 0, st>>>(A, S, WS, (__nv_bfloat16*)out, M, N,
                                                             BI);
  else if (out_f32)
    dequant_acc<float><<<blocks, 256, 0, st>>>(A, S, WS, (float*)out, M, N, nullptr);
  else
    dequant_acc<__nv_bfloat16><<<blocks, 256, 0, st>>>(A, S, WS, (__nv_bfloat16*)out, M, N,
                                                       nullptr);
  return cudaGetLastError();
}

}  // namespace
