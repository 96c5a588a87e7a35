// DAC residual units for Hopper: one unit (B9) or a decoder stage's three
// chained units (B6), in one cooperative launch.
//
// Replaces the TPU kernels res_unit_fused (_res_unit_kernel) and
// res_stage_fused (_res_stage_kernel) in the JAX package's
// ops/dac_kernels.py.  One unit, on x [B, T, C] fp32:
//   y   = bf16(snake(x, a1))
//   h   = bf16(snake(sum_k y[r + (k-3) d] @ w7[k] + b7, a2))   fp32 sums
//   out = (x + h @ w1) + b1                                     fp32
// B6 runs the units with dilations 1, 3, 9; rows outside [0, T) read as
// zero before every unit, which is the TPU kernel's re-zeroing of its halo.
//
// What bounds it on the H100: at the decode's shapes (C, T) = (384,
// 184,576), (192, 738,304), (96, 1,476,608) a stage is 16 C^2 T x 3
// bf16 operations (1.31e12, 1.31e12, 6.5e11: 1.32, 1.32, 0.66 ms at 989
// TFLOP/s) against 8 C T bytes of compulsory traffic (x in, out out:
// 0.17-0.34 ms at 3.35 TB/s): the tensor cores bound it.
//
// Design.  A unit is two GEMMs of bf16_gemm.cuh, each writing its result
// to device memory: the 7-tap conv (depth 7C) with the snake of a2 in its
// epilogue (h, bf16), then the 1x1 conv (depth C) with the residual and b1
// in its epilogue, which also writes the next unit's y.  A GEMM reads rows
// of y that other CTAs wrote, so the phases are separated by a grid-wide
// barrier: the kernel is persistent (a grid that fits on the card at once,
// launched with cudaLaunchCooperativeKernel) and walks the 128 x 64 tiles
// of each phase.  Phases: snake of the input, then (conv7, conv1) per
// unit.  out is updated in place from the second unit on (each element's
// residual is read and written by the same thread); y and h are bf16
// scratch [B, T, C] that the wrapper allocates.  Keeping a unit's
// intermediates on chip (the TPU's halo recompute) is later work.

#include "bf16_gemm.cuh"

namespace {

struct ResArgs {
  const float* x;
  float* out;
  __nv_bfloat16* y;
  __nv_bfloat16* h;
  unsigned* bar;                        // [count, generation], zeroed by the C entry
  const __nv_bfloat16* w7s;             // [U, 7, C, C]
  const float* b7s;                     // [U, C]
  const __nv_bfloat16* w1s;             // [U, C, C]
  const float *b1s, *a1s, *a2s;         // [U, C]
  int B, T, C, units;
  int dil[3];
};

// All CTAs of the (co-resident) grid meet here.  A barrier that never
// opens traps after ~2^34 cycles (~9 s) instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        __nanosleep(100);
        if (clock64() - t0 > (1LL << 34)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) res_units_kernel(ResArgs p) {
  __shared__ __align__(16) GemmSmem sm;
  const int B = p.B, T = p.T, C = p.C;
  const size_t n_el = (size_t)B * T * C;
  snake_pass(p.x, p.a1s, p.y, n_el, C, (size_t)blockIdx.x * NT + threadIdx.x,
             (size_t)gridDim.x * NT);
  grid_sync(p.bar);

  const int mtiles = (T + BM - 1) / BM, ntiles = (C + BN - 1) / BN;
  const int tiles = B * mtiles * ntiles;
  for (int u = 0; u < p.units; ++u) {
    const int d = p.dil[u];
    const float* b7 = p.b7s + (size_t)u * C;
    const float* a2 = p.a2s + (size_t)u * C;
    const Gemm g7{p.y, p.w7s + (size_t)u * 7 * C * C, (long long)C * C, T, C, C, T, 7, -3 * d, d};
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % ntiles, mt = (tile / ntiles) % mtiles, b = tile / (ntiles * mtiles);
      gemm_tile(g7, b, mt * BM, nt * BN, sm, [&](int bb, int r, int n, float v0, float v1) {
        const float h0 = snake(__fadd_rn(v0, b7[n]), a2[n]);
        const float h1 = snake(__fadd_rn(v1, b7[n + 1]), a2[n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p.h + ((size_t)bb * T + r) * C + n) =
            __floats2bfloat162_rn(h0, h1);
      });
    }
    grid_sync(p.bar);

    const float* b1 = p.b1s + (size_t)u * C;
    const float* xin = u == 0 ? p.x : p.out;
    const bool next = u + 1 < p.units;
    const float* a1n = p.a1s + (size_t)(u + 1) * C;
    const Gemm g1{p.h, p.w1s + (size_t)u * C * C, 0, T, C, C, T, 1, 0, 0};
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % ntiles, mt = (tile / ntiles) % mtiles, b = tile / (ntiles * mtiles);
      gemm_tile(g1, b, mt * BM, nt * BN, sm, [&](int bb, int r, int n, float v0, float v1) {
        const size_t i = ((size_t)bb * T + r) * C + n;
        const float2 xv = __ldcg(reinterpret_cast<const float2*>(xin + i));
        const float o0 = __fadd_rn(__fadd_rn(xv.x, v0), b1[n]);
        const float o1 = __fadd_rn(__fadd_rn(xv.y, v1), b1[n + 1]);
        *reinterpret_cast<float2*>(p.out + i) = make_float2(o0, o1);
        if (next)
          *reinterpret_cast<__nv_bfloat162*>(p.y + i) =
              __floats2bfloat162_rn(snake(o0, a1n[n]), snake(o1, a1n[n + 1]));
      });
    }
    if (next) grid_sync(p.bar);
  }
}

}  // namespace

// x, out [B, T, C] fp32; y, h [B, T, C] bf16 scratch; bar 2 x u32 scratch;
// w7s [U, 7, C, C], w1s [U, C, C] bf16 ([K, Cin, Cout]); b7s, b1s, a1s, a2s
// [U, C] fp32; U units with dilations d0, d1, d2.  Needs C % 8 == 0 (the
// wrapper checks).
extern "C" int res_units(const void* x, void* out, void* y, void* h, void* bar, const void* w7s,
                         const void* b7s, const void* w1s, const void* b1s, const void* a1s,
                         const void* a2s, int B, int T, int C, int units, int d0, int d1, int d2,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ResArgs p{(const float*)x, (float*)out, (__nv_bfloat16*)y, (__nv_bfloat16*)h, (unsigned*)bar,
            (const __nv_bfloat16*)w7s, (const float*)b7s, (const __nv_bfloat16*)w1s,
            (const float*)b1s, (const float*)a1s, (const float*)a2s, B, T, C, units, {d0, d1, d2}};
  int dev, nsm, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, res_units_kernel, NT, 0);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)B * ((T + BM - 1) / BM) * ((C + BN - 1) / BN);
  const int grid = (int)(tiles < (long long)per_sm * nsm ? tiles : (long long)per_sm * nsm);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)res_units_kernel, dim3(grid), dim3(NT), args, 0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
