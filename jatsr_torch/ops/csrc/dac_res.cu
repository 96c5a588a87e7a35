// DAC residual units for Hopper: one unit (B9) or a decoder stage's three
// chained units (B6), in one cooperative launch on bf16_wgmma.cuh's core.
//
// Replaces the TPU kernels res_unit_fused (_res_unit_kernel, pallas_call
// :376) and res_stage_fused (_res_stage_kernel, pallas_call :289) in the
// JAX package's ops/dac_kernels.py.  One unit, on x [B, T, C] fp32:
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
// 0.17-0.34 ms at 3.35 TB/s): the tensor cores bound it.  What the kernel
// itself must move is ~40 C T bytes a stage (below).
//
// Design.  A persistent cooperative kernel (a grid that fits on the card
// at once, sized by the occupancy at its dynamic shared memory) walks the
// 128-row tiles of [B, T]; a CTA owns a tile across all C output columns.
// Three warpgroups: warpgroup 0's first thread is the TMA producer,
// warpgroups 1 and 2 the consumers, 64 rows each (bf16_wgmma.cuh).  A tile
// of a unit:
//   conv7  an implicit GEMM of depth 7C on the TMA ring: a k-block's A is a
//          [128 rows][64 channels] box of y at rows t0 + (k - 3) d of tap k
//          (the 3-D tensor map [B, T, C] zero-fills rows below 0 or past T:
//          the conv's zero padding), its B is BN / 64 [64][64] boxes of
//          w7[u, k] in the JAX layout [Cin, Cout], read N-major as the
//          transposed operand (B8's trick).  The column tile BN (96 or 192,
//          the plan's) runs in halves over C: 192 at C = 384 (two halves),
//          96 at C = 192 (two; one of 192 spilled in its epilogue and ran
//          slower) and C = 96.  Each half gets b7 and snake, is rounded to
//          bf16 and written to shared memory as h, in the 128-byte-swizzled
//          K-major layout that the A descriptor reads (C / 64 blocks of
//          16 KB: 96 KB at C = 384).  h never reaches device memory.
//   conv1  the 1x1 conv from h in shared memory (depth C), w1 through TMA;
//          its epilogue reads x (unit 0) or out, writes out = (x + acc) + b1
//          in place (the same thread reads and writes each element) and the
//          next unit's y = bf16(snake(out, a1')).
// The products keep one wgmma group in flight (a stage is released once
// the next k-block's products are issued).  y is two bf16 [B, T, C]
// buffers: unit u reads y[u % 2] and writes y[(u + 1) % 2], so a CTA that
// runs ahead never overwrites rows that another CTA's conv7 still reads.
// A grid barrier separates the units (y's halo rows belong to other
// tiles): the snake of x, then one barrier a unit but the last, three in
// all for B6 (the mma.sync version had six: h made a round trip through
// device memory between its two GEMMs).  y is written by ordinary stores
// (the generic proxy) and read after the barrier by TMA (the async proxy),
// so every writer issues fence.proxy.async.global before it arrives; h,
// written by ordinary shared-memory stores and read by wgmma, takes
// fence.proxy.async.shared::cta and a warpgroup barrier (each consumer
// warpgroup reads only its own 64 rows of h).
//
// The epilogues.  With only the two consumer warpgroups (8 warps an SM) to
// run them, the snakes (~4e8 a stage) bound the first version: each sinf
// carries a branch to its Payne-Hanek path, so no two interleave, and the
// divide 1 / (a + 1e-9) ran once an element.  Now a unit's per-channel
// constants (b7, a2, b1, a1' and the two reciprocals, snake()'s own
// values) sit in shared memory, the snakes run eight at a time through
// snake.cuh's snake_batch (sinf's fast path without its branch, bit-equal
// to sinf; the rare argument at or past 105615 by sinf itself), the loops
// over a full column tile have no branch, and x is read four column pairs
// ahead of its use.  A tile that reaches past C takes a plain loop with
// each snake a call.
//
// Traffic a stage (C T elements a unit, bf16 y, fp32 x and out): the
// snake pass reads x and writes y (6 CT bytes); each unit reads y (2 CT,
// the taps' re-reads hit L2), reads x or out and writes out (8 CT) and,
// but the last, writes y (2 CT): ~40 CT bytes, against ~52 CT with h in
// device memory.  From L2 the ring reads y once a tap and the weights once
// a tile: ~16 GB a stage at the decode's shapes.
//
// Numerics: the mma.sync version's (snake.cuh's snake, bf16 y and h, fp32
// sums, (x + acc) + b1); only the order of the fp32 sums differs.

#include "bf16_wgmma.cuh"
#include "snake.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

struct ResArgs {
  const float* x;
  float* out;
  __nv_bfloat16* y;             // [2, B, T, C]
  unsigned* bar;                // [count, generation], zeroed by the C entry
  const float *b7s, *b1s, *a1s, *a2s;  // [U, C]
  int B, T, C, units, stages;
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

// Orders this thread's generic-proxy writes before later async-proxy (TMA,
// wgmma) accesses: of device memory, or of the CTA's shared memory.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of consumer warpgroup `wg` (named barrier wg; 0 is
// __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg) : "memory");
}

// Byte offset of h[row][col] in the K-major 128-byte-swizzled layout that
// TMA writes and wgmma's A descriptor reads: 64-column blocks of [128 rows]
// [128 bytes]; the 16-byte chunk (col % 64) / 8 of a row is stored at chunk
// ((col % 64) / 8) ^ (row % 8).
__device__ __forceinline__ uint32_t h_offset(int row, int col) {
  return (col >> 6) * WG_A_BYTES + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// k-steps of 16 of k-block cb that hold channels below C (4 but at a
// partial last block); the rest of the block is zero on both operands.
__device__ __forceinline__ int ksteps(int C, int cb) {
  const int left = C - cb * WG_BK;
  return left >= WG_BK ? 4 : (left + 15) / 16;
}

// The per-channel constants of a unit in shared memory, [COLS][C] fp32:
// b7, a2 and 1 / (a2 + 1e-9) for h's snake, b1, and a1 and 1 / (a1 + 1e-9)
// of the next unit's y (of the first unit's, before it).  The reciprocals
// are snake()'s own, computed once a channel.
enum Col { kB7, kA2, kInv2, kB1, kA1, kInv1, COLS };

// h = bf16(snake(acc + b7, a2)) into the swizzled h: this thread's columns
// n0 + 8 i + col (+ 1) of rows row and row + 8, two column pairs (eight
// snakes) a batch (snake_batch), where every column is below C.
template <int BN, bool B16>
__device__ __forceinline__ void store_h(const float (&acc)[BN / 2], unsigned char* h,
                                        const float* cols, int C, int n0, int row, int col) {
  static_assert(BN % 16 == 0, "column pairs in twos");
#pragma unroll
  for (int i = 0; i < BN / 8; i += 2) {
    float v[8], a[8], inv[8], y[8];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int n = n0 + 8 * (i + ii) + col;
      const float2 bb = *reinterpret_cast<const float2*>(cols + kB7 * C + n);
      const float2 aa = *reinterpret_cast<const float2*>(cols + kA2 * C + n);
      const float2 vv = *reinterpret_cast<const float2*>(cols + kInv2 * C + n);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 4 * ii + 2 * e;
        v[j] = __fadd_rn(acc[4 * (i + ii) + 2 * e], bb.x);
        v[j + 1] = __fadd_rn(acc[4 * (i + ii) + 2 * e + 1], bb.y);
        a[j] = aa.x, a[j + 1] = aa.y, inv[j] = vv.x, inv[j + 1] = vv.y;
      }
    }
    snake_batch_t<8, B16>(v, a, inv, y);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int n = n0 + 8 * (i + ii) + col;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<__nv_bfloat162*>(h + h_offset(row + 8 * e, n)) =
            __floats2bfloat162_rn(y[4 * ii + 2 * e], y[4 * ii + 2 * e + 1]);
    }
  }
}

// out = (x + acc) + b1 in place, and (NEXT) the next unit's y = bf16(snake(
// out, a1')), for this thread's columns of rows r0 and r0 + 8 (their
// element offsets at0, at0 + 8 C; ok0, ok1: below T), where every column is
// below C.  x is read four column pairs ahead of its use, so that the
// loads overlap; the snakes run eight a batch.
template <int BN, bool NEXT, bool B16>
__device__ __forceinline__ void store_out(const float (&acc)[BN / 2], const float* xin, float* out,
                                          __nv_bfloat16* yn, const float* cols, int C, int n0,
                                          int col, size_t at0, bool ok0, bool ok1) {
  constexpr int G = 4;  // column pairs a batch of loads
  static_assert(BN % (8 * G) == 0, "whole batches");
#pragma unroll
  for (int g = 0; g < BN / 8; g += G) {
    float2 xv[G][2];
#pragma unroll
    for (int i = g; i < g + G; ++i) {
      const int n = n0 + 8 * i + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = e ? ok1 : ok0;
        xv[i - g][e] = ok ? __ldcg(reinterpret_cast<const float2*>(xin + at0 + e * 8 * C + n))
                          : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = g; i < g + G; i += 2) {
      float o[8], a[8], inv[8], y[8];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int n = n0 + 8 * (i + ii) + col;
        const float2 bb = *reinterpret_cast<const float2*>(cols + kB1 * C + n);
        float2 aa{}, vv{};
        if (NEXT) {
          aa = *reinterpret_cast<const float2*>(cols + kA1 * C + n);
          vv = *reinterpret_cast<const float2*>(cols + kInv1 * C + n);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * ii + 2 * e;
          const float2 x = xv[i + ii - g][e];
          o[j] = __fadd_rn(__fadd_rn(x.x, acc[4 * (i + ii) + 2 * e]), bb.x);
          o[j + 1] = __fadd_rn(__fadd_rn(x.y, acc[4 * (i + ii) + 2 * e + 1]), bb.y);
          a[j] = aa.x, a[j + 1] = aa.y, inv[j] = vv.x, inv[j + 1] = vv.y;
        }
      }
      if (NEXT) snake_batch_t<8, B16>(o, a, inv, y);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int n = n0 + 8 * (i + ii) + col;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!(e ? ok1 : ok0)) continue;
          const size_t at = at0 + e * 8 * C + n;
          const int j = 4 * ii + 2 * e;
          *reinterpret_cast<float2*>(out + at) = make_float2(o[j], o[j + 1]);
          if (NEXT)
            *reinterpret_cast<__nv_bfloat162*>(yn + at) = __floats2bfloat162_rn(y[j], y[j + 1]);
        }
      }
    }
  }
}

// snake_with out of line, for the epilogues below: one copy of sinf (and
// of the bf16 mode's).
__device__ __noinline__ float snake_call(float x, float a, float inv) { return snake_with(x, a, inv); }
__device__ __noinline__ float snake_call_b16(float x, float a, float inv) {
  return snake_with_b16(x, a, inv);
}
template <bool B16>
__device__ __forceinline__ float snake_call_t(float x, float a, float inv) {
  if constexpr (B16) return snake_call_b16(x, a, inv);
  else return snake_call(x, a, inv);
}

// The same two epilogues where the column tile reaches past C (C not a
// multiple of the tile width): a column pair at a time, each snake a call.
template <int BN, bool B16>
__device__ __forceinline__ void store_h_part(const float (&acc)[BN / 2], unsigned char* h,
                                             const float* cols, int C, int n0, int row, int col) {
#pragma unroll
  for (int j = 0; j < BN / 4; ++j) {
    const int n = n0 + 8 * (j >> 1) + col;
    if (n >= C) continue;
    *reinterpret_cast<__nv_bfloat162*>(h + h_offset(row + 8 * (j & 1), n)) =
        __floats2bfloat162_rn(snake_call_t<B16>(__fadd_rn(acc[2 * j], cols[kB7 * C + n]),
                                                cols[kA2 * C + n], cols[kInv2 * C + n]),
                              snake_call_t<B16>(__fadd_rn(acc[2 * j + 1], cols[kB7 * C + n + 1]),
                                                cols[kA2 * C + n + 1], cols[kInv2 * C + n + 1]));
  }
}

template <int BN, bool B16>
__device__ __forceinline__ void store_out_part(const float (&acc)[BN / 2], const float* xin,
                                               float* out, __nv_bfloat16* yn, const float* cols,
                                               int C, int n0, int col, size_t at0, bool ok0,
                                               bool ok1, bool next) {
#pragma unroll
  for (int j = 0; j < BN / 4; ++j) {
    const int e = j & 1, n = n0 + 8 * (j >> 1) + col;
    if (n >= C || !(e ? ok1 : ok0)) continue;
    const size_t at = at0 + e * 8 * C + n;
    const float2 xv = __ldcg(reinterpret_cast<const float2*>(xin + at));
    const float o0 = __fadd_rn(__fadd_rn(xv.x, acc[2 * j]), cols[kB1 * C + n]);
    const float o1 = __fadd_rn(__fadd_rn(xv.y, acc[2 * j + 1]), cols[kB1 * C + n + 1]);
    *reinterpret_cast<float2*>(out + at) = make_float2(o0, o1);
    if (next)
      *reinterpret_cast<__nv_bfloat162*>(yn + at) = __floats2bfloat162_rn(
          snake_call_t<B16>(o0, cols[kA1 * C + n], cols[kInv1 * C + n]),
          snake_call_t<B16>(o1, cols[kA1 * C + n + 1], cols[kInv1 * C + n + 1]));
  }
}

template <int BN, bool B16>
__global__ void __launch_bounds__(WG_THREADS, 1) res_units_kernel(
    const __grid_constant__ CUtensorMap y0m, const __grid_constant__ CUtensorMap y1m,
    const __grid_constant__ CUtensorMap w7m, const __grid_constant__ CUtensorMap w1m,
    const ResArgs p) {
  constexpr int BOXES = (BN + 63) / 64;
  constexpr int B_BYTES = BOXES * WG_B_BOX;
  constexpr int STAGE = WG_A_BYTES + B_BYTES;
  extern __shared__ __align__(1024) unsigned char raw[];
  const uint32_t raw_u32 = wg_smem_u32(raw);
  unsigned char* ring = raw + (((raw_u32 + 1023) & ~1023u) - raw_u32);
  const int B = p.B, T = p.T, C = p.C, S = p.stages;
  const int kc = (C + WG_BK - 1) / WG_BK;  // 64-deep k-blocks of a tap, and of h
  unsigned char* h = ring + S * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(h + kc * WG_A_BYTES);
  uint64_t* empty = full + S;
  float* cols = reinterpret_cast<float*>(empty + S);  // [COLS][C]
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // h's columns at or past C stay zero: a partial last k-step reads them.
  for (int i = threadIdx.x; i < kc * WG_A_BYTES / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(h)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_shared();
  // y = bf16(snake(x, a1)) of the first unit, 4 channels a thread a step.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    cols[kA1 * C + c] = snake_a_t<B16>(p.a1s[c]);
    cols[kInv1 * C + c] = snake_inv_t<B16>(p.a1s[c]);
  }
  __syncthreads();
  const size_t plane = (size_t)B * T * C;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < plane;
       i += (size_t)gridDim.x * blockDim.x * 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p.x + i));
    const int c = (int)(i % C);
    const float4 aa = *reinterpret_cast<const float4*>(cols + kA1 * C + c);
    const float4 ii = *reinterpret_cast<const float4*>(cols + kInv1 * C + c);
    const float x4[4] = {v.x, v.y, v.z, v.w}, a4[4] = {aa.x, aa.y, aa.z, aa.w},
                i4[4] = {ii.x, ii.y, ii.z, ii.w};
    float y4[4];
    snake_batch_t<4, B16>(x4, a4, i4, y4);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y4[0], y4[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y4[2], y4[3]);
    *reinterpret_cast<uint2*>(p.y + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
  fence_async_global();
  grid_sync(p.bar);

  const int mtiles = (T + WG_BM - 1) / WG_BM, tiles = B * mtiles;
  const int halves = (C + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  uint32_t it = 0;  // stages of the ring so far: both roles count alike
  for (int u = 0; u < p.units; ++u) {
    const int d = p.dil[u];
    if (wg == 0) {
      if (threadIdx.x == 0) {  // the producer: one thread keeps the ring full
        const CUtensorMap* ym = (u & 1) ? &y1m : &y0m;
        fence_async_global();
        auto stage = [&](uint32_t bytes, uint64_t*& bar) {
          const int s = it % S;
          if (it >= (uint32_t)S) mbar_wait(&empty[s], (it / S - 1) & 1);
          bar = &full[s];
          mbar_expect_tx(bar, bytes);
          ++it;
          return ring + s * STAGE;
        };
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int b = tile / mtiles, t0 = (tile % mtiles) * WG_BM;
          for (int hf = 0; hf < halves; ++hf)
            for (int k = 0; k < 7; ++k)
              for (int cb = 0; cb < kc; ++cb) {
                uint64_t* bar;
                unsigned char* a = stage(STAGE, bar);
                tma_load_3d(a, ym, bar, cb * WG_BK, t0 + (k - 3) * d, b);
#pragma unroll
                for (int j = 0; j < BOXES; ++j)
                  tma_load_3d(a + WG_A_BYTES + j * WG_B_BOX, &w7m, bar, hf * BN + 64 * j,
                              cb * WG_BK, u * 7 + k);
              }
          for (int hf = 0; hf < halves; ++hf)
            for (int cb = 0; cb < kc; ++cb) {
              uint64_t* bar;
              unsigned char* a = stage(B_BYTES, bar);
#pragma unroll
              for (int j = 0; j < BOXES; ++j)
                tma_load_3d(a + WG_A_BYTES + j * WG_B_BOX, &w1m, bar, hf * BN + 64 * j,
                            cb * WG_BK, u);
            }
        }
      }
      __syncwarp();  // warp 0 whole again before the grid barrier
    } else {  // the consumers: warpgroup wg owns rows (wg - 1) * 64 .. + 63 of a tile
      const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
      const int row = (wg - 1) * 64 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
      const bool next = u + 1 < p.units;
      for (int c = threadIdx.x - 128; c < C; c += 256) {  // the unit's constants
        const size_t at = (size_t)u * C + c;
        cols[kB7 * C + c] = p.b7s[at];
        cols[kA2 * C + c] = snake_a_t<B16>(p.a2s[at]);
        cols[kInv2 * C + c] = snake_inv_t<B16>(p.a2s[at]);
        cols[kB1 * C + c] = p.b1s[at];
        if (next) {
          cols[kA1 * C + c] = snake_a_t<B16>(p.a1s[at + C]);
          cols[kInv1 * C + c] = snake_inv_t<B16>(p.a1s[at + C]);
        }
      }
      asm volatile("bar.sync 3, 256;\n" ::: "memory");  // the consumers' barrier
      const float* xin = u == 0 ? p.x : p.out;
      __nv_bfloat16* yn = p.y + ((u + 1) & 1) * plane;
      const uint32_t h_rows = wg_smem_u32(h) + (wg - 1) * 64 * 128;
      float acc[BN / 2];
      // One k-block: wait for its stage, issue its products (A from the
      // stage, or from h at `h_a`), then wait for the previous k-block's
      // products alone and release that stage: one group stays in flight.
      int prev = -1;  // the stage of the k-block in flight, if any
      auto kblock = [&](bool from_h, uint32_t h_a, int steps) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const uint32_t bb = wg_smem_u32(ring + s * STAGE + WG_A_BYTES);
        const uint32_t a = from_h ? h_a : wg_smem_u32(ring + s * STAGE) + (wg - 1) * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          if (kk < steps)
            wgmma_k16<BN>(acc, wg_desc(a + kk * 32, 16, 1024),
                          wg_desc(bb + kk * 2048, WG_B_BOX, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        ++it;
      };
      // The last k-block's products, before the sums are read.
      auto drain = [&]() {
        wgmma_wait_all();
        wg_fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[prev]);
        prev = -1;
      };
      auto clear = [&]() {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        wg_fence_acc(acc);
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b = tile / mtiles, t0 = (tile % mtiles) * WG_BM;
        // conv7, a half at a time, into h.  acc[4 i + e]: row (+ 8 for
        // e >= 2), column n0 + 8 i + col + (e & 1).
        for (int hf = 0; hf < halves; ++hf) {
          clear();
          for (int k = 0; k < 7; ++k)
            for (int cb = 0; cb < kc; ++cb) kblock(false, 0, ksteps(C, cb));
          drain();
          if ((hf + 1) * BN <= C)
            store_h<BN, B16>(acc, h, cols, C, hf * BN, row, col);
          else
            store_h_part<BN, B16>(acc, h, cols, C, hf * BN, row, col);
        }
        fence_async_shared();
        warpgroup_sync(wg);
        // conv1 from h, a half at a time, and the residual epilogue.
        const size_t at0 = ((size_t)b * T + t0 + row) * C;
        const bool ok0 = t0 + row < T, ok1 = t0 + row + 8 < T;
        for (int hf = 0; hf < halves; ++hf) {
          clear();
          for (int cb = 0; cb < kc; ++cb) kblock(true, h_rows + cb * WG_A_BYTES, ksteps(C, cb));
          drain();
          const int n0 = hf * BN;
          const bool full_n = n0 + BN <= C;
          if (!full_n)
            store_out_part<BN, B16>(acc, xin, p.out, yn, cols, C, n0, col, at0, ok0, ok1, next);
          else if (next)
            store_out<BN, true, B16>(acc, xin, p.out, yn, cols, C, n0, col, at0, ok0, ok1);
          else
            store_out<BN, false, B16>(acc, xin, p.out, yn, cols, C, n0, col, at0, ok0, ok1);
        }
        // The next tile's conv7 epilogue rewrites h: every wgmma of this
        // warpgroup that read it has completed (wait_group 0 above).
      }
    }
    if (u + 1 < p.units) {
      fence_async_global();
      grid_sync(p.bar);
    }
  }
}

template <int BN, bool B16>
cudaError_t launch(const ResArgs& p, const void* w7s, const void* w1s, int smem,
                   cudaStream_t st) {
  const int B = p.B, T = p.T, C = p.C, U = p.units;
  CUtensorMap y0m, y1m, w7m, w1m;
  const cuuint64_t y_dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t y_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t y_box[3] = {WG_BK, WG_BM, 1};
  cudaError_t e = wg_tensor_map(&y0m, p.y, 3, y_dims, y_strides, y_box);
  if (e != cudaSuccess) return e;
  e = wg_tensor_map(&y1m, p.y + (size_t)B * T * C, 3, y_dims, y_strides, y_box);
  if (e != cudaSuccess) return e;
  // w7s [U, 7, C, C] as [U * 7][Cin][Cout], w1s [U, C, C] as [U][Cin][Cout].
  const cuuint64_t w7_dims[3] = {(cuuint64_t)C, (cuuint64_t)C, (cuuint64_t)U * 7};
  const cuuint64_t w1_dims[3] = {(cuuint64_t)C, (cuuint64_t)C, (cuuint64_t)U};
  const cuuint64_t w_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t w_box[3] = {64, WG_BK, 1};
  e = wg_tensor_map(&w7m, w7s, 3, w7_dims, w_strides, w_box);
  if (e != cudaSuccess) return e;
  e = wg_tensor_map(&w1m, w1s, 3, w1_dims, w_strides, w_box);
  if (e != cudaSuccess) return e;
  static int smem_set = 0;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(res_units_kernel<BN, B16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  // The grid: every CTA must be resident at once for the barrier, at this
  // dynamic shared memory (one CTA an SM at the decode's shapes).
  int dev, nsm, per_sm;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, res_units_kernel<BN, B16>, WG_THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)B * ((T + WG_BM - 1) / WG_BM);
  const int grid = (int)(tiles < (long long)per_sm * nsm ? tiles : (long long)per_sm * nsm);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  e = cudaMemsetAsync(p.bar, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  ResArgs args = p;
  void* kargs[] = {&y0m, &y1m, &w7m, &w1m, &args};
  e = cudaLaunchCooperativeKernel((const void*)res_units_kernel<BN, B16>, dim3(grid), dim3(WG_THREADS),
                                  kargs, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// snake_batch (8 a thread) and snake() side by side, for a test.
__global__ void snake_check_kernel(const float* x, const float* a, float* got, float* ref, int n) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i0 >= n) return;
  float xs[8], as[8], inv[8], ys[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xs[j] = x[i0 + j];
    as[j] = a[i0 + j];
    inv[j] = snake_inv(as[j]);
  }
  snake_batch(xs, as, inv, ys);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    got[i0 + j] = ys[j];
    ref[i0 + j] = snake(xs[j], as[j]);
  }
}

}  // namespace

// got[i]: the kernel's batched snake of x[i], a[i]; ref[i] = snake(x[i],
// a[i]) (n a multiple of 8).
extern "C" int res_snake_check(const float* x, const float* a, float* got, float* ref, int n,
                               void* stream) {
  snake_check_kernel<<<(n / 8 + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, a, got, ref, n);
  return cudaGetLastError();
}

// x, out [B, T, C] fp32; y [2, B, T, C] bf16 scratch; bar 2 x u32 scratch;
// w7s [U, 7, C, C], w1s [U, C, C] bf16 ([K, Cin, Cout]); b7s, b1s, a1s, a2s
// [U, C] fp32; U units with dilations d0, d1, d2; all 16-byte aligned.  A
// column tile of bn (96 or 192) and a ring of `stages` stages in `smem`
// bytes of dynamic shared memory (ops/dac_kernels.py:_res_plan).  Needs C % 8 == 0 and C <= 384 (the
// wrapper checks).  b16: the snakes in the bf16 mode (snake.cuh).
extern "C" int res_units(const void* x, void* out, void* y, void* bar, const void* w7s,
                         const void* b7s, const void* w1s, const void* b1s, const void* a1s,
                         const void* a2s, int B, int T, int C, int units, int d0, int d1, int d2,
                         int bn, int stages, int smem, int b16, void* stream) {
  const ResArgs p{(const float*)x, (float*)out, (__nv_bfloat16*)y, (unsigned*)bar,
                  (const float*)b7s, (const float*)b1s, (const float*)a1s, (const float*)a2s,
                  B, T, C, units, stages, {d0, d1, d2}};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 96: return b16 ? launch<96, true>(p, w7s, w1s, smem, st)
                        : launch<96, false>(p, w7s, w1s, smem, st);
    case 192: return b16 ? launch<192, true>(p, w7s, w1s, smem, st)
                         : launch<192, false>(p, w7s, w1s, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
