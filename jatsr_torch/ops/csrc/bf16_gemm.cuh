// The mma.sync bf16 GEMM of B7: an implicit-GEMM tile over shifted rows,
// mma.sync m16n8k16 with fp32 accumulation.  snake_tr.cu (B7) includes it
// (B6, B8 and B9 run bf16_wgmma.cuh's wgmma core); each csrc/*.cu is built
// into its own shared library, so everything here lives in an anonymous
// namespace.
//
// The product.  For a batch element b and a GEMM row r,
//   out[r, n] = sum_{tap < taps} sum_{c < Cin} A[r, tap, c] * W_tap[c, n]
//   A[r, tap, c] = y[b, r + shift0 + tap * shift_step, c], zero outside [0, T)
// with y a bf16 [B, T, Cin] activation and W_tap = w + tap * wtap a bf16
// [Cin, N] matrix in the JAX layout (N contiguous).  That one form carries
//   - the 7-tap dilated conv: taps 7, shift0 -3d, shift_step d, W = w7;
//   - the 1x1 conv: taps 1, no shift;
//   - one phase p of the polyphase transpose: row r is the input time t,
//     taps 2 (y[t] against w[p], y[t-1] against w[p+s]), shift_step -1.
// Zero rows outside [0, T) are the convs' zero padding: snake(0) = 0.
// The epilogue is a functor called with (b, r, n, v[n], v[n+1]).
//
// The tile: 128 x 64 outputs per CTA of 4 warps, each warp 32 rows x 64
// columns; K slabs of 32 copied with cp.async (16 bytes, zero-filled for
// rows outside [0, T), columns past Cin or N) into a two-stage ring.  B is
// read from shared memory with ldmatrix.trans, so the weight stays in its
// row-major [Cin, N] layout.  Needs Cin % 8 == 0 and N % 8 == 0 (16-byte
// chunks); the wrappers check.
//
// Rounding points: snake.cuh's; bf16 rounding is __float2bfloat16_rn.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "snake.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

constexpr int BM = 128, BN = 64, BK = 32, NT = 128;
constexpr int ASTR = BK + 8;  // smem row stride of A (bf16): conflict-free 32-bit loads
constexpr int BSTR = BN + 8;  // smem row stride of B (bf16): conflict-free ldmatrix

struct GemmSmem {
  __nv_bfloat16 a[2][BM * ASTR];
  __nv_bfloat16 b[2][BK * BSTR];
};

struct Gemm {
  const __nv_bfloat16* y;  // [B, T, Cin]
  const __nv_bfloat16* w;  // tap 0's [Cin, N]
  long long wtap;          // elements from one tap's matrix to the next
  int T, Cin, N, rows;     // rows: GEMM rows per batch element
  int taps, shift0, shift_step;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K slab kt (tap kt / kc, channels (kt % kc) * BK ..) of the tile at (m0, n0)
// into ring slot `slot`.
__device__ __forceinline__ void load_slab(const Gemm& g, int b, int m0, int n0, int kt, int kc,
                                          GemmSmem& sm, int slot) {
  const int tid = threadIdx.x;
  const int tap = kt / kc, c0 = (kt % kc) * BK;
  const int shift = g.shift0 + tap * g.shift_step;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // A: 128 rows x 4 chunks of 8 bf16
    const int idx = tid + NT * i, row = idx >> 2, col = c0 + (idx & 3) * 8;
    const int r = m0 + row, src = r + shift;
    const bool ok = r < g.rows && src >= 0 && src < g.T && col < g.Cin;
    const __nv_bfloat16* p = ok ? g.y + ((size_t)b * g.T + src) * g.Cin + col : g.y;
    cp16(sm.a[slot] + row * ASTR + (idx & 3) * 8, p, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: 32 rows (channels) x 8 chunks of 8 bf16
    const int idx = tid + NT * i, kr = idx >> 3, n = n0 + (idx & 7) * 8, c = c0 + kr;
    const bool ok = c < g.Cin && n < g.N;
    const __nv_bfloat16* p = ok ? g.w + tap * g.wtap + (size_t)c * g.N + n : g.w;
    cp16(sm.b[slot] + kr * BSTR + (idx & 7) * 8, p, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One 128 x 64 output tile at rows m0.., columns n0.. of batch element b.
// Warp w owns rows w*32 .. +31; acc[mt][nt][half*2 + e] is row
// w*32 + mt*16 + gid + half*8, column nt*8 + tig*2 + e.
template <class Epi>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int b, int m0, int n0, GemmSmem& sm,
                                          const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int kc = (g.Cin + BK - 1) / BK, nk = g.taps * kc;
  load_slab(g, b, m0, n0, 0, kc, sm, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_slab(g, b, m0, n0, kt + 1, kc, sm, (kt + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* As = sm.a[kt & 1];
    const __nv_bfloat16* Bs = sm.b[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = As + (warp * 32 + mt * 16 + gid) * ASTR + ks + tig * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ASTR);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ASTR + 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // Four 8x8 matrices, transposed on load: (k 0-7, n 0-7), (k 8-15,
        // n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of columns np*16 ..
        const int mi = lane >> 3, ri = lane & 7;
        const __nv_bfloat16* p = Bs + (ks + ri + (mi & 1) * 8) * BSTR + np * 16 + (mi >> 1) * 8;
        const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
        uint32_t r0, r1, r2, r3;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                     : "r"(addr));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], r0, r1);
          mma_bf16(acc[mt][2 * np + 1], af[mt], r2, r3);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + warp * 32 + mt * 16 + gid + half * 8;
      if (r >= g.rows) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + nt * 8 + tig * 2;
        if (n < g.N) epi(b, r, n, acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
      }
    }
}

}  // namespace
