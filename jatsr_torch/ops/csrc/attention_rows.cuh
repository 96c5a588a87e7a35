// The attention body with the exact row max and the scores computed once
// in registers, for head dims D of 16, 32, 64 and 128, shared by five
// epilogues:
//   natural  (attention_natural.cu, B15 and B16): s = (q @ k^T) * scale,
//       e = expf(s - m), w = bf16(e / l) correctly rounded, o = bf16(w @ v)
//   train    (attention_train.cu, B10's forward): q' = bf16(q * scale2),
//       s = q' @ k^T, e = exp2f(s - m), l summed before the dropout
//       zeroing, o = bf16((bf16(e) @ v) * (coef / l)), and the row max and
//       l written for the backward
//   deferred (attention_deferred.cu, B2 and B11): the train epilogue
//       without dropout or statistics (coef = 1); B11 takes the share of
//       its npad zero keys off l once, l - npad * exp2f(-m); B2 rotates q
//       and K by RoPE in shared memory first (ROPE)
//   normed   (flash_qkv.cu, B12): the deferred epilogue's base-2 scores
//       (RoPE inside, keys masked at n_valid) with the natural epilogue's
//       weights: w = bf16(e / l) correctly rounded, o = bf16(w @ v)
//   int8 v   (attention_deferred.cu, B2 with int8_qk): B2's scores and l,
//       then the value product s8 x s8 -> s32 (mma.sync m16n8k32): w_q =
//       rn(e * 127) from the unrounded e (its row max is exactly 1), v's
//       codes and per-column scales sv made before the launch
//       (v_codes_kernel), o = bf16((f32(acc) * (rcp_rn(l) * f32(1/127)))
//       * sv); V's codes sit in shared memory K-major ([D][nk + 16] bytes),
//       each 32-key block in the order the A fragments take e (kperm)
// Keys at or past the plan's `limit` are masked to -inf (N, but for B2
// its n_valid and for B11 N rounded up to 8, whose zero keys score 0 and
// take part in the max); m is the exact row max (a running max would round
// bf16(w) or bf16(e) against another max than the TPU kernels).
//
// Layout (see attention_natural.cu's header for the design):
//  - q, K and V come straight from the [B, N, H * D] views by 16-byte
//    cp.async at their row strides; rows at or past N are zero-filled by
//    cp.async's source size, and nothing is read for them.  Rows are padded
//    by 8 bf16 (2 D + 16 bytes: 48, 80 or 144), so each 8-row fragment load
//    hits 8 distinct 16-byte bank groups.  V stays row-major: the B operand
//    of w @ V comes from ldmatrix.x4.trans.  D enters as D / 16 k-steps of
//    the scores and D / 8 n-tiles of the output and its partials.
//  - A warp owns 16 query rows over a chunk of 128 keys (16 n-tiles x 4
//    fp32 = 64 score registers a thread); W = nk / 128 warps share a row
//    group and combine the row max, the row sum and their partial outputs
//    through shared memory in a fixed warp order, so no row's arithmetic
//    depends on the grid.
//  - A CTA takes its tiles in turn over K and V loaded once where they stay
//    resident, the next round's q in flight behind the current softmax.
//    The balanced grid (BAL) instead cuts the flattened (batch, head group,
//    tile) rounds into equal spans, one a CTA, and reloads K and V where a
//    span crosses into the next (batch, head group).
//  - The row groups share only K and V: where those stay resident, a row
//    group's warps wait for each other alone, on a named barrier.
//  The launch plan is ops/attention.py:_natural_plan (field for field).
#pragma once

#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "fdiv_rn.cuh"

// The launch plan of ops/attention.py:_natural_plan (field for field).
struct NaturalPlan {
  int N, nk, hq, hkv;
  int rows;     // query rows a round covers per head: 16 x row groups
  int W;        // warps sharing a row group, each over 128 keys (nk = 128 W)
  int heads;    // q-heads a CTA covers: 1 (B15) or G (B16)
  int hc;       // q-heads taken at once
  int head_rounds;  // heads / hc, rounded up
  int row_rounds;   // row tiles of `rows` a CTA takes in turn
  int resident;  // K and V in shared memory together
  int k_off, v_off, q_off, red_off, part_off;  // shared-memory byte offsets
  int span, total;  // train: rounds a CTA, of `total` (batch, y, round); else 0
  long long q_row, k_row, v_row;                // row strides (elements)
  float scale;  // natural: 1 / sqrt(D); train, deferred: bf16(scale * log2 e)
  int limit;    // keys at or past it are masked: N; B2 n_valid; B11 round_up(N, 8)
  int npad;     // deferred: zero keys below `limit` whose share comes off l; else 0
  int stream;   // 1: attention_stream.cuh's mode (K and V in 128-key chunks)
};

// The softmax epilogue of rows_attention (see the header).
enum class Epilogue { kNatural, kTrain, kDeferred, kNormed, kInt8V };

// The grid of rows_attention: its own (x, y, batch), the balanced one, or
// the one the plan's span names (0: its own).
enum class Grid { kOwn, kBalanced, kPlan };

// What the train epilogue adds: the dropout and the statistics.  One other
// reader: attention_wide.cu's kInt8V forward (B2 with int8_qk past head dim
// 128) takes `stats` as V's per-column scales sv [B, hkv, dp] fp32 and reads
// no other field, so that every other instance keeps its parameter layout.
struct TrainRows {
  float* stats;  // train: [B, hq, N, 2] fp32, row max, row sum of exp2;
                 // wide kInt8V: sv [B, hkv, dp] fp32 (read only)
  uint32_t seed, thr;
  int np;        // round_up(N, 8): the hash lattice
  int dropout;   // 0 or 1
  float coef;    // 1 / (1 - rate)
  int b0;        // the batch's first row in the global batch (the hash's b)
  int h0;        // the launch's first q head among all heads (the hash's h)
};

// The RoPE tables of B2 and B12, [N, D] fp32 each, read only with ROPE.
struct RopeTables {
  const float* cos;
  const float* sin;
};

namespace {

constexpr int NT = 16;         // n-tiles of 8 keys a warp holds: 128 keys
constexpr int MAX_WARPS = 16;  // warps a CTA: 16 x 32 x 128 registers, the whole file

// Warps a CTA at head dim D: 16 (128 registers a thread) up to D = 64; 8
// at D = 128, whose fp32 output tile alone is 64 registers a thread (255
// registers a thread, the whole file).
__host__ __device__ constexpr int max_warps(int D) { return D == 128 ? 8 : MAX_WARPS; }

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(x * s) of both halves of a bf16 pair, s a bf16 pair: one rounding of
// the exact product, as bf16(fp32(x) * fp32(s)).
__device__ __forceinline__ uint32_t mul_pair(uint32_t x, __nv_bfloat162 s) {
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&x), s);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// `bytes` (0..16) from src into 16 bytes of shared memory, the rest zero.
__device__ __forceinline__ void copy16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes from src into shared memory, or 16 zero bytes (nothing read).
__device__ __forceinline__ void copy16(unsigned dst, const void* src, bool valid) {
  copy16(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Rows [0, n) of one head (D wide) into shared memory at stride D + 8:
// row i from src + i * stride, zero where i >= N.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int n, int N) {
  constexpr int STR = D + 8, PARTS = D / 8, SH = ilog2(PARTS);
  const unsigned base = smem_u32(dst);
  for (int c = threadIdx.x; c < n * PARTS; c += blockDim.x) {
    const int i = c >> SH, part = c & (PARTS - 1);
    const bool ok = i < N;
    copy16(base + (i * STR + part * 8) * 2, ok ? src + i * stride + part * 8 : src, ok);
  }
}

// bf16(bf16(x * bf16(c)) + bf16(y * bf16(s))) for bf16 x and y: RoPE's
// half of one element, each operation rounded (the fp32 product of two
// bf16 values is exact, so each rounds once; no FMA contracts across a
// rounding).  The caller's store rounds the sum.
__device__ __forceinline__ float rope_half(float x, float y, float c, float s) {
  const float cb = __bfloat162float(__float2bfloat16_rn(c));
  const float sb = __bfloat162float(__float2bfloat16_rn(s));
  const float a = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, cb)));
  const float b = __bfloat162float(__float2bfloat16_rn(__fmul_rn(y, sb)));
  return __fadd_rn(a, b);
}

// RoPE (the half rotation: element d < D / 2 pairs with d + D / 2) in place
// on `n` rows of D at stride D + 8 in shared memory, row i at position
// pos0 + i; with SCALE then bf16(x * scale), one rounding.  Rows at
// positions at or past N (zero) are left alone.  Thread t of `threads`
// takes VEC adjacent elements of each half in turn.
template <int D, bool SCALE, int VEC>
__device__ __forceinline__ void rope_rows(__nv_bfloat16* x, int n, int pos0, int N,
                                          const RopeTables& rt, __nv_bfloat162 scale, int t,
                                          int threads) {
  constexpr int STR = D + 8, PER_ROW = D / 2 / VEC;
  for (int c = t; c < n * PER_ROW; c += threads) {
    const int i = c / PER_ROW, d = (c % PER_ROW) * VEC, pos = pos0 + i;
    if (pos >= N) break;  // c grows with i
#pragma unroll
    for (int h = 0; h < VEC; h += 2) {
      __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(x + i * STR + d + h);
      __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(x + i * STR + d + h + D / 2);
      const float* cr = rt.cos + (long long)pos * D + d + h;
      const float* sr = rt.sin + (long long)pos * D + d + h;
      const float2 cl = __ldg(reinterpret_cast<const float2*>(cr));
      const float2 ch = __ldg(reinterpret_cast<const float2*>(cr + D / 2));
      const float2 sl = __ldg(reinterpret_cast<const float2*>(sr));
      const float2 sh = __ldg(reinterpret_cast<const float2*>(sr + D / 2));
      const float2 a = __bfloat1622float2(*lo), b = __bfloat1622float2(*hi);
      __nv_bfloat162 a2 = __floats2bfloat162_rn(rope_half(a.x, -b.x, cl.x, sl.x),
                                                rope_half(a.y, -b.y, cl.y, sl.y));
      __nv_bfloat162 b2 = __floats2bfloat162_rn(rope_half(b.x, a.x, ch.x, sh.x),
                                                rope_half(b.y, a.y, ch.y, sh.y));
      if (SCALE) {
        a2 = __hmul2(a2, scale);
        b2 = __hmul2(b2, scale);
      }
      *lo = a2;
      *hi = b2;
    }
  }
}

// The A fragments of w @ V from e (s[nt][0..1] row gid, [2..3] row
// gid + 8) and the row sums l0, l1: w = bf16(e / l), 16 keys a k-step.
template <bool EXACT>
__device__ __forceinline__ void weights(const float (&s)[NT][4], uint32_t (&wa)[NT / 2][4],
                                        float l0, float l1) {
  const float y0 = reciprocal(l0), y1 = reciprocal(l1);
  auto w = [&](float e, int row) {
    const float l = row ? l1 : l0, y = row ? y1 : y0;
    return EXACT ? quotient(e, l, y) : markstein(e, l, y);
  };
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    wa[t][0] = pack2(w(s[2 * t][0], 0), w(s[2 * t][1], 0));
    wa[t][1] = pack2(w(s[2 * t][2], 1), w(s[2 * t][3], 1));
    wa[t][2] = pack2(w(s[2 * t + 1][0], 0), w(s[2 * t + 1][1], 0));
    wa[t][3] = pack2(w(s[2 * t + 1][2], 1), w(s[2 * t + 1][3], 1));
  }
}

// ---- the int8 value product (B2 with int8_qk) --------------------------------

constexpr float kInv127 = 0x1.020408p-7f;  // f32(1 / 127), the JAX package's _INV127

// The key that position p of a 32-key block of V's codes holds: the A
// fragment of m16n8k32 gives thread (gid, tig) the k positions tig * 4 +
// [0, 4) (and + 16), and the bf16 score tiles give it the keys tig * 2 +
// {0, 1} of n-tiles 2 i and 2 i + 1, so the codes are stored in that order
// and the e of a thread packs into its A fragment as it is (an exact int32
// sum does not depend on the order of its keys).
__host__ __device__ __forceinline__ int kperm(int p) {
  return (p & 16) | ((p & 2) << 2) | (((p >> 2) & 3) << 1) | (p & 1);
}

// rn(e * 127) of four e in [0, 1] as four s8 codes, the first lowest.
__device__ __forceinline__ uint32_t codes4(float a, float b, float c, float d) {
  return (uint32_t)__float2int_rn(__fmul_rn(a, 127.f)) |
         ((uint32_t)__float2int_rn(__fmul_rn(b, 127.f)) << 8) |
         ((uint32_t)__float2int_rn(__fmul_rn(c, 127.f)) << 16) |
         ((uint32_t)__float2int_rn(__fmul_rn(d, 127.f)) << 24);
}

// acc += rn(e * 127) @ V's codes over one chunk of 128 keys: e as the
// scores s[nt][..] hold it; vq the codes [D rows][stride vstr bytes] in
// shared memory, the chunk's keys from byte key0 (kperm order); B
// fragments by ldmatrix (8 d-rows x 16 keys a matrix).
template <int DT>
__device__ __forceinline__ void value_s8(int (&acc)[DT][4], const float (&e)[NT][4],
                                         const int8_t* vq, int vstr, int key0, int lane) {
#pragma unroll
  for (int t = 0; t < NT / 4; ++t) {
    uint32_t a[4];
    a[0] = codes4(e[4 * t][0], e[4 * t][1], e[4 * t + 1][0], e[4 * t + 1][1]);
    a[1] = codes4(e[4 * t][2], e[4 * t][3], e[4 * t + 1][2], e[4 * t + 1][3]);
    a[2] = codes4(e[4 * t + 2][0], e[4 * t + 2][1], e[4 * t + 3][0], e[4 * t + 3][1]);
    a[3] = codes4(e[4 * t + 2][2], e[4 * t + 2][3], e[4 * t + 3][2], e[4 * t + 3][3]);
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t b[4];
      ldsm4(b, smem_u32(vq + (dt * 8 + (lane & 7) + (lane >> 4) * 8) * vstr + key0 + t * 32 +
                        ((lane >> 3) & 1) * 16));
      mma_s8(acc[dt], a, b[0], b[1]);
      mma_s8(acc[dt + 1], a, b[2], b[3]);
    }
  }
}

// bf16((f32(acc) * f) * sv) of an output pair: f = rcp_rn(l) * f32(1/127).
__device__ __forceinline__ uint32_t s8_out(int a, int b, float f, float2 sv) {
  return pack2(__fmul_rn(__fmul_rn(__int2float_rn(a), f), sv.x),
               __fmul_rn(__fmul_rn(__int2float_rn(b), f), sv.y));
}

// `rows` rows of n code bytes (n a multiple of 16) from src (row stride
// src_row bytes) into shared memory at stride n + 16; thread t of
// `threads`.
__device__ __forceinline__ void load_codes(int8_t* dst, const int8_t* src, long long src_row,
                                           int rows, int n, int t, int threads) {
  const int parts = n / 16;
  const unsigned base = smem_u32(dst);
  for (int c = t; c < rows * parts; c += threads) {
    const int i = c / parts, part = c - i * parts;
    copy16(base + i * (n + 16) + part * 16, src + i * src_row + part * 16, true);
  }
}

// One CTA: blockIdx.x the group of row tiles, blockIdx.y the q-head (B15,
// B10) or the kv-head (B16, B2, B12), blockIdx.z the batch.  Warp w: key chunk
// j = w % W of the pair w / W, which is row group pair % R of head slot
// pair / R.  `tr` is read only by the train epilogue, `rt` only with
// ROPE.  DROP (train only): the dropout is on.  ROPE (deferred, normed and
// int8 v: B2, B12): q and K are rotated in shared memory before their
// product, and q is scaled there too (B11 and train scale q at its fragment
// load: the placements that left each kernel without spills; one rounding
// either way, after RoPE).  The int8 v epilogue reads `v` as V's codes
// [B, hkv, D, nk] s8 (v_codes_kernel) and `sv` [B, hkv, D] f32.
template <int D, Epilogue EPI, bool DROP, bool ROPE, Grid GRID>
__device__ __forceinline__ void rows_attention(const __nv_bfloat16* __restrict__ q,
                                               const __nv_bfloat16* __restrict__ k,
                                               const __nv_bfloat16* __restrict__ v,
                                               __nv_bfloat16* __restrict__ out, const NaturalPlan& p,
                                               const TrainRows& tr, const RopeTables& rt,
                                               const float* __restrict__ sv = nullptr) {
  constexpr bool NATURAL = EPI == Epilogue::kNatural, TRAIN = EPI == Epilogue::kTrain;
  constexpr bool I8V = EPI == Epilogue::kInt8V;
  constexpr bool BASE2 = !NATURAL;                           // q' scaled, exp2f
  constexpr bool NORMED = NATURAL || EPI == Epilogue::kNormed;  // w = bf16(e / l)
  constexpr int STR = D + 8, DT = D / 8;  // row stride (bf16); output n-tiles
  constexpr int DSH = ilog2(DT);
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + p.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + p.v_off);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + p.q_off);
  float* red = reinterpret_cast<float*>(smem + p.red_off);     // [2][pairs][W][16]
  float4* part = reinterpret_cast<float4*>(smem + p.part_off);  // [pairs][W][DT][32]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int W = p.W, N = p.N;
  const int limit = NATURAL || TRAIN ? N : p.limit;  // the plan's limit is N there
  const int j = warp % W, pair = warp / W, pairs = blockDim.x / 32 / W;
  const int R = p.rows / 16, r = pair % R, hs = pair / R;
  const int key0 = j * NT * 8;
  float* red_max = red + (pair * W) * 16;
  float* red_sum = red + ((pairs + pair) * W) * 16;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);  // exact: a bf16 value

  // Round rd of the CTA: batch b, q-heads head0 + [0, heads), row tile
  // `tile`, head slots hr * hc + [0, hc).  The grid's own (x, y, batch),
  // tile x * row_rounds + rd / head_rounds; balanced: round
  // blockIdx.x * span + rd of the flattened (batch, y, tile, hr) list, so
  // that the rounds spread evenly over the SMs.
  struct Round {
    int b, head0, tile, hr;
  };
  const int per_y = p.row_rounds * p.head_rounds;  // rounds of one (batch, y)
  const bool BAL = GRID == Grid::kBalanced || (GRID == Grid::kPlan && p.span > 0);
  const int first = BAL ? blockIdx.x * p.span : 0;
  const int rounds = BAL ? min(p.span, p.total - first) : per_y;
  auto round_of = [&](int rd) {
    Round o;
    if (BAL) {
      const int f = first + rd, by = f / per_y, rr = f - by * per_y, ny = p.hq / p.heads;
      o.b = by / ny;
      o.head0 = (by - o.b * ny) * p.heads;
      o.tile = rr / p.head_rounds;
      o.hr = rr - o.tile * p.head_rounds;
    } else {
      o.b = blockIdx.z;
      o.head0 = blockIdx.y * p.heads;
      o.tile = blockIdx.x * p.row_rounds + rd / p.head_rounds;
      o.hr = rd % p.head_rounds;
    }
    return o;
  };
  auto load_kv = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long stride, const Round& o) {
    const int kvh = o.head0 / (p.hq / p.hkv);
    load_rows<D>(dst, src + (long long)o.b * N * stride + kvh * D, stride, p.nk, N);
  };
  auto load_v = [&](const Round& o) {  // V, or (int8 v) V's codes [D][nk + 16]
    if (I8V) {
      const int kvh = o.head0 / (p.hq / p.hkv);
      load_codes(reinterpret_cast<int8_t*>(vs),
                 reinterpret_cast<const int8_t*>(v) + ((long long)o.b * p.hkv + kvh) * D * p.nk,
                 p.nk, D, p.nk, threadIdx.x, blockDim.x);
    } else {
      load_kv(vs, v, p.v_row, o);
    }
  };
  auto load_q = [&](int rd) {  // the pair's 16 rows, by its own warps; zero past N or the heads
    const Round o = round_of(rd);
    const unsigned base = smem_u32(qs + pair * 16 * STR);
    const int slot = o.hr * p.hc + hs;
    for (int c = j * 32 + lane; c < 16 * DT; c += W * 32) {
      const int i = c >> DSH, part8 = c & (DT - 1);
      const int row = o.tile * p.rows + r * 16 + i;
      const bool ok = slot < p.heads && row < N;
      const __nv_bfloat16* src = q + ((long long)o.b * N + (ok ? row : 0)) * p.q_row +
                                 (o.head0 + (ok ? slot : 0)) * D + part8 * 8;
      copy16(base + (i * STR + part8 * 8) * 2, src, ok);
    }
  };
  // The pairs share only K and V.  Where those stay resident for the CTA's
  // life and the partial outputs have a buffer of their own, a pair's
  // warps wait for each other alone (a named barrier a pair) once K and V
  // have landed (round 0), so one pair's softmax overlaps another's
  // products; otherwise the whole CTA waits together.
  const bool whole = !p.resident || (W > 1 && p.part_off == p.k_off);
  auto sync = [&](bool cta) {
    if (cta)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pair), "r"(W * 32) : "memory");
  };
  // cp.async groups: [K, q of round 0] then [V] where K and V are resident
  // together (balanced: [K], [V] again where the batch or y changes); else
  // [K (+ q of round 0)] each round and [V] after the scores.  The next
  // round's q is one more group, issued once the pair's scores are done
  // with its q rows.
  if (p.resident) {
    const Round o = round_of(0);
    load_kv(ks, k, p.k_row, o);
    load_q(0);
    commit();
    load_v(o);  // lands while the scores run
    commit();
  }
  for (int rd = 0; rd < rounds; ++rd) {
    const Round cur = round_of(rd);
    bool fresh = rd == 0;  // K and V land in this round
    if (BAL && p.resident && rd > 0) {
      const Round before = round_of(rd - 1);
      if (before.b != cur.b || before.head0 != cur.head0) {
        fresh = true;
        __syncthreads();  // every pair is done with the last K and V
        load_kv(ks, k, p.k_row, cur);
        commit();
        load_v(cur);
        commit();
      }
    }
    if (!p.resident) {
      load_kv(ks, k, p.k_row, cur);
      if (rd == 0) load_q(0);
      commit();
    }
    if (p.resident && fresh)
      wait_copies<1>();
    else
      wait_copies<0>();
    sync(whole || fresh);
    if (ROPE) {  // K where it landed this round (every thread), the pair's q rows scaled
      const bool k_new = fresh || !p.resident;
      if (k_new) rope_rows<D, false, 2>(ks, p.nk, 0, N, rt, scale2, threadIdx.x, blockDim.x);
      rope_rows<D, true, 4>(qs + pair * 16 * STR, 16, cur.tile * p.rows + r * 16, N, rt, scale2,
                            j * 32 + lane, W * 32);
      sync(whole || k_new);
    }

    // s over the warp's keys: s[nt][0..1] row gid, s[nt][2..3] row gid + 8,
    // keys key0 + nt*8 + tig*2 + {0, 1}.  natural: (q @ k^T) * scale; the
    // base-2 epilogues: q' @ k^T, q' = bf16(q * scale2).  The depth (kk)
    // outermost: one q fragment live at a time.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldsm4(qa, smem_u32(qs + (pair * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + kk * 16 +
                         (lane >> 4) * 8));
      if (BASE2 && !ROPE) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = mul_pair(qa[i], scale2);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kb[4];
        ldsm4(kb, smem_u32(ks + (key0 + nt * 8 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                           ((lane >> 3) & 1) * 8));
        mma_bf16(s[nt], qa, kb[0], kb[1]);
        mma_bf16(s[nt + 1], qa, kb[2], kb[3]);
      }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (NATURAL) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = __fmul_rn(s[nt][i], p.scale);
      }
      if (key0 + nt * 8 + 8 > limit) {  // the tile reaches past the limit
        const int col = key0 + nt * 8 + tig * 2;
        if (col >= limit) s[nt][0] = s[nt][2] = -INFINITY;
        if (col + 1 >= limit) s[nt][1] = s[nt][3] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    if (tig == 0) {
      red_max[j * 16 + gid] = m0;
      red_max[j * 16 + gid + 8] = m1;
    }
    sync(whole);  // the pair's warps (or every warp: K's buffer) are done with K and q
    if (!p.resident) {
      load_v(cur);  // V takes K's buffer
      commit();
    }
    if (rd + 1 < rounds) load_q(rd + 1);
    commit();
    m0 = red_max[gid];
    m1 = red_max[gid + 8];
    for (int jj = 1; jj < W; ++jj) {
      m0 = fmaxf(m0, red_max[jj * 16 + gid]);
      m1 = fmaxf(m1, red_max[jj * 16 + gid + 8]);
    }

    // e = expf(s - m) (the base-2 epilogues: exp2f) in place, and the row
    // sums in a fixed order.
    float l0 = 0.f, l1 = 0.f;
    bool rare = false;  // a score below 2^-100: the exact divide's slow form
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (BASE2) {
        s[nt][0] = exp2f(__fsub_rn(s[nt][0], m0));
        s[nt][1] = exp2f(__fsub_rn(s[nt][1], m0));
        s[nt][2] = exp2f(__fsub_rn(s[nt][2], m1));
        s[nt][3] = exp2f(__fsub_rn(s[nt][3], m1));
      } else {
        s[nt][0] = expf(__fsub_rn(s[nt][0], m0));
        s[nt][1] = expf(__fsub_rn(s[nt][1], m0));
        s[nt][2] = expf(__fsub_rn(s[nt][2], m1));
        s[nt][3] = expf(__fsub_rn(s[nt][3], m1));
      }
      if (NORMED) rare |= tiny(s[nt][0]) | tiny(s[nt][1]) | tiny(s[nt][2]) | tiny(s[nt][3]);
      l0 = __fadd_rn(__fadd_rn(l0, s[nt][0]), s[nt][1]);
      l1 = __fadd_rn(__fadd_rn(l1, s[nt][2]), s[nt][3]);
    }
    if (NORMED) rare = __any_sync(0xffffffffu, rare);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // a + b == b + a: every lane of a quad agrees
      l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, o));
      l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, o));
    }
    if (tig == 0) {
      red_sum[j * 16 + gid] = l0;
      red_sum[j * 16 + gid + 8] = l1;
    }
    wait_copies<1>();  // V; the next round's q may still be landing
    sync(whole || fresh);
    l0 = red_sum[gid];
    l1 = red_sum[gid + 8];
    for (int jj = 1; jj < W; ++jj) {
      l0 = __fadd_rn(l0, red_sum[jj * 16 + gid]);
      l1 = __fadd_rn(l1, red_sum[jj * 16 + gid + 8]);
    }

    const int slot = cur.hr * p.hc + hs;
    const int ra = cur.tile * p.rows + r * 16 + gid;
    const int rb = ra + 8;
    const bool store = slot < p.heads;

    // train: the statistics of the row and its output factor coef / l
    // (correctly rounded), once a row, here so that m and l die early.
    // (deferred: 1 / l after the value product.)
    float f0 = 1.f, f1 = 1.f;
    if (TRAIN) {
      if (j == 0 && tig == 0 && store) {
        float* sp = tr.stats + ((long long)cur.b * p.hq + cur.head0 + slot) * N * 2;
        if (ra < N) { sp[ra * 2] = m0; sp[ra * 2 + 1] = l0; }
        if (rb < N) { sp[rb * 2] = m1; sp[rb * 2 + 1] = l1; }
      }
      f0 = markstein(tr.coef, l0, reciprocal(l0));
      f1 = markstein(tr.coef, l1, reciprocal(l1));
    }

    // The A fragments of the value product, 16 keys a k-step.  natural and
    // normed: w = bf16(e / l), branch-free unless a score of the warp is
    // below 2^-100.  train: bf16(e) after the dropout zeroing (l is summed);
    // deferred: bf16(e).
    uint32_t wa[NT / 2][4];
    int iacc[DT][4];  // int8 v: the exact s32 product
    if (I8V) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) iacc[dt][0] = iacc[dt][1] = iacc[dt][2] = iacc[dt][3] = 0;
      value_s8<DT>(iacc, s, reinterpret_cast<const int8_t*>(vs), p.nk + 16, key0, lane);
    } else if (!NORMED) {
      if (TRAIN && DROP && ra - gid < N) {  // the warp holds a row before N
        const uint32_t st = stream_of(cur.b + tr.b0, tr.h0 + cur.head0 + slot, tr.seed);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = key0 + nt * 8 + tig * 2;
          if (key0 + nt * 8 >= N) break;  // e is 0 past N
          if (!kept(st, ra, col, tr.np, tr.thr)) s[nt][0] = 0.f;
          if (!kept(st, ra, col + 1, tr.np, tr.thr)) s[nt][1] = 0.f;
          if (!kept(st, rb, col, tr.np, tr.thr)) s[nt][2] = 0.f;
          if (!kept(st, rb, col + 1, tr.np, tr.thr)) s[nt][3] = 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
        wa[t][0] = pack2(s[2 * t][0], s[2 * t][1]);
        wa[t][1] = pack2(s[2 * t][2], s[2 * t][3]);
        wa[t][2] = pack2(s[2 * t + 1][0], s[2 * t + 1][1]);
        wa[t][3] = pack2(s[2 * t + 1][2], s[2 * t + 1][3]);
      }
    } else if (rare) {
      weights<true>(s, wa, l0, l1);
    } else {
      weights<false>(s, wa, l0, l1);
    }
    float acc[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    if (!I8V) {
#pragma unroll
      for (int t = 0; t < NT / 2; ++t) {
        const int key = key0 + t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t vb[4];
          ldsm4t(vb, smem_u32(vs + key * STR + (dt + (lane >> 4)) * 8));
          mma_bf16(acc[dt], wa[t], vb[0], vb[1]);
          mma_bf16(acc[dt + 1], wa[t], vb[2], vb[3]);
        }
      }
    }

    if (EPI == Epilogue::kDeferred || I8V) {
      // 1 / l (correctly rounded) from the row sums in shared memory, again
      // in warp order, so that l is not live across the product; B11 first
      // takes its zero keys' share off the combined l, once.
      f0 = red_sum[gid];
      f1 = red_sum[gid + 8];
      for (int jj = 1; jj < W; ++jj) {
        f0 = __fadd_rn(f0, red_sum[jj * 16 + gid]);
        f1 = __fadd_rn(f1, red_sum[jj * 16 + gid + 8]);
      }
      if (!ROPE && p.npad) {
        float a = red_max[gid], b = red_max[gid + 8];
        for (int jj = 1; jj < W; ++jj) {
          a = fmaxf(a, red_max[jj * 16 + gid]);
          b = fmaxf(b, red_max[jj * 16 + gid + 8]);
        }
        f0 = __fsub_rn(f0, __fmul_rn((float)p.npad, exp2f(-a)));
        f1 = __fsub_rn(f1, __fmul_rn((float)p.npad, exp2f(-b)));
      }
      f0 = markstein(1.f, f0, reciprocal(f0));
      f1 = markstein(1.f, f1, reciprocal(f1));
      if (I8V) {
        f0 = __fmul_rn(f0, kInv127);
        f1 = __fmul_rn(f1, kInv127);
      }
    }
    auto out_pair = [&](float x, float y, float f) {
      return NORMED ? pack2(x, y) : pack2(__fmul_rn(x, f), __fmul_rn(y, f));
    };
    // int8 v: the scales of a pair of columns, dt * 8 + tig * 2 + {0, 1}.
    auto sv2 = [&](int dt) {
      const int kvh = cur.head0 / (p.hq / p.hkv);
      return *reinterpret_cast<const float2*>(sv + ((long long)cur.b * p.hkv + kvh) * D + dt * 8 +
                                              tig * 2);
    };

    // The W partial outputs added in warp order, rounded once.
    __nv_bfloat16* dst = out + (long long)cur.b * N * p.hq * D + (cur.head0 + slot) * D + tig * 2;
    const long long ostr = (long long)p.hq * D;
    if (I8V && W == 1) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const float2 sc = sv2(dt);
        if (store && ra < N)
          *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = s8_out(iacc[dt][0], iacc[dt][1], f0, sc);
        if (store && rb < N)
          *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = s8_out(iacc[dt][2], iacc[dt][3], f1, sc);
      }
    } else if (I8V) {  // the W partial products added as exact s32 sums
      int4* ipart = reinterpret_cast<int4*>(part);
      int4* mine = ipart + (pair * W + j) * DT * 32 + lane;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        mine[dt * 32] = make_int4(iacc[dt][0], iacc[dt][1], iacc[dt][2], iacc[dt][3]);
      sync(whole);
      const int4* all = ipart + pair * W * DT * 32 + lane;
      for (int dt = j; dt < DT; dt += W) {
        int4 a = all[dt * 32];
        for (int jj = 1; jj < W; ++jj) {
          const int4 c = all[(jj * DT + dt) * 32];
          a.x += c.x;
          a.y += c.y;
          a.z += c.z;
          a.w += c.w;
        }
        const float2 sc = sv2(dt);
        if (store && ra < N) *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = s8_out(a.x, a.y, f0, sc);
        if (store && rb < N) *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = s8_out(a.z, a.w, f1, sc);
      }
    } else if (W == 1) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        if (store && ra < N)
          *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = out_pair(acc[dt][0], acc[dt][1], f0);
        if (store && rb < N)
          *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = out_pair(acc[dt][2], acc[dt][3], f1);
      }
    } else {
      float4* mine = part + (pair * W + j) * DT * 32 + lane;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        mine[dt * 32] = make_float4(acc[dt][0], acc[dt][1], acc[dt][2], acc[dt][3]);
      sync(whole);
      const float4* all = part + pair * W * DT * 32 + lane;
      for (int dt = j; dt < DT; dt += W) {
        float4 a = all[dt * 32];
        for (int jj = 1; jj < W; ++jj) {
          const float4 c = all[(jj * DT + dt) * 32];
          a.x = __fadd_rn(a.x, c.x);
          a.y = __fadd_rn(a.y, c.y);
          a.z = __fadd_rn(a.z, c.z);
          a.w = __fadd_rn(a.w, c.w);
        }
        if (store && ra < N) *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = out_pair(a.x, a.y, f0);
        if (store && rb < N) *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = out_pair(a.z, a.w, f1);
      }
    }
    if (rd + 1 < rounds) sync(whole);  // K/V, the sums and partials are reused
  }
}

}  // namespace
