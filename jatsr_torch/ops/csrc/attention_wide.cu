// The attention kernels at head dims past 128, for Hopper: B2, B11, B12,
// B15, B16 and B10's forward and backward, one source.
//
// Replaces, at those head dims, the same TPU kernels as the instances of
// attention_rows.cuh (D <= 128): gqa_attention (B15), gqa_attention_grouped
// (B16), gqa_attention_flash (B11), gqa_attention_flash_qkv (B2),
// gqa_attention_flash_out (B12) in the JAX package's ops/attention.py, and
// the forward and backward kernels of gqa_attention_train (B10) in
// ops/attention_train.py.  JAX's kernels take any head dim; the body of
// attention_rows.cuh holds a head's fp32 output row in registers, which at
// D = 128 is already 64 of a thread's 255.  The wrappers pad a head dim D
// past 128 with zero columns to dp, a multiple of 128 (ops/attention.py:
// padded_head_dim, pad_heads: RoPE's halves kept apart), and launch here.
//
// Each kernel keeps the rounding points of its D <= 128 instance (see
// attention_rows.cuh, attention_stream.cuh and attention_train.cu):
//   natural  s = (q @ k^T) * scale, e = expf(s - m), w = bf16(e / l)
//            correctly rounded, o = bf16(w @ v)
//   deferred q' = bf16(q * scale2), s = q' @ k^T, e = exp2f(s - m),
//            o = bf16((bf16(e) @ v) * rcp_rn(l')), l' = l - npad exp2f(-m)
//   normed   the deferred scores with the natural weights
//   int8 v   the deferred scores and l, o = bf16((f32(rn(e * 127) @ vq)
//            * (rcp_rn(l) * f32(1/127))) * sv), the s32 product over each
//            key chunk on V's codes (B2 with int8_qk: attention_v_codes in
//            attention_deferred.cu makes them, [B, hkv, dp, nk] s8 K-major,
//            and sv [B, hkv, dp]; a column group reads its 128 rows)
//   train    the deferred scores, l before the dropout zeroing, o =
//            bf16((bf16(e) @ v) * (coef / l)), (m, l) written
//   backward p = exp2f(s - m) / l, dw = (do v^T) kc, wd = p kc, ds =
//            bf16(p (dw - delta) scale), dv = bf16(wd)^T do, dk = ds^T q,
//            dq = ds k, each summed in fp32 and rounded once
// with the exact row max (no online softmax); B12's out projection behind
// it as at D <= 128 (s8_dequant.cuh: s8_rows.cuh's row quant, then the s8
// wgmma GEMM on the weight K-major).  B2 and B12 rotate q and K
// first in a launch of their own (wide_rope: rope_half, q scaled after,
// the same operations as rope_rows in shared memory) into a [B, N, H, dp]
// scratch; the attention then reads q' as it is.
//
// Design (mma.sync m16n8k16 bf16, fp32 accumulation; the streaming mode's
// three passes).  A CTA of 4 warps covers 64 query rows of one q-head and
// one output column group of 128 (grid: row tiles, q-head x dp / 128
// groups, batch); warp w owns 16 rows.  Keys pass in chunks of 128: the
// scores of a chunk are the sum over dp / 128 depth chunks, each staged in
// shared memory as the CTA's q rows and the chunk's K columns (rows of 136
// bf16); summed in fp32 in depth order.  Pass 1 takes the exact row max,
// pass 2 l under it (per chunk: a thread over its columns, the quad, then
// onto l in chunk order), pass 3 the weights and w @ V over the group's
// 128 columns of V.  Every group recomputes the same scores, so all groups
// agree on every weight bit for bit; only group 0 writes B10's statistics.
// B15 and B16 are the same launch (no row's arithmetic depends on the
// grid), so they stay bit-equal.
// B10's backward: a row launch (delta = rowsum(do * o), and (m, l,
// rcp_rn(l), delta) a row), then dk/dv on CTAs of 64 keys (warp w 16 of
// them, the G heads' rows in slices of 32, the scores and do v^T over the
// depth chunks, dk and dv of one column group in registers) and dq on CTAs
// of 64 rows (the keys in chunks of 64, dq of one group in registers).  No
// atomics: two runs give bit-equal gradients.
//
// What bounds it: at D = 256 and the serving shape (q [6, 345, 20, 256])
// the scores are 3 x 1.46 G and the value product 1.46 G bf16 FLOP a
// group, two groups (12 G FLOP: 12 us at the 989 TFLOP/s peak) against 34
// MB of q, k, v and o (10 us at 3.35 TB/s).  This version stages each
// depth chunk once a use and waits for it (no double buffering; two CTAs
// an SM overlap one another's loads); a later version's work is the
// wgmma accumulators this shape asks for.  Needs dp % 128 == 0.

#include "attention_rows.cuh"
#include "s8_dequant.cuh"
#include "s8_split.cuh"

// The launch of the wide forward and the rope pass (ops/attention.py:
// _wide_plan, field for field).
struct WidePlan {
  int N, hq, hkv, dp;
  int groups;     // dp / 128: output column groups (grid y = q-head x groups)
  long long q_row, k_row, v_row;  // row strides (elements)
  float scale;    // natural: 1 / sqrt(D); the base-2 epilogues: bf16(scale * log2 e)
  int limit;      // keys at or past it are masked: N; B2, B12 n_valid; B11 round_up(N, 8)
  int npad;       // B11: zero keys below `limit` whose share comes off l; else 0
  int prescaled;  // q is already q' (B2, B12: rotated and scaled by wide_rope)
};

// B10's backward (ops/attention_train.py, the wide plan).
struct WideBwdPlan {
  int N, hq, hkv, dp, groups;
  int np, dropout;
  uint32_t seed, thr;
  float scale2, scale, coef;
  int b0;  // the batch's first row in the global batch (the hash's b)
  int h0;  // the launch's first q head among all heads (the hash's h)
};

namespace {

constexpr int WCOL = 128;         // a depth chunk and an output column group
constexpr int WSTR = WCOL + 8;    // bf16 row stride in shared memory
constexpr int WROWS = 64;         // query rows a forward CTA (4 warps x 16)
constexpr int WKEYS = NT * 8;     // keys a forward chunk: 128
constexpr int BKEYS = 64;         // keys a backward CTA (dk/dv) or chunk (dq)
constexpr int BSUB = 32;          // query rows of a dk/dv slice
constexpr int BS = BSUB / 8;      // its n-tiles

// Rows [r0, r0 + n) of 128 columns from column c0 of src (row stride
// `stride`) into dst at stride WSTR, zero past N; the CTA's threads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int n, int r0, int c0, int N) {
  for (int c = threadIdx.x; c < n * 16; c += blockDim.x) {
    const int i = c >> 4, part = c & 15, row = r0 + i;
    const bool ok = row < N;
    copy16(smem_u32(dst + i * WSTR + part * 8), src + (long long)(ok ? row : 0) * stride + c0 + part * 8,
           ok);
  }
}

// The A fragment of 16 rows of a tile at k-step kk (rows r0.. of dst).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* t, int r0, int kk,
                                       int lane) {
  ldsm4(a, smem_u32(t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * WSTR + kk * 16 + (lane >> 4) * 8));
}

// B fragments of 16 rows (keys) of a tile at k-step kk, as two n-tiles.
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* t, int r0, int kk,
                                       int lane) {
  ldsm4(b, smem_u32(t + (r0 + (lane & 7) + (lane >> 4) * 8) * WSTR + kk * 16 + ((lane >> 3) & 1) * 8));
}

// ---- the forward ------------------------------------------------------------
// The int8 v epilogue reads `v` as V's codes and their scales sv through
// tr.stats (the rule is stated at TrainRows in attention_rows.cuh).
template <Epilogue EPI, bool DROP>
__global__ void __launch_bounds__(128) wide_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                                                       const __nv_bfloat16* __restrict__ k,
                                                       const __nv_bfloat16* __restrict__ v,
                                                       __nv_bfloat16* __restrict__ out,
                                                       const WidePlan p, const TrainRows tr) {
  constexpr bool NATURAL = EPI == Epilogue::kNatural, TRAIN = EPI == Epilogue::kTrain;
  constexpr bool I8V = EPI == Epilogue::kInt8V;
  constexpr bool NORMED = NATURAL || EPI == Epilogue::kNormed;
  constexpr int DT = WCOL / 8;  // output n-tiles of the group
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][WSTR]
  __nv_bfloat16* ks = qs + WROWS * WSTR;                        // [128][WSTR]
  __nv_bfloat16* vs = ks + WKEYS * WSTR;                        // [128][WSTR]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int N = p.N, limit = NATURAL || TRAIN ? N : p.limit;
  const int b = blockIdx.z, head = blockIdx.y / p.groups, grp = blockIdx.y % p.groups;
  const int kvh = head / (p.hq / p.hkv);
  const int row0 = blockIdx.x * WROWS, ra = row0 + warp * 16 + gid, rb = ra + 8;
  const int chunks = (N + WKEYS - 1) / WKEYS;
  const __nv_bfloat16* qb = q + (long long)b * N * p.q_row + (long long)head * p.dp;
  const __nv_bfloat16* kb = k + (long long)b * N * p.k_row + (long long)kvh * p.dp;
  const __nv_bfloat16* vb = v + (long long)b * N * p.v_row + (long long)kvh * p.dp + grp * WCOL;
  const int nk = (N + WKEYS - 1) / WKEYS * WKEYS;  // int8 v: the codes' key stride
  const int8_t* vq = reinterpret_cast<const int8_t*>(v) +
                     (((long long)b * p.hkv + kvh) * p.dp + grp * WCOL) * nk;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);  // exact: a bf16 value
  const bool scale_q = !NATURAL && !p.prescaled;

  // The scores of key chunk c (and, with_v, V's chunk of the group into
  // vs): s[nt][0..1] row ra, [2..3] row rb, keys c * 128 + nt * 8 + tig * 2
  // + {0, 1}; -inf at or past the limit.
  auto scores = [&](float (&s)[NT][4], int c, bool with_v) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int dc = 0; dc < p.groups; ++dc) {
      __syncthreads();  // every warp is done with the last stage (and V)
      load_tile(qs, qb, p.q_row, WROWS, row0, dc * WCOL, N);
      load_tile(ks, kb, p.k_row, WKEYS, c * WKEYS, dc * WCOL, N);
      if (with_v && dc == 0 && I8V)
        load_codes(reinterpret_cast<int8_t*>(vs), vq + c * WKEYS, nk, WCOL, WKEYS, threadIdx.x,
                   blockDim.x);
      else if (with_v && dc == 0)
        load_tile(vs, vb, p.v_row, WKEYS, c * WKEYS, 0, N);
      commit();
      wait_copies<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WCOL / 16; ++kk) {
        uint32_t qa[4];
        frag_a(qa, qs, warp * 16, kk, lane);
        if (scale_q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = mul_pair(qa[i], scale2);
        }
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kf[4];
          frag_b(kf, ks, nt * 8, kk, lane);
          mma_bf16(s[nt], qa, kf[0], kf[1]);
          mma_bf16(s[nt + 1], qa, kf[2], kf[3]);
        }
      }
    }
    const int key0 = c * WKEYS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (NATURAL) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = __fmul_rn(s[nt][i], p.scale);
      }
      if (key0 + nt * 8 + 8 > limit) {
        const int col = key0 + nt * 8 + tig * 2;
        if (col >= limit) s[nt][0] = s[nt][2] = -INFINITY;
        if (col + 1 >= limit) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }
  };
  auto exps = [&](float (&s)[NT][4], float m0, float m1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (NATURAL) {
        s[nt][0] = expf(__fsub_rn(s[nt][0], m0));
        s[nt][1] = expf(__fsub_rn(s[nt][1], m0));
        s[nt][2] = expf(__fsub_rn(s[nt][2], m1));
        s[nt][3] = expf(__fsub_rn(s[nt][3], m1));
      } else {
        s[nt][0] = exp2f(__fsub_rn(s[nt][0], m0));
        s[nt][1] = exp2f(__fsub_rn(s[nt][1], m0));
        s[nt][2] = exp2f(__fsub_rn(s[nt][2], m1));
        s[nt][3] = exp2f(__fsub_rn(s[nt][3], m1));
      }
    }
  };

  // 1. The exact row max.
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int c = 0; c < chunks; ++c) {
    float s[NT][4];
    scores(s, c, false);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // 2. l = sum(e) under that max, chunk by chunk.
  float l0 = 0.f, l1 = 0.f;
  for (int c = 0; c < chunks; ++c) {
    float s[NT][4];
    scores(s, c, false);
    exps(s, m0, m1);
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      c0 = __fadd_rn(__fadd_rn(c0, s[nt][0]), s[nt][1]);
      c1 = __fadd_rn(__fadd_rn(c1, s[nt][2]), s[nt][3]);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // a + b == b + a: every lane of a quad agrees
      c0 = __fadd_rn(c0, __shfl_xor_sync(0xffffffffu, c0, o));
      c1 = __fadd_rn(c1, __shfl_xor_sync(0xffffffffu, c1, o));
    }
    l0 = c == 0 ? c0 : __fadd_rn(l0, c0);
    l1 = c == 0 ? c1 : __fadd_rn(l1, c1);
  }

  // 3. The weights and the value product over the group's columns.
  const uint32_t st = TRAIN && DROP ? stream_of(b + tr.b0, tr.h0 + head, tr.seed) : 0u;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  int iacc[DT][4];  // int8 v: the exact s32 product
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) iacc[dt][0] = iacc[dt][1] = iacc[dt][2] = iacc[dt][3] = 0;
  for (int c = 0; c < chunks; ++c) {
    float s[NT][4];
    scores(s, c, true);
    exps(s, m0, m1);
    if (I8V) {
      value_s8<DT>(iacc, s, reinterpret_cast<const int8_t*>(vs), WKEYS + 16, 0, lane);
      continue;
    }
    const int key0 = c * WKEYS;
    uint32_t wa[NT / 2][4];
    if (NORMED) {
      bool rare = false;  // a score below 2^-100: the exact divide's slow form
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        rare |= tiny(s[nt][0]) | tiny(s[nt][1]) | tiny(s[nt][2]) | tiny(s[nt][3]);
      if (__any_sync(0xffffffffu, rare))
        weights<true>(s, wa, l0, l1);
      else
        weights<false>(s, wa, l0, l1);
    } else {
      if (TRAIN && DROP && ra - gid < N) {  // the warp holds a row before N
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
    }
#pragma unroll
    for (int t = 0; t < NT / 2; ++t) {
      const int key = t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vf[4];
        ldsm4t(vf, smem_u32(vs + key * WSTR + (dt + (lane >> 4)) * 8));
        mma_bf16(acc[dt], wa[t], vf[0], vf[1]);
        mma_bf16(acc[dt + 1], wa[t], vf[2], vf[3]);
      }
    }
  }

  float f0 = 1.f, f1 = 1.f;
  if (TRAIN) {
    if (grp == 0 && tig == 0) {
      float* sp = tr.stats + ((long long)b * p.hq + head) * N * 2;
      if (ra < N) { sp[ra * 2] = m0; sp[ra * 2 + 1] = l0; }
      if (rb < N) { sp[rb * 2] = m1; sp[rb * 2 + 1] = l1; }
    }
    f0 = markstein(tr.coef, l0, reciprocal(l0));
    f1 = markstein(tr.coef, l1, reciprocal(l1));
  } else if (!NORMED) {
    if (p.npad) {
      l0 = __fsub_rn(l0, __fmul_rn((float)p.npad, exp2f(-m0)));
      l1 = __fsub_rn(l1, __fmul_rn((float)p.npad, exp2f(-m1)));
    }
    f0 = markstein(1.f, l0, reciprocal(l0));
    f1 = markstein(1.f, l1, reciprocal(l1));
  }
  __nv_bfloat16* dst =
      out + (long long)b * N * p.hq * p.dp + (long long)head * p.dp + grp * WCOL + tig * 2;
  const long long ostr = (long long)p.hq * p.dp;
  if (I8V) {
    f0 = __fmul_rn(f0, kInv127);
    f1 = __fmul_rn(f1, kInv127);
    const float* svb = tr.stats + ((long long)b * p.hkv + kvh) * p.dp + grp * WCOL + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float2 sc = *reinterpret_cast<const float2*>(svb + dt * 8);
      if (ra < N) *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = s8_out(iacc[dt][0], iacc[dt][1], f0, sc);
      if (rb < N) *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = s8_out(iacc[dt][2], iacc[dt][3], f1, sc);
    }
    return;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const float x0 = NORMED ? acc[dt][0] : __fmul_rn(acc[dt][0], f0);
    const float x1 = NORMED ? acc[dt][1] : __fmul_rn(acc[dt][1], f0);
    const float y0 = NORMED ? acc[dt][2] : __fmul_rn(acc[dt][2], f1);
    const float y1 = NORMED ? acc[dt][3] : __fmul_rn(acc[dt][3], f1);
    if (ra < N) *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = pack2(x0, x1);
    if (rb < N) *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = pack2(y0, y1);
  }
}

// ---- B2's and B12's RoPE: q' = bf16(rope(q) * scale2), k' = rope(k) --------
// x [B, N, *] at row stride x_row, H heads of dp from column 0 -> out [B,
// N, H, dp] contiguous.  Thread t takes two adjacent elements of a head's
// first half and their partners dp / 2 along, as rope_rows (VEC 2).
template <bool SCALE>
__global__ void __launch_bounds__(256) wide_rope(const __nv_bfloat16* __restrict__ x,
                                                 long long x_row, int H, int dp, int N,
                                                 long long total, const float* __restrict__ cos_t,
                                                 const float* __restrict__ sin_t, float scale,
                                                 __nv_bfloat16* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int per = dp / 4, half = dp / 2;
  const int d = (int)(idx % per) * 2;
  const long long rest = idx / per;
  const int h = (int)(rest % H);
  const long long bn = rest / H;
  const int pos = (int)(bn % N);
  __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(out + (bn * H + h) * dp + d);
  __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(out + (bn * H + h) * dp + d + half);
  const __nv_bfloat16* src = x + bn * x_row + (long long)h * dp + d;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + half));
  const float* cr = cos_t + (long long)pos * dp + d;
  const float* sr = sin_t + (long long)pos * dp + d;
  const float2 cl = *reinterpret_cast<const float2*>(cr);
  const float2 ch = *reinterpret_cast<const float2*>(cr + half);
  const float2 sl = *reinterpret_cast<const float2*>(sr);
  const float2 sh = *reinterpret_cast<const float2*>(sr + half);
  __nv_bfloat162 a2 = __floats2bfloat162_rn(rope_half(a.x, -bv.x, cl.x, sl.x),
                                            rope_half(a.y, -bv.y, cl.y, sl.y));
  __nv_bfloat162 b2 = __floats2bfloat162_rn(rope_half(bv.x, a.x, ch.x, sh.x),
                                            rope_half(bv.y, a.y, ch.y, sh.y));
  if (SCALE) {
    const __nv_bfloat162 s2 = __float2bfloat162_rn(scale);
    a2 = __hmul2(a2, s2);
    b2 = __hmul2(b2, s2);
  }
  *lo = a2;
  *hi = b2;
}

// ---- B10's backward ---------------------------------------------------------

// Launch 1: one warp a (batch, q-head, row): (m, l, rcp_rn(l), delta) with
// delta = rowsum(do * o) in fp32 (a lane over its 8-column slices in
// order, then the warp's tree).  o, do [B, N, hq, dp]; stats [B, hq, N, 2].
__global__ void __launch_bounds__(256) wide_bwd_rows(const __nv_bfloat16* __restrict__ o,
                                                     const __nv_bfloat16* __restrict__ dout,
                                                     const float* __restrict__ stats,
                                                     float4* __restrict__ info, int N, int hq,
                                                     int dp, long long total) {
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= total) return;
  const int h = (int)(g % hq);
  const long long br = g / hq;
  const int row = (int)(br % N), b = (int)(br / N);
  const long long at = br * hq * dp + (long long)h * dp;
  float t = 0.f;
  for (int c = lane * 8; c < dp; c += 256) {
    const uint4 x = *reinterpret_cast<const uint4*>(dout + at + c);
    const uint4 y = *reinterpret_cast<const uint4*>(o + at + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&xs[i]);
      const __nv_bfloat162 cc = *reinterpret_cast<const __nv_bfloat162*>(&ys[i]);
      t = __fadd_rn(t, __fmul_rn(__bfloat162float(a.x), __bfloat162float(cc.x)));
      t = __fadd_rn(t, __fmul_rn(__bfloat162float(a.y), __bfloat162float(cc.y)));
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, s));
  if (lane == 0) {
    const long long bh = (long long)b * hq + h;
    const float* sp = stats + (bh * N + row) * 2;
    info[bh * N + row] = make_float4(sp[0], sp[1], reciprocal(sp[1]), t);
  }
}

// p, wd and ds of one score in place: s (e) becomes wd, w (do v^T) ds.
template <bool EXACT, bool DROP>
__device__ __forceinline__ void grads(const WideBwdPlan& p, float& s, float& w, const float4& ri,
                                      uint32_t st, int row, int key) {
  const float pr = EXACT ? quotient(s, ri.y, ri.z) : markstein(s, ri.y, ri.z);
  float dw = w, wd = pr;
  if (DROP) {
    const float kc = kept(st, row, key, p.np, p.thr) ? p.coef : 0.f;
    dw = __fmul_rn(dw, kc);
    wd = __fmul_rn(pr, kc);
  }
  s = wd;
  w = __fmul_rn(__fmul_rn(pr, __fsub_rn(dw, ri.w)), p.scale);
}

// dk and dv: grid (key tiles of 64, kv-head x groups, batch), 4 warps;
// warp w owns keys 64 x + 16 w .. + 15 and their dk, dv over the group's
// 128 columns.  The G heads' rows come in slices of 32.
template <bool DROP>
__global__ void __launch_bounds__(128) wide_bwd_dkdv(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float4* __restrict__ info, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const WideBwdPlan p) {
  constexpr int DT = WCOL / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][WSTR] K's depth chunk
  __nv_bfloat16* vst = kst + BKEYS * WSTR;                       // [64] V's
  __nv_bfloat16* qst = vst + BKEYS * WSTR;                       // [32] q's
  __nv_bfloat16* dst_ = qst + BSUB * WSTR;                       // [32] do's
  __nv_bfloat16* qg = dst_ + BSUB * WSTR;                        // [32] q, the group's columns
  __nv_bfloat16* dg = qg + BSUB * WSTR;                          // [32] do, the group's columns
  float4* inf = reinterpret_cast<float4*>(dg + BSUB * WSTR);     // [32] the rows' statistics
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int N = p.N, G = p.hq / p.hkv;
  const int b = blockIdx.z, kvh = blockIdx.y / p.groups, grp = blockIdx.y % p.groups;
  const int key0 = blockIdx.x * BKEYS, keyA = key0 + warp * 16 + gid;
  const bool live = key0 + warp * 16 < N;  // else the warp's scores are all 0
  const long long qd = (long long)p.hq * p.dp, kd = (long long)p.hkv * p.dp;
  const __nv_bfloat16* kb = k + (long long)b * N * kd + (long long)kvh * p.dp;
  const __nv_bfloat16* vb = v + (long long)b * N * kd + (long long)kvh * p.dp;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale2);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = 0; j < G; ++j) {
    const int h = kvh * G + j;
    const uint32_t st = DROP ? stream_of(b + p.b0, p.h0 + h, p.seed) : 0u;
    const __nv_bfloat16* qb = q + (long long)b * N * qd + (long long)h * p.dp;
    const __nv_bfloat16* db = dout + (long long)b * N * qd + (long long)h * p.dp;
    for (int r0 = 0; r0 < N; r0 += BSUB) {
      // s^T = k q'^T and w^T = v do^T: rows the warp's 16 keys, columns the
      // slice's 32 rows; [nt][0..1] key keyA, [2..3] keyA + 8, rows r0 +
      // nt * 8 + tig * 2 + {0, 1}.
      float s[BS][4] = {}, w[BS][4] = {};
      for (int dc = 0; dc < p.groups; ++dc) {
        __syncthreads();
        load_tile(kst, kb, kd, BKEYS, key0, dc * WCOL, N);
        load_tile(vst, vb, kd, BKEYS, key0, dc * WCOL, N);
        load_tile(qst, qb, qd, BSUB, r0, dc * WCOL, N);
        load_tile(dst_, db, qd, BSUB, r0, dc * WCOL, N);
        if (dc == 0) {
          load_tile(qg, qb, qd, BSUB, r0, grp * WCOL, N);
          load_tile(dg, db, qd, BSUB, r0, grp * WCOL, N);
          if (threadIdx.x < BSUB) {
            const int r = r0 + threadIdx.x;
            const bool ok = r < N;
            copy16(smem_u32(inf + threadIdx.x),
                   info + ((long long)b * p.hq + h) * N + (ok ? r : 0), ok);
          }
        }
        commit();
        wait_copies<0>();
        __syncthreads();
        if (!live) continue;
#pragma unroll
        for (int kk = 0; kk < WCOL / 16; ++kk) {
          uint32_t ka[4], va[4];
          frag_a(ka, kst, warp * 16, kk, lane);
          frag_a(va, vst, warp * 16, kk, lane);
#pragma unroll
          for (int n = 0; n < BS; n += 2) {
            uint32_t qb4[4], db4[4];
            frag_b(qb4, qst, n * 8, kk, lane);
            frag_b(db4, dst_, n * 8, kk, lane);
#pragma unroll
            for (int x = 0; x < 4; ++x) qb4[x] = mul_pair(qb4[x], scale2);
            mma_bf16(s[n], ka, qb4[0], qb4[1]);
            mma_bf16(s[n + 1], ka, qb4[2], qb4[3]);
            mma_bf16(w[n], va, db4[0], db4[1]);
            mma_bf16(w[n + 1], va, db4[2], db4[3]);
          }
        }
      }
      if (!live) continue;
      // e = exp2f(s - m) in place, zero where the row or the key is past N.
      const int row = r0 + tig * 2;  // + nt * 8 + (i & 1)
      bool rare = false;
#pragma unroll
      for (int nt = 0; nt < BS; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = row + nt * 8 + (x & 1), key = keyA + (x >> 1) * 8;
          const bool ok = r < N && key < N;
          s[nt][x] = ok ? exp2f(__fsub_rn(s[nt][x], inf[r - r0].x)) : 0.f;
          rare |= tiny(s[nt][x]);
        }
      }
      const bool exact = __any_sync(0xffffffffu, rare);
#pragma unroll
      for (int nt = 0; nt < BS; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = row + nt * 8 + (x & 1), key = keyA + (x >> 1) * 8;
          // rows past N: e is 0; l = 1 keeps the divide finite
          const float4 ri = r < N ? inf[r - r0] : make_float4(0.f, 1.f, 1.f, 0.f);
          if (exact)
            grads<true, DROP>(p, s[nt][x], w[nt][x], ri, st, r, key);
          else
            grads<false, DROP>(p, s[nt][x], w[nt][x], ri, st, r, key);
        }
      }
      // dv += bf16(wd)^T do, dk += ds^T q over the group's columns: A
      // fragments of 16 keys x 16 rows a k-step.
#pragma unroll
      for (int t = 0; t < BS / 2; ++t) {
        const uint32_t wa[4] = {pack2(s[2 * t][0], s[2 * t][1]), pack2(s[2 * t][2], s[2 * t][3]),
                                pack2(s[2 * t + 1][0], s[2 * t + 1][1]),
                                pack2(s[2 * t + 1][2], s[2 * t + 1][3])};
        const uint32_t da[4] = {pack2(w[2 * t][0], w[2 * t][1]), pack2(w[2 * t][2], w[2 * t][3]),
                                pack2(w[2 * t + 1][0], w[2 * t + 1][1]),
                                pack2(w[2 * t + 1][2], w[2 * t + 1][3])};
        const int vr = (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WSTR + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t r[4];
          ldsm4t(r, smem_u32(dg + vr + n * 8));
          mma_bf16(dva[n], wa, r[0], r[1]);
          mma_bf16(dva[n + 1], wa, r[2], r[3]);
          ldsm4t(r, smem_u32(qg + vr + n * 8));
          mma_bf16(dka[n], da, r[0], r[1]);
          mma_bf16(dka[n + 1], da, r[2], r[3]);
        }
      }
    }
  }
  const long long base = (long long)b * N * kd + (long long)kvh * p.dp + grp * WCOL + tig * 2;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    if (keyA < N) {
      *reinterpret_cast<uint32_t*>(dk + base + keyA * kd + n * 8) = pack2(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dv + base + keyA * kd + n * 8) = pack2(dva[n][0], dva[n][1]);
    }
    if (keyA + 8 < N) {
      *reinterpret_cast<uint32_t*>(dk + base + (keyA + 8) * kd + n * 8) = pack2(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dv + base + (keyA + 8) * kd + n * 8) = pack2(dva[n][2], dva[n][3]);
    }
  }
}

// dq: grid (row tiles of 64, q-head x groups, batch), 4 warps; warp w owns
// rows 64 x + 16 w .. + 15 and their dq over the group's 128 columns; the
// keys come in chunks of 64.
template <bool DROP>
__global__ void __launch_bounds__(128) wide_bwd_dq(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float4* __restrict__ info, __nv_bfloat16* __restrict__ dq, const WideBwdPlan p) {
  constexpr int DT = WCOL / 8, KT = BKEYS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qst = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][WSTR] q's depth chunk
  __nv_bfloat16* dst_ = qst + WROWS * WSTR;                      // [64] do's
  __nv_bfloat16* kst = dst_ + WROWS * WSTR;                      // [64 keys] K's
  __nv_bfloat16* vst = kst + BKEYS * WSTR;                       // [64 keys] V's
  __nv_bfloat16* kg = vst + BKEYS * WSTR;                        // [64 keys] K, the group's columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int N = p.N, G = p.hq / p.hkv;
  const int b = blockIdx.z, h = blockIdx.y / p.groups, grp = blockIdx.y % p.groups;
  const int kvh = h / G;
  const int row0 = blockIdx.x * WROWS, ra = row0 + warp * 16 + gid, rb = ra + 8;
  const long long qd = (long long)p.hq * p.dp, kd = (long long)p.hkv * p.dp;
  const __nv_bfloat16* qb = q + (long long)b * N * qd + (long long)h * p.dp;
  const __nv_bfloat16* db = dout + (long long)b * N * qd + (long long)h * p.dp;
  const __nv_bfloat16* kb = k + (long long)b * N * kd + (long long)kvh * p.dp;
  const __nv_bfloat16* vb = v + (long long)b * N * kd + (long long)kvh * p.dp;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale2);
  const uint32_t st = DROP ? stream_of(b + p.b0, p.h0 + h, p.seed) : 0u;
  const float4* ib = info + ((long long)b * p.hq + h) * N;
  const float4 ia = ra < N ? ib[ra] : make_float4(0.f, 1.f, 1.f, 0.f);
  const float4 ibb = rb < N ? ib[rb] : make_float4(0.f, 1.f, 1.f, 0.f);
  const bool live = row0 + warp * 16 < N;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int c0 = 0; c0 < N; c0 += BKEYS) {
    // s = q' k^T and w = do v^T: rows ra (i < 2), rb; keys c0 + nt * 8 +
    // tig * 2 + (i & 1).
    float s[KT][4] = {}, w[KT][4] = {};
    for (int dc = 0; dc < p.groups; ++dc) {
      __syncthreads();
      load_tile(qst, qb, qd, WROWS, row0, dc * WCOL, N);
      load_tile(dst_, db, qd, WROWS, row0, dc * WCOL, N);
      load_tile(kst, kb, kd, BKEYS, c0, dc * WCOL, N);
      load_tile(vst, vb, kd, BKEYS, c0, dc * WCOL, N);
      if (dc == 0) load_tile(kg, kb, kd, BKEYS, c0, grp * WCOL, N);
      commit();
      wait_copies<0>();
      __syncthreads();
      if (!live) continue;
#pragma unroll
      for (int kk = 0; kk < WCOL / 16; ++kk) {
        uint32_t qa[4], da[4];
        frag_a(qa, qst, warp * 16, kk, lane);
        frag_a(da, dst_, warp * 16, kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = mul_pair(qa[i], scale2);
#pragma unroll
        for (int nt = 0; nt < KT; nt += 2) {
          uint32_t kf[4], vf[4];
          frag_b(kf, kst, nt * 8, kk, lane);
          frag_b(vf, vst, nt * 8, kk, lane);
          mma_bf16(s[nt], qa, kf[0], kf[1]);
          mma_bf16(s[nt + 1], qa, kf[2], kf[3]);
          mma_bf16(w[nt], da, vf[0], vf[1]);
          mma_bf16(w[nt + 1], da, vf[2], vf[3]);
        }
      }
    }
    if (!live) continue;
    bool rare = false;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x < 2 ? ra : rb, key = c0 + nt * 8 + tig * 2 + (x & 1);
        const bool ok = r < N && key < N;
        s[nt][x] = ok ? exp2f(__fsub_rn(s[nt][x], (x < 2 ? ia : ibb).x)) : 0.f;
        rare |= tiny(s[nt][x]);
      }
    }
    const bool exact = __any_sync(0xffffffffu, rare);
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x < 2 ? ra : rb, key = c0 + nt * 8 + tig * 2 + (x & 1);
        if (exact)
          grads<true, DROP>(p, s[nt][x], w[nt][x], x < 2 ? ia : ibb, st, r, key);
        else
          grads<false, DROP>(p, s[nt][x], w[nt][x], x < 2 ? ia : ibb, st, r, key);
      }
    }
    // dq += ds K over the group's columns: A fragments of 16 rows x 16 keys.
#pragma unroll
    for (int t = 0; t < KT / 2; ++t) {
      const uint32_t da[4] = {pack2(w[2 * t][0], w[2 * t][1]), pack2(w[2 * t][2], w[2 * t][3]),
                              pack2(w[2 * t + 1][0], w[2 * t + 1][1]),
                              pack2(w[2 * t + 1][2], w[2 * t + 1][3])};
      const int key = t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t r[4];
        ldsm4t(r, smem_u32(kg + key * WSTR + (dt + (lane >> 4)) * 8));
        mma_bf16(acc[dt], da, r[0], r[1]);
        mma_bf16(acc[dt + 1], da, r[2], r[3]);
      }
    }
  }
  __nv_bfloat16* o = dq + (long long)b * N * qd + (long long)h * p.dp + grp * WCOL + tig * 2;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (ra < N) *reinterpret_cast<uint32_t*>(o + ra * qd + dt * 8) = pack2(acc[dt][0], acc[dt][1]);
    if (rb < N) *reinterpret_cast<uint32_t*>(o + rb * qd + dt * 8) = pack2(acc[dt][2], acc[dt][3]);
  }
}

constexpr int FWD_SMEM = (WROWS + 2 * WKEYS) * WSTR * 2;                 // 87,040 B
constexpr int DKDV_SMEM = (2 * BKEYS + 4 * BSUB) * WSTR * 2 + BSUB * 16;  // 70,144 B
constexpr int DQ_SMEM = (2 * WROWS + 3 * BKEYS) * WSTR * 2;               // 87,040 B

template <class Kernel>
cudaError_t smem_attr(Kernel kernel, int& set, int bytes) {
  if (set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) set = 1;
  return e;
}

template <Epilogue EPI, bool DROP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, const WidePlan& p,
                const TrainRows& tr, int B, cudaStream_t st) {
  static int set = 0;
  const cudaError_t e = smem_attr(wide_fwd_kernel<EPI, DROP>, set, FWD_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + WROWS - 1) / WROWS, p.hq * p.groups, B);
  wide_fwd_kernel<EPI, DROP><<<grid, 128, FWD_SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, p, tr);
  return cudaGetLastError();
}

cudaError_t rope(const void* x, long long x_row, int H, int dp, int N, int B, const float* cos_t,
                 const float* sin_t, float scale, void* out, bool scaled, cudaStream_t st) {
  const long long total = (long long)B * N * H * (dp / 4);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (scaled)
    wide_rope<true><<<blocks, 256, 0, st>>>((const __nv_bfloat16*)x, x_row, H, dp, N, total, cos_t,
                                            sin_t, scale, (__nv_bfloat16*)out);
  else
    wide_rope<false><<<blocks, 256, 0, st>>>((const __nv_bfloat16*)x, x_row, H, dp, N, total, cos_t,
                                             sin_t, scale, (__nv_bfloat16*)out);
  return cudaGetLastError();
}

// B2 and B12's attention: the rope pass into qr, kr, then the forward on
// q' (p.prescaled) with the epilogue EPI (int8 v: on V's codes, `v`, and
// their scales sv).
template <Epilogue EPI>
cudaError_t roped(const void* q, const void* k, const void* v, void* out, const WidePlan& p,
                  const float* cos_t, const float* sin_t, void* qr, void* kr, int B,
                  cudaStream_t st, const float* sv = nullptr) {
  cudaError_t e = rope(q, p.q_row, p.hq, p.dp, p.N, B, cos_t, sin_t, p.scale, qr, true, st);
  if (e != cudaSuccess) return e;
  e = rope(k, p.k_row, p.hkv, p.dp, p.N, B, cos_t, sin_t, 0.f, kr, false, st);
  if (e != cudaSuccess) return e;
  WidePlan r = p;
  r.q_row = (long long)p.hq * p.dp;
  r.k_row = (long long)p.hkv * p.dp;
  r.prescaled = 1;
  TrainRows tr{};
  tr.stats = const_cast<float*>(sv);  // int8 v: the codes' scales
  return fwd<EPI, false>(qr, kr, v, out, r, tr, B, st);
}

}  // namespace

// The serving forwards at dp = a multiple of 128: q [B, N, hq * dp], k and
// v [B, N, hkv * dp] bf16 views (16-byte aligned, row strides in the plan)
// -> out [B, N, hq * dp] bf16, contiguous.  kind 0: natural (B15, B16); 1:
// deferred (B11; B2 with cos_t and sin_t, [N, dp] f32); with the tables q
// and K are rotated first into qr [B, N, hq, dp] and kr [B, N, hkv, dp]
// (scratch).
extern "C" int attention_wide(const void* q, const void* k, const void* v, void* out,
                              const WidePlan* plan, const float* cos_t, const float* sin_t,
                              void* qr, void* kr, int kind, int B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) return fwd<Epilogue::kNatural, false>(q, k, v, out, *plan, TrainRows{}, B, st);
  if (cos_t) return roped<Epilogue::kDeferred>(q, k, v, out, *plan, cos_t, sin_t, qr, kr, B, st);
  return fwd<Epilogue::kDeferred, false>(q, k, v, out, *plan, TrainRows{}, B, st);
}

// B2 with int8_qk at dp: the rope pass, then the forward on V's codes
// [B, hkv, dp, round_up(N, 128)] s8 and their scales sv [B, hkv, dp] f32
// (attention_deferred.cu's attention_v_codes) -> out as attention_wide's.
extern "C" int attention_wide_s8v(const void* q, const void* k, const void* codes, void* out,
                                  const WidePlan* plan, const float* cos_t, const float* sin_t,
                                  void* qr, void* kr, const float* sv, int B, void* stream) {
  return roped<Epilogue::kInt8V>(q, k, codes, out, *plan, cos_t, sin_t, qr, kr, B,
                                 (cudaStream_t)stream, sv);
}

// B12 at dp: the rope pass, the normed attention into o [B * N, hq * dp]
// bf16, then the row quant and the s8 wgmma GEMM with wo_t [H, hq * dp] s8
// (the out projection's weight K-major, zero-padded heads), wos and bo [H]
// f32 -> out [B, N, H] bf16 (oq, so scratch), as flash_qkv.cu's flash_out.
// Needs H % 128 == 0.
extern "C" int flash_out_wide(const void* q, const void* k, const void* v, const WidePlan* plan,
                              const float* cos_t, const float* sin_t, void* qr, void* kr,
                              const void* wo_t, const void* wos, const void* bo, void* o,
                              void* oq, void* so, void* out, int B, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = roped<Epilogue::kNormed>(q, k, v, o, *plan, cos_t, sin_t, qr, kr, B, st);
  if (e != cudaSuccess) return e;
  const int M = B * plan->N, K = plan->hq * plan->dp;
  return s8_quant_dequant<true>(o, oq, so, wo_t, wos, bo, out, M, K, H, st);
}

// B12 row-parallel at dp (flash_qkv.cu's flash_out_split1 for head dims past
// 128): the rope pass and the attention on a rank's heads -> o, then amax
// [B * N] f32, max|o_row| over them.  Parts 2 and 3 are flash_qkv.cu's.
extern "C" int flash_out_wide_split1(const void* q, const void* k, const void* v,
                                     const WidePlan* plan, const float* cos_t,
                                     const float* sin_t, void* qr, void* kr, void* o, void* amax,
                                     int B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = roped<Epilogue::kNormed>(q, k, v, o, *plan, cos_t, sin_t, qr, kr, B, st);
  return e != cudaSuccess ? e
                          : launch_row_absmax(o, amax, B * plan->N, plan->hq * plan->dp, st);
}

// B10's forward at dp: q [B, N, hq * dp], k/v [B, N, hkv * dp] bf16
// (contiguous) -> out as q and tr->stats [B, hq, N, 2] f32.
extern "C" int attn_train_fwd_wide(const void* q, const void* k, const void* v, void* out,
                                   const WidePlan* plan, const TrainRows* tr, int B,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tr->dropout) return fwd<Epilogue::kTrain, true>(q, k, v, out, *plan, *tr, B, st);
  return fwd<Epilogue::kTrain, false>(q, k, v, out, *plan, *tr, B, st);
}

// B10's backward at dp: o and do as q, stats from the forward, info a [B,
// hq, N] float4 scratch -> dq as q, dk/dv as k.  Three launches: the rows,
// dk and dv, dq.
extern "C" int attn_train_bwd_wide(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* stats, void* info, void* dq,
                                   void* dk, void* dv, const WideBwdPlan* plan, int B,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const WideBwdPlan& p = *plan;
  const long long rows = (long long)B * p.hq * p.N;
  wide_bwd_rows<<<(unsigned)((rows * 32 + 255) / 256), 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)stats, (float4*)info,
      p.N, p.hq, p.dp, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static int set[4] = {0, 0, 0, 0};
  auto dkdv = p.dropout ? wide_bwd_dkdv<true> : wide_bwd_dkdv<false>;
  auto dqk = p.dropout ? wide_bwd_dq<true> : wide_bwd_dq<false>;
  e = smem_attr(dkdv, set[p.dropout], DKDV_SMEM);
  if (e != cudaSuccess) return e;
  e = smem_attr(dqk, set[2 + p.dropout], DQ_SMEM);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3((p.N + BKEYS - 1) / BKEYS, p.hkv * p.groups, B), 128, DKDV_SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float4*)info, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dqk<<<dim3((p.N + WROWS - 1) / WROWS, p.hq * p.groups, B), 128, DQ_SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float4*)info, (__nv_bfloat16*)dq, p);
  return cudaGetLastError();
}
