// The streaming mode of attention_rows.cuh's natural, deferred and normed
// epilogues: K and V pass through shared memory in 128-key chunks, so N
// has no cap.  The resident and non-resident modes hold a row's keys across
// W = nk / 128 warps, each 128 keys of scores in registers, and K (then V)
// whole in shared memory: past N = 1024 (W = 8) or, at D = 128, where K
// and the partial outputs outgrow shared memory (N > 640), the launch plan
// (ops/attention.py:_natural_plan) takes this mode instead.
//
// A warp owns 16 query rows of one head and walks all the keys itself, in
// three passes over K, the chunks double-buffered by cp.async and shared by
// the CTA's warps (one kv-head):
//   1. s over each chunk; the exact row max m (a max is exact in any order);
//   2. s again; e = exp(s - m) (exp2f for the base-2 epilogues) and
//      l += the chunk's sum: per thread over its columns in order, then
//      across the quad, then onto l in chunk order (at N <= 1024 the W
//      warps' order of the other modes);
//   3. s again with V's chunk; e as in pass 2, then the natural and normed
//      epilogues' w = bf16(e / l) (fdiv_rn.cuh, correctly rounded: l is
//      known before any weight is rounded), the deferred one's bf16(e);
//      o += w @ V's chunk in the fp32 accumulators.
// o = bf16(o) (natural, normed) or bf16(o * rcp_rn(l)) (deferred; B11 first
// takes its npad zero keys' share off l: l - npad * exp2f(-m)).  The int8 v
// epilogue (B2 with int8_qk) passes V's codes through the V buffers
// instead ([D][128 + 16] bytes a chunk), takes o += rn(e * 127) @ codes in
// s32 in pass 3, and writes bf16((f32(o) * (rcp_rn(l) * f32(1/127))) * sv).  A one-pass
// online softmax would round w (or e) against a running max, so the mode
// computes the scores three times; its time is the price of the exact max.
// No row's arithmetic depends on the grid, so B15 and B16 stay bit-equal.
//
// The CTA: `heads` q-heads (1 for the per-q-head grid, G for the per-kv-
// head one) in `head_rounds` rounds of `hc`, times R = rows / 16 row groups;
// warp w is row group w % R of head slot w / R.  Grid (tiles, q-head or
// kv-head, batch).  Shared memory: K's two chunk buffers at k_off, V's at
// v_off, the warps' q rows at q_off (rows of D + 8, as in the other modes).
// B2 and B12 (ROPE) rotate each K chunk in place as it lands, every pass,
// and each warp's q rows once a round, scaled in the same pass.
#pragma once

#include "attention_rows.cuh"

namespace {

constexpr int STREAM_WARPS = 8;  // warps a CTA: 255 registers a thread at every D

template <int D, Epilogue EPI, bool ROPE>
__device__ __forceinline__ void stream_attention(const __nv_bfloat16* __restrict__ q,
                                                 const __nv_bfloat16* __restrict__ k,
                                                 const __nv_bfloat16* __restrict__ v,
                                                 __nv_bfloat16* __restrict__ out,
                                                 const NaturalPlan& p, const RopeTables& rt,
                                                 const float* __restrict__ sv = nullptr) {
  constexpr bool NATURAL = EPI == Epilogue::kNatural;
  constexpr bool I8V = EPI == Epilogue::kInt8V;
  constexpr bool NORMED = NATURAL || EPI == Epilogue::kNormed;
  static_assert(EPI != Epilogue::kTrain, "the train epilogue has no streaming mode");
  constexpr int STR = D + 8, DT = D / 8, DSH = ilog2(DT), CHUNK = NT * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem + p.k_off);  // [2][128][STR]
  __nv_bfloat16* vbuf = reinterpret_cast<__nv_bfloat16*>(smem + p.v_off);  // [2][128][STR]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* qw = reinterpret_cast<__nv_bfloat16*>(smem + p.q_off) + warp * 16 * STR;
  const int N = p.N, limit = NATURAL ? N : p.limit;
  const int R = p.rows / 16, hs = warp / R;
  const int row0 = blockIdx.x * p.rows + (warp % R) * 16;
  const int b = blockIdx.z, head0 = blockIdx.y * p.heads;
  const int kvh = head0 / (p.hq / p.hkv);
  const int chunks = p.nk / CHUNK;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);  // exact: a bf16 value
  const __nv_bfloat16* kb = k + (long long)b * N * p.k_row + kvh * D;
  const __nv_bfloat16* vb = v + (long long)b * N * p.v_row + kvh * D;
  const int8_t* vq = reinterpret_cast<const int8_t*>(v) + ((long long)b * p.hkv + kvh) * D * p.nk;

  for (int hr = 0; hr < p.head_rounds; ++hr) {
    const int slot = hr * p.hc + hs;
    const bool live = slot < p.heads;
    const int head = head0 + (live ? slot : 0);
    for (int c = lane; c < 16 * DT; c += 32) {  // the warp's q rows; zero past N
      const int i = c >> DSH, part = c & (DT - 1), row = row0 + i;
      const bool ok = live && row < N;
      copy16(smem_u32(qw + i * STR + part * 8),
             q + ((long long)b * N + (ok ? row : 0)) * p.q_row + head * D + part * 8, ok);
    }
    // The chunk sequence: pass t / chunks over chunk t % chunks, into
    // buffer t % 2; chunk t + 1 is in flight while chunk t is used.
    int t = 0;
    auto issue = [&](int u) {
      const int c = u % chunks, buf = u & 1;
      load_rows<D>(kbuf + buf * CHUNK * STR, kb + (long long)c * CHUNK * p.k_row, p.k_row, CHUNK,
                   N - c * CHUNK);
      if (u >= 2 * chunks && I8V)
        load_codes(reinterpret_cast<int8_t*>(vbuf + buf * CHUNK * STR), vq + c * CHUNK, p.nk, D,
                   CHUNK, threadIdx.x, blockDim.x);
      else if (u >= 2 * chunks)
        load_rows<D>(vbuf + buf * CHUNK * STR, vb + (long long)c * CHUNK * p.v_row, p.v_row,
                     CHUNK, N - c * CHUNK);
      commit();
    };
    issue(0);  // with the q rows
    // The scores of chunk t % chunks: s[nt][0..1] row gid, [2..3] row
    // gid + 8, keys key0 + nt * 8 + tig * 2 + {0, 1}; -inf at or past the
    // limit.  Returns the chunk's V buffer.
    auto scores = [&](float (&s)[NT][4]) {
      if (t + 1 < 3 * chunks) {
        issue(t + 1);
        wait_copies<1>();
      } else {
        wait_copies<0>();
      }
      __syncthreads();
      const int c = t % chunks, key0 = c * CHUNK;
      __nv_bfloat16* ks = kbuf + (t & 1) * CHUNK * STR;
      if (ROPE) {
        rope_rows<D, false, 2>(ks, CHUNK, key0, N, rt, scale2, threadIdx.x, blockDim.x);
        if (t == 0) rope_rows<D, true, 4>(qw, 16, row0, N, rt, scale2, lane, 32);
        __syncthreads();
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        ldsm4(qa, smem_u32(qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + kk * 16 +
                           (lane >> 4) * 8));
        if (!NATURAL && !ROPE) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = mul_pair(qa[i], scale2);
        }
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kf[4];
          ldsm4(kf, smem_u32(ks + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                             ((lane >> 3) & 1) * 8));
          mma_bf16(s[nt], qa, kf[0], kf[1]);
          mma_bf16(s[nt + 1], qa, kf[2], kf[3]);
        }
      }
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
      return vbuf + (t & 1) * CHUNK * STR;
    };
    auto done = [&]() {  // every warp is through with chunk t's buffers
      __syncthreads();
      ++t;
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
      scores(s);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
      done();
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
      scores(s);
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
      done();
    }

    // 3. The weights and the value product.
    float acc[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    int iacc[DT][4];  // int8 v: the exact s32 product
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) iacc[dt][0] = iacc[dt][1] = iacc[dt][2] = iacc[dt][3] = 0;
    for (int c = 0; c < chunks; ++c) {
      float s[NT][4];
      const __nv_bfloat16* vs = scores(s);
      exps(s, m0, m1);
      if (I8V) {
        value_s8<DT>(iacc, s, reinterpret_cast<const int8_t*>(vs), CHUNK + 16, 0, lane);
        done();
        continue;
      }
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
#pragma unroll
        for (int tt = 0; tt < NT / 2; ++tt) {
          wa[tt][0] = pack2(s[2 * tt][0], s[2 * tt][1]);
          wa[tt][1] = pack2(s[2 * tt][2], s[2 * tt][3]);
          wa[tt][2] = pack2(s[2 * tt + 1][0], s[2 * tt + 1][1]);
          wa[tt][3] = pack2(s[2 * tt + 1][2], s[2 * tt + 1][3]);
        }
      }
#pragma unroll
      for (int tt = 0; tt < NT / 2; ++tt) {
        const int key = tt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t vf[4];
          ldsm4t(vf, smem_u32(vs + key * STR + (dt + (lane >> 4)) * 8));
          mma_bf16(acc[dt], wa[tt], vf[0], vf[1]);
          mma_bf16(acc[dt + 1], wa[tt], vf[2], vf[3]);
        }
      }
      done();
    }

    float f0 = 1.f, f1 = 1.f;
    if (!NORMED) {
      if (!ROPE && p.npad) {
        l0 = __fsub_rn(l0, __fmul_rn((float)p.npad, exp2f(-m0)));
        l1 = __fsub_rn(l1, __fmul_rn((float)p.npad, exp2f(-m1)));
      }
      f0 = markstein(1.f, l0, reciprocal(l0));
      f1 = markstein(1.f, l1, reciprocal(l1));
    }
    const int ra = row0 + gid, rb = ra + 8;
    __nv_bfloat16* dst = out + (long long)b * N * p.hq * D + head * D + tig * 2;
    const long long ostr = (long long)p.hq * D;
    if (I8V) {
      f0 = __fmul_rn(f0, kInv127);
      f1 = __fmul_rn(f1, kInv127);
      const float* svb = sv + ((long long)b * p.hkv + kvh) * D + tig * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const float2 sc = *reinterpret_cast<const float2*>(svb + dt * 8);
        if (live && ra < N)
          *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = s8_out(iacc[dt][0], iacc[dt][1], f0, sc);
        if (live && rb < N)
          *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = s8_out(iacc[dt][2], iacc[dt][3], f1, sc);
      }
      continue;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float x0 = NORMED ? acc[dt][0] : __fmul_rn(acc[dt][0], f0);
      const float x1 = NORMED ? acc[dt][1] : __fmul_rn(acc[dt][1], f0);
      const float y0 = NORMED ? acc[dt][2] : __fmul_rn(acc[dt][2], f1);
      const float y1 = NORMED ? acc[dt][3] : __fmul_rn(acc[dt][3], f1);
      if (live && ra < N) *reinterpret_cast<uint32_t*>(dst + ra * ostr + dt * 8) = pack2(x0, x1);
      if (live && rb < N) *reinterpret_cast<uint32_t*>(dst + rb * ostr + dt * 8) = pack2(y0, y1);
    }
  }
}

}  // namespace
