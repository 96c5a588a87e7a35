// Training GQA attention with hash dropout, forward and backward, for Hopper.
//
// Replaces the TPU kernels of gqa_attention_train in the JAX package's
// ops/attention_train.py: the forward _attn_train_fwd_kernel (pallas_call in
// _fwd_call) and the backward _attn_train_bwd_kernel (pallas_call in
// _attn_train_bwd).  Same math and rounding points, per (batch b, q-head h,
// kv-head h / G):
//   forward   q'   = bf16(q * bf16(scale * log2 e))
//             s    = q' k^T fp32; s = -inf where key col >= N
//             m    = rowmax(s); e = exp2f(s - m) fp32; l = sum(e) (before
//                    the dropout zeroing); e = 0 where dropped
//             o    = bf16((bf16(e) @ v) fp32 * (coef / l)), coef = 1/(1-rate)
//   backward  p    = exp2f(s - m) / l (correctly rounded); kc = keep ? coef : 0
//             dw   = (do v^T) kc; wd = p kc
//             delta= rowsum(do * o) fp32 from the stored bf16 do and o
//             ds   = bf16(p (dw - delta) scale)
//             dv  += bf16(wd)^T do, dk += ds^T q (q unscaled), dq = bf16(ds k)
//             dk, dv summed over the G query heads of the group in fp32,
//             rounded to bf16 once.
// Dropout: stream = h32(b * 0x9E3779B9 + h + seed * 0x85EBCA6B), keep =
// h32(stream ^ (row * Np + col)) <= thr, all uint32 with wrap-around,
// Np = round_up(N, 8) (the JAX wrapper's padded lattice; no physical pad
// here), thr computed on the host as the JAX package does.
//
// What bounds it on the H100: at the v3 training shape (B 28, N 345, Hq 20,
// Hkv 4, D 64) the forward's two products are 17.1 GFLOP (17 us at the
// 989 TFLOP/s bf16 peak) against ~59 MB of compulsory traffic (q, k, v in,
// o out: 18 us at 3.35 TB/s); the backward's five products are 42.6 GFLOP
// (43 us) against ~119 MB (q, k, v, o, do in, dq, dk, dv out: 35 us).  Both
// sit near the ridge; the exp2, the divide and the hash of each of the
// 67 M scores add SFU and integer work beside the tensor cores.
//
// Design (mma.sync m16n8k16 bf16 with fp32 accumulation; wgmma and TMA are
// left to a later version).  The TPU kernel keeps a batch element's whole
// [Np, Np] score tile per head in VMEM; a CTA cannot, so:
//   forward   attention_rows.cuh's body (B15's and B16's) with the train
//             epilogue, on B16's layout: the G q-heads side by side over
//             one copy of K and V in shared memory (15 warps at v3), and the
//             (batch, kv-head, 16-row tile) rounds cut into equal spans, one
//             a CTA (2464 rounds in spans of 19 over 130 CTAs at B 28), K
//             and V reloaded where a span crosses into the next (batch,
//             kv-head).  A warp holds 16 rows x 128 keys of scores in
//             registers, so q' k^T runs once; the row max and l are combined
//             across the W = nk / 128 warps of a row group in warp order;
//             exp2f and the keep bit once a score (no hash past N); bf16(e)
//             @ V over the warp's chunk, the W partial outputs added in warp
//             order.  It writes the row max and l ([B, Hq, N, 2] fp32) for
//             the backward.  The plan is ops/attention.py:_natural_plan
//             (grouped, balanced).
//   backward  two launches, no atomics, so two runs give bit-equal grads:
//     1. rows: per (batch, q-head, row) the float4 (m, l, rcp_rn(l), delta)
//        into a [B, Hq, T * 64] scratch (T = 64-row tiles a head; padded
//        rows (0, 1, 1, 0)), so that the main launch reads them by aligned
//        16-byte copies.
//     2. main: a thread-block cluster per (kv-head, batch), one CTA per
//        128-key chunk (W = nk / 128 CTAs, 3 at N = 345).  A CTA of 16
//        warps keeps its chunk's K and V in shared memory; warp w owns the
//        16 keys (w % 8) and its dk and dv [16, D] in fp32 registers; its
//        two groups of 8 warps take the G heads' 64-row tiles two at a
//        time (q, do and the row statistics double-buffered by cp.async,
//        the next pair in flight behind the math).  On each tile a warp
//        forms s^T = k q'^T and dwd^T = v do^T once, in 16-row slices, then
//        p, wd and ds once a score (one exp2f, one inline correctly rounded
//        divide from fdiv_rn.cuh, one hash), and dv += bf16(wd)^T do,
//        dk += ds^T q at once from registers.  ds^T goes to shared memory;
//        the tile's partial dq = ds @ K_chunk follows (each warp 16 rows x
//        32 columns), and the cluster adds its CTAs' partials through
//        distributed shared memory in rank order, rounds once and stores.
//        dk and dv: the two groups' sums added in group order, rounded once.
// Each of the five products runs once: at most 5 x 2 x B x Hq x nk x
// (T * 64) x 64 FLOP (52.9 GFLOP at the v3 shape), 45.2 issued there as
// 16-row slices and 16-key warps wholly past N skip theirs; the forward's
// two 2 x 2 x B x Hq x round_up(N, 16) x nk x 64 (19.4 GFLOP).  The launch plan is
// ops/attention_train.py:_train_plan, checked on the CPU for every N <= 768.
// Head dims 16, 32, 64 and 128 are template instances of one source (D / 16
// k-steps, D / 8 n-tiles, rows of D + 8); the FLOP counts above are D = 64's.
// At D = 128 the forward runs 8-warp CTAs and the backward one group of 8
// warps (255 registers a thread; its shared memory holds one group's
// tiles), taking the G T tiles one at a time.
//
// Registers (-Xptxas -v, sm_90a; chip_smoke.py's [build] line prints them on
// every run): the backward 128 a thread, no spills; the forward 128 (its
// 16-warp CTA caps them), spilling 16 B with dropout and 92 B without.

#include <cooperative_groups.h>

#include "attention_rows.cuh"

namespace cg = cooperative_groups;

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// The backward's launch plan, ops/attention_train.py:_train_plan (field for
// field), and its per-call arguments.
struct TrainBwdPlan {
  int N, hq, hkv, G;
  int T;      // 64-row tiles a head
  int W;      // CTAs of a cluster: 128-key chunks (nk = 128 W)
  int steps;  // tile pairs a CTA takes: ceil(G T / 2)
  int k_off, v_off, tile_off, info_off, ds_off, part_off;  // shared-memory bytes
  int np, dropout;
  uint32_t seed, thr;
  float scale2, scale, coef;
  int b0;  // the batch's first row in the global batch (the hash's b)
  int h0;  // the launch's first q head among all heads (the hash's h)
};

namespace {

constexpr int BWD_WARPS = 16;  // two groups of 8; warp w owns keys 16 (w % 8) ..

// Groups of 8 warps in the backward's CTA at head dim D: two up to D = 64;
// one at D = 128, whose dk and dv sums alone are 128 registers a thread
// (255 a thread, the whole file), and whose shared memory holds one
// group's tiles.
__host__ __device__ constexpr int bwd_groups(int D) { return D == 128 ? 1 : 2; }
constexpr int KEYS = 128;      // keys of a CTA
constexpr int TR = 64;         // rows of a tile
constexpr int SR = 16;         // query rows of a backward slice
constexpr int NS = SR / 8;     // n-tiles of a slice's scores

template <int D, bool DROP>
__global__ void __launch_bounds__(max_warps(D) * 32, 1) train_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const TrainRows tr) {
  rows_attention<D, Epilogue::kTrain, DROP, false, Grid::kBalanced>(q, k, v, out, p, tr,
                                                                   RopeTables{});
}

// Launch 1 of the backward: D / 8 threads a (batch, row < T * 64, q-head),
// the heads fastest, so that a warp reads contiguous bytes of do and o.
template <int D>
__global__ void __launch_bounds__(256) bwd_rows_kernel(const __nv_bfloat16* __restrict__ o,
                                                       const __nv_bfloat16* __restrict__ dout,
                                                       const float* __restrict__ stats,
                                                       float4* __restrict__ info, int N, int hq,
                                                       int rows, int total) {
  constexpr int TPR = D / 8, SH = ilog2(TPR);  // threads a row, log2
  const int g = blockIdx.x * blockDim.x + threadIdx.x;  // total < 2^31: the wrapper checks
  const int part = g & (TPR - 1), rest = g >> SH;
  const int h = rest % hq, br = rest / hq;
  const int row = br % rows, b = br / rows;
  const int bh = b * hq + h;
  const bool ok = g < total && row < N;
  float t = 0.f;
  if (ok) {
    const long long at = ((long long)b * N + row) * hq * D + h * D + part * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(dout + at);
    const uint4 y = *reinterpret_cast<const uint4*>(o + at);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&xs[i]);
      const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&ys[i]);
      t = __fadd_rn(t, __fmul_rn(__bfloat162float(a.x), __bfloat162float(c.x)));
      t = __fadd_rn(t, __fmul_rn(__bfloat162float(a.y), __bfloat162float(c.y)));
    }
  }
#pragma unroll
  for (int s = TPR / 2; s >= 1; s >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, s));
  if (part == 0 && g < total) {
    float4 r = make_float4(0.f, 1.f, 1.f, 0.f);
    if (ok) {
      const float* sp = stats + ((long long)bh * N + row) * 2;
      r = make_float4(sp[0], sp[1], reciprocal(sp[1]), t);
    }
    info[bh * rows + row] = r;
  }
}

// A barrier of the 8 warps of group g (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
}

// The cluster's barrier in two halves: arrive (release this thread's
// shared-memory writes) and, later, wait for every thread of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The tile of step i for group grp of GROUPS: head h and first row row0; a
// step past the G T tiles gets row0 = T * 64 (every row masked, nothing
// stored).
template <int GROUPS>
__device__ __forceinline__ void tile_of(const TrainBwdPlan& p, int kvh, int i, int grp, int& h,
                                        int& row0) {
  const int j = GROUPS * i + grp;
  const bool ok = j < p.G * p.T;
  h = kvh * p.G + (ok ? j / p.T : 0);
  row0 = ok ? (j % p.T) * TR : p.T * TR;
}

// p = e / l, wd and ds of one 16-key x SR-row slice in place: s (e) becomes
// wd, w (do v^T) becomes ds; `info` the slice's rows' (m, l, rcp_rn(l),
// delta), `row` the thread's first.  EXACT: a score of the warp is below
// 2^-100, so the divide takes its scaled form where needed.
template <bool EXACT, bool DROP>
__device__ __forceinline__ void slice_grads(const TrainBwdPlan& p, float (&s)[NS][4],
                                            float (&w)[NS][4], const float4* info, uint32_t st,
                                            int row, int keyA) {
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 ri = info[nt * 8 + (i & 1)];
      const float pr = EXACT ? quotient(s[nt][i], ri.y, ri.z) : markstein(s[nt][i], ri.y, ri.z);
      float dw = w[nt][i], wd = pr;
      if (DROP) {
        const float kc =
            kept(st, row + nt * 8 + (i & 1), keyA + (i >> 1) * 8, p.np, p.thr) ? p.coef : 0.f;
        dw = __fmul_rn(dw, kc);
        wd = __fmul_rn(pr, kc);
      }
      s[nt][i] = wd;
      w[nt][i] = __fmul_rn(__fmul_rn(pr, __fsub_rn(dw, ri.w)), p.scale);
    }
  }
}

// Launch 2 of the backward.  Grid (W, hkv, B), clusters of W along x: the
// CTA of rank c takes keys c * 128 .. c * 128 + 127.  D: the head dim (16,
// 32, 64 or 128: D / 16 k-steps of s^T and w^T, D / 8 n-tiles of dk and dv,
// a warp's partial dq D / 16 n-tiles wide; bwd_groups(D) groups of 8
// warps).  DROP: the dropout is on.
template <int D, bool DROP>
__global__ void __launch_bounds__(bwd_groups(D) * 256, 1) attn_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float4* __restrict__ info, __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const TrainBwdPlan p) {
  constexpr int STR = D + 8;   // bf16 row stride of K, V and the q and do tiles
  constexpr int DSTR = TR + 8; // bf16 row stride of ds^T ([key][query row])
  constexpr int PSTR = D + 8;  // fp32 row stride of the partial dq tiles
  constexpr int DT = D / 8;    // n-tiles of dk and dv
  constexpr int QN = D / 16;   // n-tiles of a warp's partial dq
  constexpr int C8 = D / 8;    // 16-byte chunks of a row
  constexpr int CSH = ilog2(C8);
  constexpr int GROUPS = bwd_groups(D), THREADS = GROUPS * 256;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + p.k_off);     // [128][STR]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + p.v_off);     // [128][STR]
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem + p.tile_off);  // [2][GROUPS][q, do][64][STR]
  float4* infos = reinterpret_cast<float4*>(smem + p.info_off);             // [2][GROUPS][64]
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(smem + p.ds_off);   // [GROUPS][128][DSTR]: ds^T
  float* part = reinterpret_cast<float*>(smem + p.part_off);                // [2][GROUPS][64][PSTR]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int g = warp >> 3, kw = warp & 7;
  const long long qd = (long long)p.hq * D, kd = (long long)p.hkv * D;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale2);  // exact: a bf16 value

  load_rows<D>(ks, k + ((long long)b * N + c * KEYS) * kd + kvh * D, kd, KEYS, N - c * KEYS);
  load_rows<D>(vs, v + ((long long)b * N + c * KEYS) * kd + kvh * D, kd, KEYS, N - c * KEYS);
  // q, do and the row statistics of group g's tile of step i, by the
  // group's own 256 threads.
  const int gt = tid & 255;
  auto load_step = [&](int i) {
    const int bf = i & 1;
    int h, row0;
    tile_of<GROUPS>(p, kvh, i, g, h, row0);
    for (int x = gt; x < 2 * TR * C8; x += 256) {
      const int t = x >> (6 + CSH), row = (x >> CSH) & (TR - 1), c8 = x & (C8 - 1);
      const int r = row0 + row;
      const bool ok = r < N;
      const __nv_bfloat16* src = (t ? dout : q) + ((long long)b * N + (ok ? r : 0)) * qd + h * D + c8 * 8;
      copy16(smem_u32(tiles + (((bf * GROUPS + g) * 2 + t) * TR + row) * STR + c8 * 8), src, ok);
    }
    if (gt < TR) {
      const bool ok = row0 < p.T * TR;
      const float4* src = info + ((long long)b * p.hq + h) * p.T * TR + (ok ? row0 + gt : 0);
      copy16(smem_u32(infos + (bf * GROUPS + g) * TR + gt), src, ok);
    }
    commit();
  };
  load_step(0);  // one group with K and V

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  const int keyA = c * KEYS + kw * 16 + gid;  // this thread's keys: keyA, keyA + 8
  const bool keyA_ok = keyA < N, keyB_ok = keyA + 8 < N;
  const bool keys_live = c * KEYS + kw * 16 < N;  // else the warp's ds^T rows stay 0
  __nv_bfloat16* dsT = dsb + g * KEYS * DSTR;
  if (!keys_live)
    for (int x = lane; x < 16 * DSTR / 2; x += 32)
      reinterpret_cast<uint32_t*>(dsT + kw * 16 * DSTR)[x] = 0u;

  // dq of step i's GROUPS tiles: the W partials added in rank order,
  // rounded once.  CTA c takes float4 columns x = c * THREADS + tid, x +=
  // W * THREADS.
  auto reduce_dq = [&](int i) {
    const int bf = i & 1;
    for (int x = c * THREADS + tid; x < GROUPS * TR * (D / 4); x += p.W * THREADS) {
      const int grp = x >> (7 + CSH), row = (x >> (CSH + 1)) & (TR - 1), c4 = x & (D / 4 - 1);
      int hh, r0;
      tile_of<GROUPS>(p, kvh, i, grp, hh, r0);
      if (r0 + row >= N) continue;
      float* mine = part + ((bf * GROUPS + grp) * TR + row) * PSTR + c4 * 4;
      float4 a = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, 0));
      for (int jj = 1; jj < p.W; ++jj) {
        const float4 y = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, jj));
        a.x = __fadd_rn(a.x, y.x);
        a.y = __fadd_rn(a.y, y.y);
        a.z = __fadd_rn(a.z, y.z);
        a.w = __fadd_rn(a.w, y.w);
      }
      *reinterpret_cast<uint2*>(dq + ((long long)b * N + r0 + row) * qd + hh * D + c4 * 4) =
          make_uint2(pack2(a.x, a.y), pack2(a.z, a.w));
    }
  };

#pragma unroll 1
  for (int i = 0; i < p.steps; ++i) {
    if (i + 1 < p.steps) {
      load_step(i + 1);  // its buffers were last read before the group's step i - 1 barrier
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    if (i == 0)
      __syncthreads();  // K and V too
    else
      group_sync(g);  // and the group's warps are done with ds^T of step i - 1
    const int bf = i & 1;
    int h, row0;
    tile_of<GROUPS>(p, kvh, i, g, h, row0);
    const __nv_bfloat16* qt = tiles + ((bf * GROUPS + g) * 2) * TR * STR;
    const __nv_bfloat16* dt = qt + TR * STR;
    const float4* inf = infos + (bf * GROUPS + g) * TR;
    const uint32_t st = stream_of(b + p.b0, p.h0 + h, p.seed);

#pragma unroll 1
    for (int sub = 0; sub < TR / SR; ++sub) {
      if (!keys_live || row0 + sub * SR >= N) continue;  // p = 0 throughout
      // s^T = k q'^T and w^T = v do^T: rows = this warp's 16 keys, columns =
      // the slice's SR query rows; [nt][0..1] key gid, [2..3] key gid + 8,
      // rows sub*SR + nt*8 + tig*2 + {0, 1}.
      float s[NS][4] = {}, w[NS][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        const int ar = (kw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + kk * 16 + (lane >> 4) * 8;
        ldsm4(ka, smem_u32(ks + ar));
        ldsm4(va, smem_u32(vs + ar));
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t qb[4], db[4];
          const int br =
              (sub * SR + n * 8 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 + ((lane >> 3) & 1) * 8;
          ldsm4(qb, smem_u32(qt + br));
          ldsm4(db, smem_u32(dt + br));
#pragma unroll
          for (int x = 0; x < 4; ++x) qb[x] = mul_pair(qb[x], scale2);
          mma_bf16(s[n], ka, qb[0], qb[1]);
          mma_bf16(s[n + 1], ka, qb[2], qb[3]);
          mma_bf16(w[n], va, db[0], db[1]);
          mma_bf16(w[n + 1], va, db[2], db[3]);
        }
      }
      // e = exp2f(s - m) in place, zero where the row or the key is past N.
      const int row = row0 + sub * SR + tig * 2;  // + nt * 8 + (i & 1)
      const float4* ri = inf + sub * SR + tig * 2;
      bool rare = false;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float m0 = ri[nt * 8].x, m1 = ri[nt * 8 + 1].x;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool ok = row + nt * 8 + (x & 1) < N && (x < 2 ? keyA_ok : keyB_ok);
          s[nt][x] = ok ? exp2f(__fsub_rn(s[nt][x], x & 1 ? m1 : m0)) : 0.f;
          rare |= tiny(s[nt][x]);
        }
      }
      if (__any_sync(0xffffffffu, rare))
        slice_grads<true, DROP>(p, s, w, ri, st, row, keyA);
      else
        slice_grads<false, DROP>(p, s, w, ri, st, row, keyA);
      // A fragments (16 keys x 16 rows a k-step): dv += bf16(wd)^T do,
      // dk += ds^T q; ds^T [key][row] staged for the partial dq.
#pragma unroll
      for (int t = 0; t < NS / 2; ++t) {
        const uint32_t wa[4] = {pack2(s[2 * t][0], s[2 * t][1]), pack2(s[2 * t][2], s[2 * t][3]),
                                pack2(s[2 * t + 1][0], s[2 * t + 1][1]),
                                pack2(s[2 * t + 1][2], s[2 * t + 1][3])};
        const uint32_t da[4] = {pack2(w[2 * t][0], w[2 * t][1]), pack2(w[2 * t][2], w[2 * t][3]),
                                pack2(w[2 * t + 1][0], w[2 * t + 1][1]),
                                pack2(w[2 * t + 1][2], w[2 * t + 1][3])};
        const int r16 = sub * SR + t * 16;
        const int vr = (r16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t r[4];
          ldsm4t(r, smem_u32(dt + vr + n * 8));
          mma_bf16(dva[n], wa, r[0], r[1]);
          mma_bf16(dva[n + 1], wa, r[2], r[3]);
          ldsm4t(r, smem_u32(qt + vr + n * 8));
          mma_bf16(dka[n], da, r[0], r[1]);
          mma_bf16(dka[n + 1], da, r[2], r[3]);
        }
        uint32_t* d0 = reinterpret_cast<uint32_t*>(dsT + (kw * 16 + gid) * DSTR + r16 + tig * 2);
        uint32_t* d1 = reinterpret_cast<uint32_t*>(dsT + (kw * 16 + gid + 8) * DSTR + r16 + tig * 2);
        d0[0] = da[0];
        d1[0] = da[1];
        d0[4] = da[2];
        d1[4] = da[3];
      }
    }
    group_sync(g);  // the group's ds^T staged

    // The chunk's partial dq = ds @ K_chunk: warp kw takes rows
    // (kw % 4) * 16 .. and columns (kw / 4) * D / 2 .. of its group's tile
    // (at D = 16 one n-tile: the second of the x4 load is not used).
    {
      const int rq = (kw & 3) * 16, dh = (kw >> 2) * (D / 2);
      float acc[QN < 2 ? 2 : QN][4] = {};
      if (row0 + rq < N)  // else the rows are past N: nothing is stored
#pragma unroll
      for (int kt = 0; kt < KEYS / 16; ++kt) {
        uint32_t a[4], r[4];
        ldsm4t(a, smem_u32(dsT + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * DSTR + rq +
                           ((lane >> 3) & 1) * 8));
        const int kr = (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + dh + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < QN; n += 2) {
          ldsm4t(r, smem_u32(ks + kr + n * 8));
          mma_bf16(acc[n], a, r[0], r[1]);
          if (n + 1 < QN) mma_bf16(acc[n + 1], a, r[2], r[3]);
        }
      }
      // Step i - 1's exchange: every CTA arrived after writing its
      // partials (and after reducing step i - 2's, whose buffer this step
      // writes next).
      if (i > 0) {
        cluster_wait();
        reduce_dq(i - 1);
      }
      float* pt = part + ((bf * GROUPS + g) * TR + rq + gid) * PSTR + dh + tig * 2;
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        *reinterpret_cast<float2*>(pt + n * 8) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(pt + 8 * PSTR + n * 8) = make_float2(acc[n][2], acc[n][3]);
      }
    }
    cluster_arrive();
  }
  cluster_wait();
  reduce_dq(p.steps - 1);

  // dk and dv: group 1's sums into shared memory (the tiles are dead), then
  // group 0 adds them to its own in that order and stores.  One group
  // stores its own sums (shared memory past its tiles may still be read by
  // the cluster's other CTAs).
  if (GROUPS == 1) {
    const long long base = (long long)b * N * kd + kvh * D + tig * 2;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      if (keyA_ok) {
        *reinterpret_cast<uint32_t*>(dk + base + keyA * kd + n * 8) = pack2(dka[n][0], dka[n][1]);
        *reinterpret_cast<uint32_t*>(dv + base + keyA * kd + n * 8) = pack2(dva[n][0], dva[n][1]);
      }
      if (keyB_ok) {
        *reinterpret_cast<uint32_t*>(dk + base + (keyA + 8) * kd + n * 8) =
            pack2(dka[n][2], dka[n][3]);
        *reinterpret_cast<uint32_t*>(dv + base + (keyA + 8) * kd + n * 8) =
            pack2(dva[n][2], dva[n][3]);
      }
    }
  } else {
  float4* sums = reinterpret_cast<float4*>(tiles) + (kw * 2 * DT) * 32 + lane;  // [8][2 DT][32]
  __syncthreads();  // group 0 is done with its tiles
  if (g == 1) {
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      sums[n * 32] = make_float4(dka[n][0], dka[n][1], dka[n][2], dka[n][3]);
      sums[(DT + n) * 32] = make_float4(dva[n][0], dva[n][1], dva[n][2], dva[n][3]);
    }
  }
  __syncthreads();
  if (g == 0) {
    const long long base = (long long)b * N * kd + kvh * D + tig * 2;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const float4 x = sums[n * 32], y = sums[(DT + n) * 32];
      if (keyA_ok) {
        *reinterpret_cast<uint32_t*>(dk + base + keyA * kd + n * 8) =
            pack2(__fadd_rn(dka[n][0], x.x), __fadd_rn(dka[n][1], x.y));
        *reinterpret_cast<uint32_t*>(dv + base + keyA * kd + n * 8) =
            pack2(__fadd_rn(dva[n][0], y.x), __fadd_rn(dva[n][1], y.y));
      }
      if (keyB_ok) {
        *reinterpret_cast<uint32_t*>(dk + base + (keyA + 8) * kd + n * 8) =
            pack2(__fadd_rn(dka[n][2], x.z), __fadd_rn(dka[n][3], x.w));
        *reinterpret_cast<uint32_t*>(dv + base + (keyA + 8) * kd + n * 8) =
            pack2(__fadd_rn(dva[n][2], y.z), __fadd_rn(dva[n][3], y.w));
      }
    }
  }
  }
  cluster_arrive();  // no CTA leaves while another may read its partials
  cluster_wait();
}

template <int D>
cudaError_t train_fwd(const void* q, const void* k, const void* v, void* out, const NaturalPlan& p,
                      const TrainRows& tr, dim3 grid, int warps, int smem, cudaStream_t st) {
  auto kernel = tr.dropout ? train_fwd_kernel<D, true> : train_fwd_kernel<D, false>;
  static int smem_set[2] = {0, 0};
  if (smem > smem_set[tr.dropout]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set[tr.dropout] = smem;
  }
  kernel<<<grid, warps * 32, smem, st>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                         (const __nv_bfloat16*)v, (__nv_bfloat16*)out, p, tr);
  return cudaGetLastError();
}

template <int D>
cudaError_t train_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* stats, void* info, void* dq, void* dk,
                      void* dv, const TrainBwdPlan& p, int B, int smem, cudaStream_t st) {
  const int total = B * p.hq * p.T * TR * (D / 8);
  bwd_rows_kernel<D><<<(total + 255) / 256, 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)stats, (float4*)info, p.N,
      p.hq, p.T * TR, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = p.dropout ? attn_bwd_kernel<D, true> : attn_bwd_kernel<D, false>;
  static int smem_set[2] = {0, 0};
  if (smem > smem_set[p.dropout]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set[p.dropout] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.W, p.hkv, B);
  cfg.blockDim = dim3(bwd_groups(D) * 256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.W;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                         (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float4*)info,
                         (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// q [B, N, hq * D], k/v [B, N, hkv * D] bf16 (contiguous, 16-byte
// aligned), D 16, 32, 64 or 128 -> out [B, N, hq * D] bf16 and tr->stats
// [B, hq, N, 2] f32 (row max, row sum of exp2).  One launch of grid (gx, gy,
// B) with `warps` warps and `smem` bytes of dynamic shared memory
// (ops/attention_train.py's plan).
extern "C" int attn_train_fwd(const void* q, const void* k, const void* v, void* out,
                              const NaturalPlan* plan, const TrainRows* tr, int D, int B, int gx,
                              int gy, int warps, int smem, void* stream) {
  const dim3 grid(gx, gy, B);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return train_fwd<16>(q, k, v, out, *plan, *tr, grid, warps, smem, st);
    case 32: return train_fwd<32>(q, k, v, out, *plan, *tr, grid, warps, smem, st);
    case 64: return train_fwd<64>(q, k, v, out, *plan, *tr, grid, warps, smem, st);
    case 128: return train_fwd<128>(q, k, v, out, *plan, *tr, grid, warps, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward: o and do as q, stats from the forward, info a [B, hq, T * 64]
// float4 scratch -> dq as q, dk/dv as k.  Two launches: the row statistics,
// then the clusters.
extern "C" int attn_train_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* stats, void* info, void* dq, void* dk,
                              void* dv, const TrainBwdPlan* plan, int D, int B, int smem,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return train_bwd<16>(q, k, v, o, dout, stats, info, dq, dk, dv, *plan, B, smem, st);
    case 32: return train_bwd<32>(q, k, v, o, dout, stats, info, dq, dk, dv, *plan, B, smem, st);
    case 64: return train_bwd<64>(q, k, v, o, dout, stats, info, dq, dk, dv, *plan, B, smem, st);
    case 128: return train_bwd<128>(q, k, v, o, dout, stats, info, dq, dk, dv, *plan, B, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
