// The attention kernels in fp32, for Hopper: the fp32 modes of B2, B11,
// B12, B15, B16, of B2's int8 value product and of B10's forward, on fp32
// FMAs outside the tensor cores (the s8 products of B12 and int8_qk on the
// s8 ones).
//
// Replaces, on an fp32 input (the JAX model at dtype="float32" hands them
// one), the TPU kernels of the JAX package's ops/attention.py:
//   B2  gqa_attention_flash_qkv (_attn_kernel_flash_qkv, pallas_call :449)
//   B2  the same with int8_qk (v codes :281-290, value product :310-319)
//   B11 gqa_attention_flash (_attn_kernel_flash, pallas_call :213)
//   B12 gqa_attention_flash_out (_attn_kernel_flash_out, pallas_call :565)
//   B15 gqa_attention (_attn_kernel, pallas_call :109)
//   B16 gqa_attention_grouped (_attn_kernel_grouped, pallas_call :651)
// and of the JAX package's ops/attention_train.py:
//   B10 gqa_attention_train's forward (_attn_train_fwd_kernel, pallas_call
//       :266 in _fwd_call; its backward is attention_f32_bwd.cu)
// Their rounding points there, every operation in fp32:
//   q, k = x * cos + rot(x) * sin       B2, B12: each product and the sum rounded
//   base 2 (B2, B11, B12): q' = q * fp32(scale * log2 e), s = q' @ k^T,
//       e = exp2(s - m)
//   natural (B15, B16): s = (q @ k^T) * fp32(scale), e = exp(s - m)
//   the key tail: s = -inf at key col >= n_valid (B2, B12) or >= N (B15,
//       B16, whose padding to 128 adds zero keys); B11 pads N to a multiple
//       of 8 with zero keys that score 0, take part in the row max m, and
//       whose share npad * exp2(-m) comes off l
//   m the exact row max; l = sum(e)
//   deferred (B2, B11): o = (e @ v) * (1 / l)
//   train (B10): base 2, keys masked at N, l summed before the dropout
//       zeroing (dropout_hash.cuh's keep bit on the round_up(N, 8)
//       lattice, no hash past N), o = (e @ v) * (coef / l), and the row
//       max and l written [B, hq, N, 2] for the backward
//   natural (B12, B15, B16): w = e / l rounded per element, o = w @ v
//   int8 v (B2 int8_qk): w_q = rn(e * 127), acc = w_q @ v_q (s8 x s8 ->
//       s32, exact), o = (f32(acc) * ((1 / l) * f32(1/127))) * sv, v_q and
//       sv made before by attention_deferred.cu's v_codes_kernel on fp32 v
//   B12 then: so = max(max|o_row| * f32(1/127), 1e-12), o_q = rn(o / so),
//       out = ((f32(o_q @ wo) * so) * wos) + bo
// The RoPE, the scales and the divides here take those roundings (no FMA
// contraction); the products and l are fp32 sums in another order than the
// plain versions' (fp32 FMAs); exp and exp2 are evaluated in double and
// rounded once to fp32, more accurate than the hardware's ex2.approx,
// which is not used.
//
// What bounds it on the H100, at the serving shapes (D = 64, 345 keys):
// the two fp32 products over the keys, 3.66 GFLOP at [6, 345] with 20/4
// heads, 55 us at the 67 TFLOP/s fp32 peak outside the tensor cores,
// against ~26 MB of compulsory traffic (7.8 us at 3.35 TB/s): the
// operations bound it.  The tensor cores would take the fp32 products only
// in TF32 (or three-pass TF32 emulation), which rounds where the JAX
// kernels do not; this kernel keeps fp32 and is slow by design: a simple
// kernel that is right, with exact fp32 arithmetic.
//
// Design.  One CTA of 256 threads for each (query tile of 64 rows, kv head,
// batch): grid (ceil(G N / 64), hkv, B), a tile taking 64 of the G N rows
// of a kv head's G q heads stacked (one K and V for them all; a tile row
// past its head's N rows is the next head's, so only the kv head's last
// tile has empty rows).  The tile's q rows are
// rotated (ROPE), scaled (base 2) and kept in shared memory.  Keys come in
// chunks of 64: the chunk's K rows are rotated as they are staged in
// shared memory (V, or V's codes, beside them where the pass needs them),
// zero past the keys read and past the head dim D (the tile is DP wide, DP
// = 32, 64, 128 or 256 >= D).  Each thread owns a 4 x 4 block of the 64 x
// 64 scores (rows 4 ty + i, keys tx + 16 j) and a 4 x DP / 16 block of the
// output.  Passes over the keys: the first takes each row's exact max
// (the scores are recomputed in each pass, never stored); the deferred and
// int8 epilogues then take e, l and the value product in one pass; the
// natural one takes l in a second pass and w = e / l and w @ V in a third.
// The int8 value product runs on mma.sync m16n8k32 s8 (warp w: rows 16 (w
// % 4) .., columns DP / 2 (w / 4) ..), on w_q and V's codes staged in
// shared memory in key order (80-byte rows: the fragments' 4-byte loads
// free of bank conflicts).  The padded row strides (DP + 1, 64 + 1) keep
// the column reads of K, q and e free of bank conflicts.  B12's o goes
// through an fp32 scratch to s8_rows.cuh's fp32 row quant (the divide
// form) and s8_dequant.cuh's s8 wgmma GEMM with the bias, fp32 out.

#include <math.h>

#include "dropout_hash.cuh"
#include "s8_dequant.cuh"

// The launch's views and scalars.  Element d of head h of row n of batch b
// of q is q[(b * N + n) * q_row + h * D + d] (k and v alike, by kv head);
// the output [B, N, hq, out_dp] is contiguous.  Past D (B12's scratch at
// the padded head dim of its GEMM's weight) a head is laid out as
// ops/attention.py:pad_heads widens an even head: its halves at [0, D/2)
// and [out_dp/2, out_dp/2 + D/2), zeros between and after.
struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* cos_t;    // [N, D] (RoPE)
  const float* sin_t;
  const int8_t* codes;   // int8 v: [B, hkv, codes_d, nk] s8, 32-key blocks in key_at order
  const float* sv;       // int8 v: [B, hkv, codes_d]
  float* out;
  long long q_row, k_row, v_row;
  int N, limit, npad, hq, hkv, D, out_dp, codes_d, nk;
  float scale;           // base 2: fp32(scale * log2 e), folded into q; natural: fp32(scale)
  // B10's forward (train) only:
  float* stats;          // [B, hq, N, 2]: the row max and l
  uint32_t seed, thr;    // the dropout stream's seed and keep threshold
  int np, dropout;       // the hash lattice round_up(N, 8); 0 or 1
  float coef;            // fp32(1 / (1 - rate))
  int b0;                // the batch's first row in the global batch (the hash's b)
  int h0;                // the launch's first q head among all heads (the hash's h)
};

namespace {

constexpr int QT = 64;        // query rows a CTA
constexpr int KC = 64;        // keys a chunk
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4 ty .. 4 ty + 3, tx keys tx + 16 j
constexpr int S8_ROW = KC + 16;  // bytes a row of s8 codes in shared memory

// The epilogues (an int template argument, so that a kernel's name reads
// plainly in the build report).
constexpr int kDeferred = 0, kNatural = 1, kInt8V = 2, kTrain = 3;

template <int DP>
struct F32Tiles {
  float v[KC][DP];       // V's rows
  float e[QT][KC + 1];   // e or w: [row][key]
};

template <int DP>
struct S8Tiles {
  int8_t v[DP][S8_ROW];  // V's codes K-major: [column][key]
  int8_t e[QT][S8_ROW];  // w_q: [row][key]
  float r[QT];           // 1 / l of each row
};

template <int DP>
struct F32Smem {
  float q[QT][DP + 1];
  float k[KC][DP + 1];
  union {
    F32Tiles<DP> f;
    S8Tiles<DP> s8;
  } u;
};

// Element d (< D) of a row's rotated head: x * cos + rot(x) * sin, the
// half-rotation form (rot(x)[d] = -x[d + D/2] below D/2, x[d - D/2] above).
__device__ __forceinline__ float rope_at(const float* __restrict__ row, const float* __restrict__ c,
                                         const float* __restrict__ s, int d, int D) {
  const int half = D >> 1;
  const float xr = d < half ? -row[d + half] : row[d - half];
  return __fadd_rn(__fmul_rn(row[d], c[d]), __fmul_rn(xr, s[d]));
}

// The key that position p of a 32-key block of V's codes holds
// (v_codes_kernel's layout, attention_rows.cuh:kperm).
__device__ __forceinline__ int key_at(int p) {
  return (p & 16) | ((p & 2) << 2) | (((p >> 2) & 3) << 1) | (p & 1);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where output column d of a head goes in a head out_dp wide: the true
// columns (d < D) as pad_heads puts them, the zero columns (d >= D, whose
// value is 0) onto the positions left, one each.
__device__ __forceinline__ int out_col(int d, int D, int out_dp) {
  const int half = D >> 1, padh = (out_dp - D) >> 1;
  if (d < half) return d;
  if (d < D) return d + padh;
  const int p = d - D;
  return p < padh ? half + p : (out_dp >> 1) + half + (p - padh);
}

// exp2 (base 2) or exp (natural) of x, in double, rounded once.
template <bool NATURAL>
__device__ __forceinline__ float expo(float x) {
  return NATURAL ? (float)exp((double)x) : (float)exp2((double)x);
}

// One query tile of batch b: 64 of the G N rows of kv head kvh's G q heads
// stacked, as B16's TPU kernel stacks them.  NATURAL: the scale after the
// product and exp; else the scale folded into q and exp2.
template <int DP, bool ROPE, int EPI, bool NATURAL>
__device__ __forceinline__ void query_tile(const F32Args& a, F32Smem<DP>& sm, int b, int kvh,
                                           int q0) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int D = a.D, N = a.N, limit = a.limit, G = a.hq / a.hkv;
  const int rows = G * N;
  const int kmax = min(N, limit);  // keys read; past it zero (B11's pad) or masked
  const size_t bN = (size_t)b * N;
  // 64-bit offsets to the batch; 32-bit ones within it (N row strides).
  const float* qb = a.q + bN * a.q_row;
  const float* kb = a.k + bN * a.k_row + kvh * D;
  const float* vb = a.v + bN * a.v_row + kvh * D;
  const int q_row = (int)a.q_row, k_row = (int)a.k_row, v_row = (int)a.v_row;
  constexpr int OJ = DP / 16;  // output columns a thread: tx + 16 j
  // Tile row r: its q head h and position n; false past the rows.
  auto head_row = [&](int r, int& h, int& n) {
    const int sr = q0 + r;
    h = kvh * G + sr / N;
    n = sr % N;
    return sr < rows;
  };

  for (int x = tid; x < QT * DP; x += THREADS) {
    const int r = x / DP, d = x % DP;
    int h, row;
    float val = 0.f;
    if (head_row(r, h, row) && d < D) {
      const float* qr = qb + row * q_row + h * D;
      val = ROPE ? rope_at(qr, a.cos_t + row * D, a.sin_t + row * D, d, D)
                 : qr[d];
      if (!NATURAL) val = __fmul_rn(val, a.scale);
    }
    sm.q[r][d] = val;
  }

  // The chunk's K rows (rotated), and with V its V rows or codes, zero past
  // the keys read and past D.
  auto stage = [&](int k0, bool with_v) {
    for (int x = tid; x < KC * DP; x += THREADS) {
      const int c = x / DP, d = x % DP, key = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < kmax && d < D) {
        const float* kr = kb + key * k_row;
        kv = ROPE ? rope_at(kr, a.cos_t + key * D, a.sin_t + key * D, d, D)
                  : kr[d];
        if (EPI != kInt8V && with_v) vv = vb[key * v_row + d];
      }
      sm.k[c][d] = kv;
      if (EPI != kInt8V && with_v) sm.u.f.v[c][d] = vv;
    }
    if constexpr (EPI == kInt8V) {
      if (!with_v) return;
      const int8_t* cb = a.codes + ((size_t)b * a.hkv + kvh) * a.codes_d * a.nk + k0;
      for (int x = tid; x < DP * (KC / 4); x += THREADS) {
        const int d = x / (KC / 4), p = (x % (KC / 4)) * 4;
        const uint32_t w = d < a.codes_d ? ld32(cb + (size_t)d * a.nk + p) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sm.u.s8.v[d][((p + j) & ~31) + key_at((p + j) & 31)] = (int8_t)(w >> (8 * j));
      }
    }
  };
  auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sm.q[4 * ty + i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = sm.k[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }
    if (NATURAL)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(s[i][j], a.scale);
  };
  // o += t @ V over the chunk, t the chunk's e or w in shared memory.
  auto value_product = [&](float (&acc)[4][OJ]) {
#pragma unroll 4
    for (int c = 0; c < KC; ++c) {
      float ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ev[i] = sm.u.f.e[4 * ty + i][c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const float vv = sm.u.f.v[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ev[i], vv, acc[i][j]);
      }
    }
  };
  auto row_sum = [](float (&l)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], o));
  };

  // Pass 1: each row's exact max over the keys below the limit.
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < limit; k0 += KC) {
    __syncthreads();
    stage(k0, false);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j < limit)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));

  // train: each row's dropout stream and position.
  uint32_t st[4];
  int pos[4];
  if constexpr (EPI == kTrain)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int h;
      head_row(4 * ty + i, h, pos[i]);
      st[i] = stream_of(b + a.b0, a.h0 + h, a.seed);
    }

  // Pass 2: e and l, and (deferred, train, int8 v) the value product.
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;  // the int8 product's rows and columns
  constexpr int NT = DP / 16;               // its n-tiles of 8 columns a warp
  float l[4] = {0.f, 0.f, 0.f, 0.f}, acc[4][OJ];
  int iacc[NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) iacc[t][c] = 0;
  for (int k0 = 0; k0 < limit; k0 += KC) {
    __syncthreads();
    stage(k0, EPI != kNatural);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = k0 + tx + 16 * j < limit;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = valid ? expo<NATURAL>(__fsub_rn(s[i][j], m[i])) : 0.f;
        l[i] = __fadd_rn(l[i], e);
        if constexpr (EPI == kTrain)
          if (a.dropout && valid && !kept(st[i], pos[i], k0 + tx + 16 * j, a.np, a.thr)) e = 0.f;
        if constexpr (EPI == kDeferred || EPI == kTrain) sm.u.f.e[4 * ty + i][tx + 16 * j] = e;
        if constexpr (EPI == kInt8V)
          sm.u.s8.e[4 * ty + i][tx + 16 * j] = (int8_t)__float2int_rn(__fmul_rn(e, 127.f));
      }
    }
    if constexpr (EPI == kDeferred || EPI == kTrain) {
      __syncthreads();
      value_product(acc);
    }
    if constexpr (EPI == kInt8V) {
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KC; ks += 32) {
        const int kk = ks + tig * 4;
        const uint32_t af[4] = {ld32(&sm.u.s8.e[16 * rg + g][kk]),
                                ld32(&sm.u.s8.e[16 * rg + g + 8][kk]),
                                ld32(&sm.u.s8.e[16 * rg + g][kk + 16]),
                                ld32(&sm.u.s8.e[16 * rg + g + 8][kk + 16])};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n = ch * (DP / 2) + 8 * t + g;
          mma_s8(iacc[t], af, ld32(&sm.u.s8.v[n][kk]), ld32(&sm.u.s8.v[n][kk + 16]));
        }
      }
    }
  }
  row_sum(l);
  if (a.npad)  // B11: the zero keys' share, npad * exp2(-m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      l[i] = __fsub_rn(l[i], __fmul_rn((float)a.npad, expo<NATURAL>(-m[i])));

  const int out_row = a.hq * a.out_dp;
  float* ob = a.out + bN * out_row;  // row n of head h at n * out_row + h * out_dp
  if constexpr (EPI == kInt8V) {
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) sm.u.s8.r[4 * ty + i] = __fdiv_rn(1.0f, l[i]);
    __syncthreads();
    const float* svb = a.sv + ((size_t)b * a.hkv + kvh) * a.codes_d;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * rg + g + 8 * hh;
      int h, row;
      if (!head_row(r, h, row)) continue;
      const float rr = __fmul_rn(sm.u.s8.r[r], INV127);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = ch * (DP / 2) + 8 * t + 2 * tig + c;
          if (d < a.out_dp)
            ob[row * out_row + h * a.out_dp + d] =
                d < D ? __fmul_rn(__fmul_rn(__int2float_rn(iacc[t][2 * hh + c]), rr), svb[d])
                      : 0.f;
        }
    }
    return;
  }

  // Pass 3 (natural): w = e / l, rounded, and o += w @ V.
  if constexpr (EPI == kNatural) {
    for (int k0 = 0; k0 < limit; k0 += KC) {
      __syncthreads();
      stage(k0, true);
      __syncthreads();
      float s[4][4];
      scores(s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + tx + 16 * j < limit;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sm.u.f.e[4 * ty + i][tx + 16 * j] =
              valid ? __fdiv_rn(expo<NATURAL>(__fsub_rn(s[i][j], m[i])), l[i]) : 0.f;
      }
      __syncthreads();
      value_product(acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int h, row;
    if (!head_row(4 * ty + i, h, row)) continue;
    const float r = EPI == kDeferred ? __fdiv_rn(1.0f, l[i])
                    : EPI == kTrain  ? __fdiv_rn(a.coef, l[i])
                                     : 1.f;
    if (EPI == kTrain && tx == 0) {
      float* sp = a.stats + (((size_t)b * a.hq + h) * N + row) * 2;
      sp[0] = m[i];
      sp[1] = l[i];
    }
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int d = tx + 16 * j;
      if (d < a.out_dp)
        ob[row * out_row + h * a.out_dp + out_col(d, D, a.out_dp)] =
            EPI == kNatural ? acc[i][j] : __fmul_rn(acc[i][j], r);
    }
  }
}

// Up to DP = 64 three CTAs fit an SM's shared memory (66 KB each at 64):
// the register cap (80 a thread) lets them all run.
template <int DP, bool ROPE, int EPI, bool NATURAL>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 3 : 1)
    f32_attention_kernel(const F32Args a) {
  extern __shared__ float4 smem_raw[];
  F32Smem<DP>& sm = *reinterpret_cast<F32Smem<DP>*>(smem_raw);
  query_tile<DP, ROPE, EPI, NATURAL>(a, sm, blockIdx.z, blockIdx.y, blockIdx.x * QT);
}

template <int DP, bool ROPE, int EPI, bool NATURAL>
cudaError_t launch_dp(const F32Args& a, int B, cudaStream_t st) {
  const int smem = (int)sizeof(F32Smem<DP>);
  static int set = 0;
  if (!set) {
    const cudaError_t e = cudaFuncSetAttribute(f32_attention_kernel<DP, ROPE, EPI, NATURAL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = 1;
  }
  const dim3 grid((a.hq / a.hkv * a.N + QT - 1) / QT, a.hkv, B);
  f32_attention_kernel<DP, ROPE, EPI, NATURAL><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool ROPE, int EPI, bool NATURAL>
cudaError_t launch_mode(const F32Args& a, int B, cudaStream_t st) {
  const int c = EPI == kInt8V ? a.codes_d : a.D;
  const int w = a.out_dp > c ? a.out_dp : c;
  if (w <= 32) return launch_dp<32, ROPE, EPI, NATURAL>(a, B, st);
  if (w <= 64) return launch_dp<64, ROPE, EPI, NATURAL>(a, B, st);
  if (w <= 128) return launch_dp<128, ROPE, EPI, NATURAL>(a, B, st);
  if (w <= 256) return launch_dp<256, ROPE, EPI, NATURAL>(a, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The attention launches.  mode 0: B2 (RoPE, base 2, deferred); 1: B11 (base
// 2, deferred; limit N rounded up to 8, npad = limit - N); 2: B15 and B16
// (natural, limit N); 3: B2's int8 value product (RoPE,
// base 2, codes and sv from attention_v_codes on the fp32 v); 4: B12's
// attention (RoPE, base 2, natural weights); 5: B10's forward (base 2,
// limit N, dropout and the statistics of F32Args' train fields).  The
// views and scalars in *a (F32Args above); D <= out_dp <= 256, out_dp - D
// even (and codes_d <= 256), D even under RoPE.  One launch.
extern "C" int attention_f32(const F32Args* a, int mode, int B, void* stream) {
  const bool rope = mode == 0 || mode == 3 || mode == 4;
  if (a->D < 1 || (rope && a->D % 2) || a->out_dp < a->D || (a->out_dp - a->D) % 2 ||
      a->hq % a->hkv || a->limit < 1 ||
      a->limit > a->N + 7 ||
      (mode == 3 && (a->codes_d < a->D || a->nk % 128)))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_mode<true, kDeferred, false>(*a, B, st);
    case 1: return launch_mode<false, kDeferred, false>(*a, B, st);
    case 2: return launch_mode<false, kNatural, true>(*a, B, st);
    case 3: return launch_mode<true, kInt8V, false>(*a, B, st);
    case 4: return launch_mode<true, kNatural, false>(*a, B, st);
    case 5: return launch_mode<false, kTrain, false>(*a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// B12: the attention (mode 4) into o [B * N, hq * out_dp] f32, then the fp32
// row quant into oq [B * N, hq * out_dp] s8 and so [B * N] f32, then the s8
// wgmma GEMM on them and wo_t [H, hq * out_dp] s8 (the out projection's
// weight K-major, heads padded to out_dp), with wos and bo [H] f32 -> out [B,
// N, H] f32; the GEMM starts under programmatic stream serialisation behind
// the quant.  Needs H % 128 == 0, hq * out_dp % 16 == 0.  Three launches.
extern "C" int attention_f32_flash_out(const F32Args* a, int B, void* o, void* oq, void* so,
                                       const void* wo_t, const void* wos, const void* bo,
                                       void* out, int H, void* stream) {
  const int M = B * a->N, K = a->hq * a->out_dp;
  if (H % 128 || K % 16 || a->out != o) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = (cudaError_t)attention_f32(a, 4, B, stream);
  if (e == cudaSuccess) e = launch_quant_rows_f32(o, oq, so, M, K, st);
  return e != cudaSuccess ? e
                          : s8_dequant<true, float>(oq, so, wo_t, wos, bo, out, M, K, H, true, st);
}
