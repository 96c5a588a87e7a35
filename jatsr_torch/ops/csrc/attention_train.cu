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
//   backward  p    = exp2f(s - m) / l; kc = keep ? coef : 0
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
// sit near the ridge; the 67 M exp2 and two hashes per score add SFU and
// integer work beside the tensor cores.
//
// Design (mma.sync m16n8k16 bf16 with fp32 accumulation; wgmma and TMA are
// left to a later version).  The TPU kernel keeps a batch element's whole
// [Np, Np] score tile per head in VMEM; a CTA cannot, so:
//   forward   one CTA of 4 warps per (64-query tile, q-head, batch), each
//             warp 16 rows.  The kv-head's whole K and V sit in shared memory
//             (cp.async, zero rows past N).  The exact row max (the rounding
//             of bf16(e) depends on it, so no online softmax) takes a first
//             pass over the keys; the second forms e, l, the dropout and
//             bf16(e) @ v (V read with ldmatrix.trans).  It also writes the
//             row max and l ([B, Hq, N, 2] fp32) for the backward.
//   backward  two launches, no atomics, so two runs give bit-equal grads:
//     1. dq: one CTA per (64-query tile, q-head, batch) over all key blocks,
//        K and V in shared memory; it also writes delta for launch 2.
//     2. dk, dv: one CTA per (64-key block, kv-head, batch); each warp owns
//        16 keys and the CTA walks the G query heads and every 64-query tile
//        (q, do, m, l, delta staged in shared memory), computing the
//        transposed tiles s^T and (do v^T)^T so that wd^T and ds^T are
//        already A fragments; dk and dv accumulate in registers over all
//        G heads and are rounded once.
// Query rows and keys past N are zero in shared memory and forced to p = 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;      // head dim; the wrapper checks
constexpr int BQ = 64;     // query rows per CTA (forward, dq)
constexpr int BKEY = 64;   // keys per block
constexpr int KSTR = D + 8;  // smem row stride (bf16): conflict-free fragment loads

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(x * s) of both halves of a bf16 pair.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float s) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return pack2(__fmul_rn(__bfloat162float(v.x), s), __fmul_rn(__bfloat162float(v.y), s));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t stream_of(int b, int h, uint32_t seed) {
  return hash_u32((uint32_t)b * 0x9E3779B9u + (uint32_t)h + seed * 0x85EBCA6Bu);
}

__device__ __forceinline__ bool kept(uint32_t stream, int row, int col, int np, uint32_t thr) {
  return hash_u32(stream ^ (uint32_t)(row * np + col)) <= thr;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

// Rows r0 .. r0 + rows - 1 of one head (D columns at `src`, row stride `gstr`
// elements) into smem [rows][KSTR]; rows >= n are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int gstr, int r0, int rows,
                                          int n) {
  for (int c = threadIdx.x; c < rows * (D / 8); c += blockDim.x) {
    const int i = c / (D / 8), ch = c % (D / 8), r = r0 + i;
    const bool ok = r < n;
    cp16(dst + i * KSTR + ch * 8, ok ? src + (size_t)r * gstr + ch * 8 : src, ok);
  }
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A fragments of a warp's 16 rows (r0 ..) x 64 columns straight from global
// memory (row stride `gstr`), rows >= n zero.
__device__ __forceinline__ void load_a_global(uint32_t a[4][4], const bf16* base, int gstr, int r0,
                                              int n, int gid, int tig) {
  const int ra = r0 + gid, rb = ra + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    a[kk][0] = ra < n ? ld32(base + (size_t)ra * gstr + c) : 0u;
    a[kk][1] = rb < n ? ld32(base + (size_t)rb * gstr + c) : 0u;
    a[kk][2] = ra < n ? ld32(base + (size_t)ra * gstr + c + 8) : 0u;
    a[kk][3] = rb < n ? ld32(base + (size_t)rb * gstr + c + 8) : 0u;
  }
}

// A fragment of rows r0 .., columns k0 .. k0 + 15 of a smem tile [.][KSTR].
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int r0, int k0, int gid,
                                       int tig) {
  const bf16* p = s + (r0 + gid) * KSTR + k0 + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * KSTR);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * KSTR + 8);
}

// B fragments of B[k][n] = T[n][k] for n0 .. n0 + 7, k0 .. k0 + 15, from a
// row-major smem tile T [.][KSTR] (k contiguous).
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1, const bf16* t, int n0, int k0,
                                          int gid, int tig) {
  const bf16* p = t + (n0 + gid) * KSTR + k0 + tig * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragments of B[k][n] = T[k][n] for k0 .. k0 + 15 and n0 .. n0 + 15 (two
// n-tiles: r[0..1] the first, r[2..3] the second), from a row-major smem tile
// T [.][KSTR] (n contiguous), transposed on load.
__device__ __forceinline__ void load_b_kn(uint32_t r[4], const bf16* t, int k0, int n0, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  const bf16* p = t + (k0 + ri + (mi & 1) * 8) * KSTR + n0 + (mi >> 1) * 8;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s[nt] = A (16 rows x 64) @ T^T for the 64 rows of T starting at n0.
__device__ __forceinline__ void rows_by_tile(float s[8][4], const uint32_t a[4][4], const bf16* t,
                                             int n0, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0, b1;
      load_b_nk(b0, b1, t, n0 + nt * 8, kk * 16, gid, tig);
      mma_bf16(s[nt], a[kk], b0, b1);
    }
  }
}

// acc (16 x 64) += P (16 x 64, C-fragment floats rounded to bf16) @ T, T the
// 64 rows of a row-major smem tile starting at k0.
__device__ __forceinline__ void tile_by_rows(float acc[8][4], const float p[8][4], const bf16* t,
                                             int k0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack2(p[2 * kk][0], p[2 * kk][1]), pack2(p[2 * kk][2], p[2 * kk][3]),
                            pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      load_b_kn(r, t, k0 + kk * 16, np * 16, lane);
      mma_bf16(acc[2 * np], pa, r[0], r[1]);
      mma_bf16(acc[2 * np + 1], pa, r[2], r[3]);
    }
  }
}

__device__ __forceinline__ void zero8x4(float a[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// Store rows ra, ra + 8 of a 16 x 64 fp32 tile as bf16 (rows >= n skipped).
__device__ __forceinline__ void store_rows(bf16* base, int gstr, int ra, int n, const float acc[8][4],
                                           float r0, float r1, int tig) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (ra < n)
      *reinterpret_cast<uint32_t*>(base + (size_t)ra * gstr + c) =
          pack2(acc[dt][0] * r0, acc[dt][1] * r0);
    if (ra + 8 < n)
      *reinterpret_cast<uint32_t*>(base + (size_t)(ra + 8) * gstr + c) =
          pack2(acc[dt][2] * r1, acc[dt][3] * r1);
  }
}

struct Params {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *out, *dq, *dk, *dv;
  float *stats, *delta;
  int N, hq, hkv, nk, np;
  uint32_t seed, thr;
  float scale2, scale, coef;
  int dropout;
};

__global__ void __launch_bounds__(128) attn_fwd_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [nk][KSTR]
  bf16* vs = ks + P.nk * KSTR;               // [nk][KSTR]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (P.hq / P.hkv), qd = P.hq * D, kd = P.hkv * D;
  load_rows(ks, P.k + (size_t)b * P.N * kd + kvh * D, kd, 0, P.nk, P.N);
  load_rows(vs, P.v + (size_t)b * P.N * kd + kvh * D, kd, 0, P.nk, P.N);
  asm volatile("cp.async.commit_group;\n" ::);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int ra = qt * BQ + warp * 16 + gid, rb = ra + 8;
  uint32_t qa[4][4];
  load_a_global(qa, P.q + (size_t)b * P.N * qd + h * D, qd, qt * BQ + warp * 16, P.N, gid, tig);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], P.scale2);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int nblk = P.nk / BKEY;
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int jb = 0; jb < nblk; ++jb) {  // pass 1: exact row max
    float s[8][4];
    rows_by_tile(s, qa, ks, jb * BKEY, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = jb * BKEY + nt * 8 + tig * 2;
      if (col < P.N) { m0 = fmaxf(m0, s[nt][0]); m1 = fmaxf(m1, s[nt][2]); }
      if (col + 1 < P.N) { m0 = fmaxf(m0, s[nt][1]); m1 = fmaxf(m1, s[nt][3]); }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  const uint32_t st = stream_of(b, h, P.seed);
  float acc[8][4];
  zero8x4(acc);
  float l0 = 0.f, l1 = 0.f;
  for (int jb = 0; jb < nblk; ++jb) {  // pass 2: e, l, dropout, bf16(e) @ v
    float s[8][4];
    rows_by_tile(s, qa, ks, jb * BKEY, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jb * BKEY + nt * 8 + tig * 2 + (e & 1);
        const float x = col < P.N ? exp2f(s[nt][e] - (e < 2 ? m0 : m1)) : 0.f;
        if (e < 2) l0 += x; else l1 += x;
        s[nt][e] = (P.dropout && !kept(st, e < 2 ? ra : rb, col, P.np, P.thr)) ? 0.f : x;
      }
    }
    tile_by_rows(acc, s, vs, jb * BKEY, lane);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  store_rows(P.out + (size_t)b * P.N * qd + h * D, qd, ra, P.N, acc, P.coef / l0, P.coef / l1,
             tig);
  if (tig == 0) {
    float* sp = P.stats + ((size_t)b * P.hq + h) * P.N * 2;
    if (ra < P.N) { sp[ra * 2] = m0; sp[ra * 2 + 1] = l0; }
    if (rb < P.N) { sp[rb * 2] = m1; sp[rb * 2 + 1] = l1; }
  }
}

// p, dw and the dropout factor of one score: returns ds (unrounded) and sets
// wd; `valid` false forces p = 0.
__device__ __forceinline__ float grad_of_score(const Params& P, float s, float dwd, float m, float l,
                                               float delta, bool valid, uint32_t st, int row,
                                               int col, float& wd) {
  const float p = valid ? __fdiv_rn(exp2f(s - m), l) : 0.f;
  float dw = dwd;
  wd = p;
  if (P.dropout) {
    const float kc = kept(st, row, col, P.np, P.thr) ? P.coef : 0.f;
    dw = __fmul_rn(dwd, kc);
    wd = __fmul_rn(p, kc);
  }
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dw, delta)), P.scale);
}

__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [nk][KSTR]
  bf16* vs = ks + P.nk * KSTR;               // [nk][KSTR]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (P.hq / P.hkv), qd = P.hq * D, kd = P.hkv * D;
  load_rows(ks, P.k + (size_t)b * P.N * kd + kvh * D, kd, 0, P.nk, P.N);
  load_rows(vs, P.v + (size_t)b * P.N * kd + kvh * D, kd, 0, P.nk, P.N);
  asm volatile("cp.async.commit_group;\n" ::);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int r0 = qt * BQ + warp * 16, ra = r0 + gid, rb = ra + 8;
  const size_t head = (size_t)b * P.N * qd + h * D;
  uint32_t qa[4][4], da[4][4], oa[4][4];
  load_a_global(qa, P.q + head, qd, r0, P.N, gid, tig);
  load_a_global(da, P.dout + head, qd, r0, P.N, gid, tig);
  load_a_global(oa, P.o + head, qd, r0, P.N, gid, tig);
  float d0 = 0.f, d1 = 0.f;  // delta of rows ra, rb
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&da[kk][i]);
      const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&oa[kk][i]);
      const float t = __fadd_rn(__fmul_rn(__bfloat162float(x.x), __bfloat162float(y.x)),
                                __fmul_rn(__bfloat162float(x.y), __bfloat162float(y.y)));
      if (i == 0 || i == 2) d0 += t; else d1 += t;
    }
    for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], P.scale2);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
  const size_t row_base = ((size_t)b * P.hq + h) * P.N;
  if (tig == 0) {
    if (ra < P.N) P.delta[row_base + ra] = d0;
    if (rb < P.N) P.delta[row_base + rb] = d1;
  }
  const float m0 = ra < P.N ? P.stats[(row_base + ra) * 2] : 0.f;
  const float l0 = ra < P.N ? P.stats[(row_base + ra) * 2 + 1] : 1.f;
  const float m1 = rb < P.N ? P.stats[(row_base + rb) * 2] : 0.f;
  const float l1 = rb < P.N ? P.stats[(row_base + rb) * 2 + 1] : 1.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const uint32_t st = stream_of(b, h, P.seed);
  float acc[8][4];
  zero8x4(acc);
  for (int jb = 0; jb < P.nk / BKEY; ++jb) {
    float s[8][4], w[8][4];
    rows_by_tile(s, qa, ks, jb * BKEY, gid, tig);
    rows_by_tile(w, da, vs, jb * BKEY, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jb * BKEY + nt * 8 + tig * 2 + (e & 1);
        const bool top = e < 2;
        float wd;
        s[nt][e] = grad_of_score(P, s[nt][e], w[nt][e], top ? m0 : m1, top ? l0 : l1,
                                 top ? d0 : d1, col < P.N, st, top ? ra : rb, col, wd);
      }
    }
    tile_by_rows(acc, s, ks, jb * BKEY, lane);  // dq += bf16(ds) @ k
  }
  store_rows(P.dq + head, qd, ra, P.N, acc, 1.f, 1.f, tig);
}

__global__ void __launch_bounds__(128) attn_bwd_dkdv_kernel(Params P) {
  __shared__ __align__(16) bf16 kb[BKEY * KSTR], vb[BKEY * KSTR];
  __shared__ __align__(16) bf16 qt[BQ * KSTR], qst[BQ * KSTR], dot[BQ * KSTR];
  __shared__ float sm[BQ], sl[BQ], sd[BQ];
  const int kbk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = P.hq / P.hkv, qd = P.hq * D, kd = P.hkv * D;
  load_rows(kb, P.k + (size_t)b * P.N * kd + kvh * D, kd, kbk * BKEY, BKEY, P.N);
  load_rows(vb, P.v + (size_t)b * P.N * kd + kvh * D, kd, kbk * BKEY, BKEY, P.N);
  asm volatile("cp.async.commit_group;\n" ::);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int ka_ = kbk * BKEY + warp * 16 + gid, kb_ = ka_ + 8;  // this thread's keys
  float dk[8][4], dv[8][4];
  zero8x4(dk);
  zero8x4(dv);
  const int nrb = (P.N + BQ - 1) / BQ;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const uint32_t st = stream_of(b, h, P.seed);
    const size_t head = (size_t)b * P.N * qd + h * D, row_base = ((size_t)b * P.hq + h) * P.N;
    for (int rt = 0; rt < nrb; ++rt) {
      const int q0 = rt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_rows(qt, P.q + head, qd, q0, BQ, P.N);
      load_rows(dot, P.dout + head, qd, q0, BQ, P.N);
      if (tid < BQ) {
        const int r = q0 + tid;
        const bool ok = r < P.N;
        sm[tid] = ok ? P.stats[(row_base + r) * 2] : 0.f;
        sl[tid] = ok ? P.stats[(row_base + r) * 2 + 1] : 1.f;
        sd[tid] = ok ? P.delta[row_base + r] : 0.f;
      }
      cp_wait_all();
      __syncthreads();
      for (int c = tid; c < BQ * D / 2; c += blockDim.x) {  // q' = bf16(q * scale2)
        const int off = (c / (D / 2)) * KSTR + (c % (D / 2)) * 2;
        *reinterpret_cast<uint32_t*>(qst + off) = scale_pair(ld32(qt + off), P.scale2);
      }
      __syncthreads();

      // Transposed tiles: s^T = k q'^T and w^T = v do^T, rows = this warp's
      // 16 keys, columns = the tile's 64 queries.
      float s[8][4], w[8][4];
      zero8x4(s);
      zero8x4(w);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, kb, warp * 16, kk * 16, gid, tig);
        load_a(va, vb, warp * 16, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t b0, b1;
          load_b_nk(b0, b1, qst, nt * 8, kk * 16, gid, tig);
          mma_bf16(s[nt], ka, b0, b1);
          load_b_nk(b0, b1, dot, nt * 8, kk * 16, gid, tig);
          mma_bf16(w[nt], va, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = nt * 8 + tig * 2 + (e & 1), row = q0 + rl;
          const int key = e < 2 ? ka_ : kb_;
          float wd;
          const float ds = grad_of_score(P, s[nt][e], w[nt][e], sm[rl], sl[rl], sd[rl],
                                         row < P.N && key < P.N, st, row, key, wd);
          s[nt][e] = wd;
          w[nt][e] = ds;
        }
      }
      tile_by_rows(dv, s, dot, 0, lane);  // dv += bf16(wd)^T do
      tile_by_rows(dk, w, qt, 0, lane);   // dk += bf16(ds)^T q
    }
  }
  const size_t base = (size_t)b * P.N * kd + kvh * D;
  store_rows(P.dk + base, kd, ka_, P.N, dk, 1.f, 1.f, tig);
  store_rows(P.dv + base, kd, ka_, P.N, dv, 1.f, 1.f, tig);
}

int keys_padded(int N) { return (N + BKEY - 1) / BKEY * BKEY; }

Params make_params(int N, int hq, int hkv, unsigned seed, unsigned thr, float scale2, float scale,
                   float coef, int dropout) {
  Params P = {};
  P.N = N;
  P.hq = hq;
  P.hkv = hkv;
  P.nk = keys_padded(N);
  P.np = (N + 7) / 8 * 8;
  P.seed = seed;
  P.thr = thr;
  P.scale2 = scale2;
  P.scale = scale;
  P.coef = coef;
  P.dropout = dropout;
  return P;
}

}  // namespace

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Dynamic shared memory of the forward and of the dq launch: K and V of all
// keys (padded to a multiple of 64).
extern "C" int attn_train_smem_bytes(int N) { return 2 * keys_padded(N) * KSTR * 2; }

// q [B, N, hq * 64], k/v [B, N, hkv * 64] bf16 -> out [B, N, hq * 64] bf16,
// stats [B, hq, N, 2] f32 (row max, row sum of exp2).  scale2 is
// bf16(scale * log2 e) as a float; coef = 1 / (1 - rate); thr the keep
// threshold; dropout 0 or 1.
extern "C" int attn_train_fwd(const void* q, const void* k, const void* v, void* out, void* stats,
                              int B, int N, int hq, int hkv, unsigned seed, unsigned thr,
                              float scale2, float coef, int dropout, void* stream) {
  Params P = make_params(N, hq, hkv, seed, thr, scale2, 0.f, coef, dropout);
  P.q = (const bf16*)q;
  P.k = (const bf16*)k;
  P.v = (const bf16*)v;
  P.out = (bf16*)out;
  P.stats = (float*)stats;
  const int smem = attn_train_smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attn_fwd_kernel<<<dim3((N + BQ - 1) / BQ, hq, B), 128, smem, (cudaStream_t)stream>>>(P);
  return cudaGetLastError();
}

// The backward: o and do as q, stats from the forward, delta a [B, hq, N]
// f32 scratch -> dq as q, dk/dv as k.  Two launches: dq (and delta), then
// dk/dv.
extern "C" int attn_train_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* stats, void* delta, void* dq, void* dk,
                              void* dv, int B, int N, int hq, int hkv, unsigned seed, unsigned thr,
                              float scale2, float scale, float coef, int dropout, void* stream) {
  Params P = make_params(N, hq, hkv, seed, thr, scale2, scale, coef, dropout);
  P.q = (const bf16*)q;
  P.k = (const bf16*)k;
  P.v = (const bf16*)v;
  P.o = (const bf16*)o;
  P.dout = (const bf16*)dout;
  P.stats = (float*)stats;
  P.delta = (float*)delta;
  P.dq = (bf16*)dq;
  P.dk = (bf16*)dk;
  P.dv = (bf16*)dv;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = attn_train_smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<<<dim3((N + BQ - 1) / BQ, hq, B), 128, smem, st>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<<<dim3(P.nk / BKEY, hkv, B), 128, 0, st>>>(P);
  return cudaGetLastError();
}
