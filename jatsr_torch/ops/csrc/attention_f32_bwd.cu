// B10's backward in fp32, for Hopper: the fp32 mode of the JAX package's
// _attn_train_bwd_kernel (ops/attention_train.py, pallas_call :312 in
// _attn_train_bwd), on fp32 FMAs outside the tensor cores.  Its forward is
// attention_f32.cu's train mode, whose row max and l it reads.
//
// The math, per (batch b, q head h, kv head h / G, row i, key j < N), every
// operation in fp32 and nothing rounded between the products (at fp32 the
// JAX kernel's casts are no-ops):
//   s    = q'_i . k_j, q' = q * fp32(scale * log2 e)  (the forward's sum:
//          fp32 FMAs over the padded head dim in order, so s <= m exactly)
//   p    = exp2(s - m_i) / l_i  (exp2 in double rounded once; the divide
//          correctly rounded, fdiv_rn.cuh)
//   dwd  = do_i . v_j;  kc = keep ? coef : 0;  dw = dwd kc;  wd = p kc
//          (without dropout dw = dwd, wd = p)
//   delta_i = rowsum(do_i * o_i)
//   ds   = (p (dw - delta_i)) scale
//   dv_j += wd do_i,  dk_j += ds q_i (q unscaled),  dq_i = sum_j ds k_j
// dk and dv are summed over the group's G q heads in fp32 registers.
//
// What bounds it on the H100, at the v3mod2 step's shape (B 28, N 345,
// Hq 20, Hkv 4, D 64): five products of 2 B Hq N^2 D = 8.53 GFLOP each,
// 42.6 GFLOP (0.636 ms at the 67 TFLOP/s fp32 peak outside the tensor
// cores) against ~240 MB of compulsory traffic (71 us at 3.35 TB/s): the
// operations bound it.
//
// Design: three launches, no atomics, so two runs give bit-equal grads.
//   1. rows: delta_i = rowsum(do_i * o_i), a warp a (batch, row, q head).
//   2. dk/dv: a CTA of 256 threads per (T keys, kv head, batch), K and V of
//      its keys resident in shared memory; the G heads' G N rows stacked
//      (as the forward stacks them) stream through in chunks of T: each
//      chunk's q and do staged, s and dwd formed (thread (ty, tx): keys
//      TI ty .., rows tx + 16 j), ds^T and wd^T written to shared memory,
//      then dv += wd^T do and dk += ds^T q on the thread's TI keys x DP / 16
//      columns.
//   3. dq: a CTA per (T stacked rows, kv head, batch), q' and do resident;
//      the keys stream through in chunks of T (K and V staged): s, dwd and
//      ds again, then dq += ds K.
// The scores are formed twice (launches 2 and 3): seven products where the
// TPU kernel has five, for no atomics and no [N, N] scratch.  T = 64 up to
// DP = 128 and 32 at DP = 256 (shared memory); DP = 32, 64, 128 or 256 >= D
// is the forward's padded head dim (the same sums).  The launch plan is
// ops/attention_train.py:_f32_train_plan, checked on the CPU for every
// N <= 768 and D <= 256.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "fdiv_rn.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// The launch's views and scalars.  q, o, do and dq are [B, N, hq * D]
// fp32, k, v, dk and dv [B, N, hkv * D], all contiguous; stats [B, hq, N,
// 2] the forward's (m, l); delta a [B, hq, N] scratch.
struct F32BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* stats;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int N, hq, hkv, D;
  int np, dropout;
  uint32_t seed, thr;
  float scale2, scale, coef;  // fp32(scale * log2 e), fp32(scale), fp32(1 / (1 - rate))
  int b0;                     // the batch's first row in the global batch (the hash's b)
  int h0;                     // the launch's first q head among all heads (the hash's h)
};

namespace {

constexpr int THREADS = 256;  // 16 x 16

template <int DP>
struct Tile {
  static constexpr int T = DP <= 128 ? 64 : 32;  // keys (rows) of a tile and of a chunk
  static constexpr int TI = T / 16;              // resident items a thread: TI ty ..
  static constexpr int TJ = T / 16;              // streamed items a thread: tx + 16 j
  static constexpr int OJ = DP / 16;             // output columns a thread: tx + 16 j
};

// What a stacked row needs besides its q and do.
struct RowInfo {
  float m, l, y, delta;  // y = rcp_rn(l)
  uint32_t stream;
  int pos;               // the row's position n; -1: no row
};

template <int DP>
struct DkdvSmem {
  static constexpr int T = Tile<DP>::T;
  float k[T][DP + 1];
  float v[T][DP + 1];
  float q[T][DP + 1];
  float dout[T][DP + 1];
  float ds[T][T + 1];  // [key][row]
  float wd[T][T + 1];
  RowInfo row[T];
};

template <int DP>
struct DqSmem {
  static constexpr int T = Tile<DP>::T;
  float q[T][DP + 1];  // scaled: q'
  float dout[T][DP + 1];
  float k[T][DP + 1];
  float v[T][DP + 1];
  float ds[T][T + 1];  // [row][key]
  RowInfo row[T];
};

__device__ __forceinline__ float exp2_once(float x) { return (float)exp2((double)x); }

// Stacked row sr of kv head kvh (head kvh G + sr / N, position sr % N):
// its statistics, or pos = -1 past the G N rows.
__device__ __forceinline__ RowInfo row_info(const F32BwdArgs& a, int b, int kvh, int sr) {
  const int G = a.hq / a.hkv;
  RowInfo r;
  if (sr >= G * a.N) {
    r.m = 0.f;
    r.l = r.y = 1.f;
    r.delta = 0.f;
    r.stream = 0u;
    r.pos = -1;
    return r;
  }
  const int h = kvh * G + sr / a.N, n = sr % a.N;
  const size_t at = ((size_t)b * a.hq + h) * a.N + n;
  r.m = a.stats[2 * at];
  r.l = a.stats[2 * at + 1];
  r.y = reciprocal(r.l);
  r.delta = a.delta[at];
  r.stream = stream_of(b + a.b0, a.h0 + h, a.seed);
  r.pos = n;
  return r;
}

// Stage `rows` rows of a [B, N, heads * D] view into a [T][DP + 1] tile,
// zero past D and where at(r) < 0; at(r): the element offset of row r's
// head, or -1.  With SCALE, each element times scale2, rounded once.
template <int DP, int T, bool SCALE, typename At>
__device__ __forceinline__ void stage(float (*dst)[DP + 1], const float* __restrict__ src, int D,
                                      float scale2, At at) {
  for (int x = threadIdx.x; x < T * DP; x += THREADS) {
    const int r = x / DP, d = x % DP;
    const long long off = at(r);
    float val = 0.f;
    if (off >= 0 && d < D) {
      val = src[off + d];
      if (SCALE) val = __fmul_rn(val, scale2);
    }
    dst[r][d] = val;
  }
}

// ds and wd of one (row, key) pair from its score s and dwd.
__device__ __forceinline__ void pair_grads(const F32BwdArgs& a, const RowInfo& r, int key,
                                           float s, float dwd, float& ds, float& wd) {
  if (r.pos < 0 || key >= a.N) {
    ds = wd = 0.f;
    return;
  }
  const float p = quotient(exp2_once(__fsub_rn(s, r.m)), r.l, r.y);
  float dw = dwd;
  wd = p;
  if (a.dropout) {
    const float kc = kept(r.stream, r.pos, key, a.np, a.thr) ? a.coef : 0.f;
    dw = __fmul_rn(dwd, kc);
    wd = __fmul_rn(p, kc);
  }
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dw, r.delta)), a.scale);
}

// Launch 1: delta = rowsum(do * o), a warp a (batch, row, q head).
__global__ void __launch_bounds__(THREADS) delta_kernel(const F32BwdArgs a, int total) {
  const int w = (blockIdx.x * THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= total) return;
  const int h = w % a.hq, bn = w / a.hq;  // bn = b N + n
  const size_t base = (size_t)bn * a.hq * a.D + (size_t)h * a.D;
  float acc = 0.f;
  for (int d = lane; d < a.D; d += 32) acc = fmaf(a.dout[base + d], a.o[base + d], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0) {
    const int b = bn / a.N, n = bn % a.N;
    a.delta[((size_t)b * a.hq + h) * a.N + n] = acc;
  }
}

// Launch 2: dk and dv of T keys (c0 = blockIdx.x T) of kv head blockIdx.y,
// batch blockIdx.z.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1) dkdv_kernel(const F32BwdArgs a) {
  using TL = Tile<DP>;
  constexpr int T = TL::T, TI = TL::TI, TJ = TL::TJ, OJ = TL::OJ;
  extern __shared__ float4 smem_raw[];
  DkdvSmem<DP>& sm = *reinterpret_cast<DkdvSmem<DP>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, kvh = blockIdx.y, c0 = blockIdx.x * T;
  const int N = a.N, D = a.D, G = a.hq / a.hkv, rows = G * N;
  const long long qrow = (long long)a.hq * D, krow = (long long)a.hkv * D;
  const long long qb = (long long)b * N * qrow, kb = (long long)b * N * krow + (long long)kvh * D;

  auto key_at = [&](int c) { return c0 + c < N ? kb + (c0 + c) * krow : -1LL; };
  stage<DP, T, false>(sm.k, a.k, D, 0.f, key_at);
  stage<DP, T, false>(sm.v, a.v, D, 0.f, key_at);

  float dk[TI][OJ], dv[TI][OJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += T) {
    __syncthreads();  // the previous chunk's products are done
    auto row_at = [&](int r) {
      const int sr = r0 + r;
      if (sr >= rows) return -1LL;
      const int h = kvh * G + sr / N, n = sr % N;
      return qb + n * qrow + (long long)h * D;
    };
    stage<DP, T, false>(sm.q, a.q, D, 0.f, row_at);
    stage<DP, T, false>(sm.dout, a.dout, D, 0.f, row_at);
    if (tid < T) sm.row[tid] = row_info(a, b, kvh, r0 + tid);
    __syncthreads();

    float s[TI][TJ], w[TI][TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) s[i][j] = w[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kk[TI], vv[TI], qv[TJ], dd[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        kk[i] = sm.k[TI * ty + i][d];
        vv[i] = sm.v[TI * ty + i][d];
      }
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        qv[j] = __fmul_rn(sm.q[tx + 16 * j][d], a.scale2);
        dd[j] = sm.dout[tx + 16 * j][d];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          s[i][j] = fmaf(qv[j], kk[i], s[i][j]);
          w[i][j] = fmaf(dd[j], vv[i], w[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const RowInfo r = sm.row[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        float ds, wd;
        pair_grads(a, r, c0 + TI * ty + i, s[i][j], w[i][j], ds, wd);
        sm.ds[TI * ty + i][tx + 16 * j] = ds;
        sm.wd[TI * ty + i][tx + 16 * j] = wd;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < T; ++r) {
      float dsr[TI], wdr[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        dsr[i] = sm.ds[TI * ty + i][r];
        wdr[i] = sm.wd[TI * ty + i][r];
      }
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const float qv = sm.q[r][tx + 16 * j], dd = sm.dout[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          dk[i][j] = fmaf(dsr[i], qv, dk[i][j]);
          dv[i][j] = fmaf(wdr[i], dd, dv[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int key = c0 + TI * ty + i;
    if (key >= N) continue;
    const long long at = kb + key * krow;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        a.dk[at + d] = dk[i][j];
        a.dv[at + d] = dv[i][j];
      }
    }
  }
}

// Launch 3: dq of T stacked rows (q0 = blockIdx.x T) of kv head blockIdx.y,
// batch blockIdx.z.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= 64 ? 2 : 1) dq_kernel(const F32BwdArgs a) {
  using TL = Tile<DP>;
  constexpr int T = TL::T, TI = TL::TI, TJ = TL::TJ, OJ = TL::OJ;
  extern __shared__ float4 smem_raw[];
  DqSmem<DP>& sm = *reinterpret_cast<DqSmem<DP>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, kvh = blockIdx.y, q0 = blockIdx.x * T;
  const int N = a.N, D = a.D, G = a.hq / a.hkv, rows = G * N;
  const long long qrow = (long long)a.hq * D, krow = (long long)a.hkv * D;
  const long long qb = (long long)b * N * qrow, kb = (long long)b * N * krow + (long long)kvh * D;

  auto row_at = [&](int r) {
    const int sr = q0 + r;
    if (sr >= rows) return -1LL;
    const int h = kvh * G + sr / N, n = sr % N;
    return qb + n * qrow + (long long)h * D;
  };
  stage<DP, T, true>(sm.q, a.q, D, a.scale2, row_at);
  stage<DP, T, false>(sm.dout, a.dout, D, 0.f, row_at);
  if (tid < T) sm.row[tid] = row_info(a, b, kvh, q0 + tid);

  float dq[TI][OJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) dq[i][j] = 0.f;

  for (int c0 = 0; c0 < N; c0 += T) {
    __syncthreads();  // the previous chunk's product is done (and the rows staged)
    auto key_at = [&](int c) { return c0 + c < N ? kb + (c0 + c) * krow : -1LL; };
    stage<DP, T, false>(sm.k, a.k, D, 0.f, key_at);
    stage<DP, T, false>(sm.v, a.v, D, 0.f, key_at);
    __syncthreads();

    float s[TI][TJ], w[TI][TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) s[i][j] = w[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[TI], dd[TI], kk[TJ], vv[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        qv[i] = sm.q[TI * ty + i][d];
        dd[i] = sm.dout[TI * ty + i][d];
      }
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        kk[j] = sm.k[tx + 16 * j][d];
        vv[j] = sm.v[tx + 16 * j][d];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
          w[i][j] = fmaf(dd[i], vv[j], w[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const RowInfo r = sm.row[TI * ty + i];
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        float ds, wd;
        pair_grads(a, r, c0 + tx + 16 * j, s[i][j], w[i][j], ds, wd);
        sm.ds[TI * ty + i][tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float dsr[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) dsr[i] = sm.ds[TI * ty + i][c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const float kv = sm.k[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TI; ++i) dq[i][j] = fmaf(dsr[i], kv, dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const long long at = row_at(TI * ty + i);
    if (at < 0) continue;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) a.dq[at + d] = dq[i][j];
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int smem, int& set) {
  if (smem <= set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) set = smem;
  return e;
}

template <int DP>
cudaError_t launch_dp(const F32BwdArgs& a, int B, int dkdv_x, int dq_x, int dkdv_smem,
                      int dq_smem, cudaStream_t st) {
  if (dkdv_smem < (int)sizeof(DkdvSmem<DP>) || dq_smem < (int)sizeof(DqSmem<DP>))
    return cudaErrorInvalidValue;
  static int set_dkdv = 0, set_dq = 0;
  cudaError_t e = set_smem(dkdv_kernel<DP>, dkdv_smem, set_dkdv);
  if (e == cudaSuccess) e = set_smem(dq_kernel<DP>, dq_smem, set_dq);
  if (e != cudaSuccess) return e;
  const int total = B * a.N * a.hq;  // warps of the rows launch
  delta_kernel<<<(total + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(a, total);
  dkdv_kernel<DP><<<dim3(dkdv_x, a.hkv, B), THREADS, dkdv_smem, st>>>(a);
  dq_kernel<DP><<<dim3(dq_x, a.hkv, B), THREADS, dq_smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// B10's fp32 backward: three launches (delta, dk/dv, dq) on the views and
// scalars of *a, at the padded head dim DP (32, 64, 128 or 256, >= D) with
// the grids (dkdv_x, hkv, B) and (dq_x, hkv, B) and the dynamic shared
// memory of ops/attention_train.py's plan.  Needs N <= 768 (l <= 768 for
// fdiv_rn.cuh's divide).
extern "C" int attention_f32_bwd(const F32BwdArgs* a, int DP, int B, int dkdv_x, int dq_x,
                                 int dkdv_smem, int dq_smem, void* stream) {
  if (a->D < 1 || a->D > DP || a->N < 1 || a->N > 768 || a->hq % a->hkv)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DP) {
    case 32: return launch_dp<32>(*a, B, dkdv_x, dq_x, dkdv_smem, dq_smem, st);
    case 64: return launch_dp<64>(*a, B, dkdv_x, dq_x, dkdv_smem, dq_smem, st);
    case 128: return launch_dp<128>(*a, B, dkdv_x, dq_x, dkdv_smem, dq_smem, st);
    case 256: return launch_dp<256>(*a, B, dkdv_x, dq_x, dkdv_smem, dq_smem, st);
    default: return cudaErrorInvalidValue;
  }
}
