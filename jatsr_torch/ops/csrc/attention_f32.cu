// The flash GQA attention from the unsplit fused-QKV projection in fp32, for
// Hopper: B2's fp32 mode, on fp32 FMAs outside the tensor cores.
//
// Replaces the TPU kernel gqa_attention_flash_qkv (_attn_kernel_flash_qkv,
// pallas_call :449) of the JAX package's ops/attention.py on an fp32 qkv
// (the JAX model at dtype="float32" hands it one), which writes fp32.  Its
// rounding points there, every operation in fp32:
//   q, k = x * cos + rot(x) * sin       each product and the sum rounded
//   q'   = q * fp32(scale * log2 e)
//   s    = q' @ k^T                     -inf where key col >= n_valid
//   e    = exp2(s - m), m the exact row max
//   l    = sum(e);  o = (e @ v) * (1 / l)
// The RoPE and the scale here take those roundings (no FMA contraction); the
// two products and l are fp32 sums in another order than the plain version's
// (fp32 FMAs); exp2 is evaluated in double and rounded once to fp32, more
// accurate than the hardware's ex2.approx, which is not used.
//
// What bounds it on the H100, at the fp32 serving shape (qkv [6, 352, 1792],
// keys masked past 345, D = 64): the two products over the valid keys are
// 3.73 GFLOP, 55.7 us at the 67 TFLOP/s fp32 peak outside the tensor
// cores, against 26.1 MB of compulsory traffic (7.8 us at 3.35 TB/s): the
// operations bound it.  The tensor cores would take the products only in
// TF32 (or three-pass TF32 emulation), which rounds where the JAX kernel
// does not; this kernel keeps fp32 and is slow by design: a simple kernel
// that is right, with exact fp32 arithmetic.
//
// Design.  One CTA of 256 threads for each (query tile of 64 rows, q head,
// batch): grid (ceil(N / 64), hq, B).  The tile's q rows are rotated,
// scaled and kept in shared memory.  Keys come in chunks of 64: the chunk's
// K rows are rotated as they are staged in shared memory (V beside them in
// the second pass), zero past n_valid and past the head dim D (the tile is
// DP wide, DP = 32, 64, 128 or 256 >= D).  Each thread owns a 4 x 4 block
// of the 64 x 64 scores (rows 4 ty + i, keys tx + 16 j) and a 4 x DP / 16
// block of the output.  Two passes over the keys: the first takes each
// row's exact max (the scores are recomputed in the second, not stored),
// the second e = exp2(s - m) into shared memory, l, and o += e @ V.  Then o
// * (1 / l) is written.  The padded row strides (DP + 1, 64 + 1) keep the
// column reads of K, q and e free of bank conflicts.

#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

constexpr int QT = 64;        // query rows a CTA
constexpr int KC = 64;        // keys a chunk
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4 ty .. 4 ty + 3, tx keys tx + 16 j

template <int DP>
struct F32Smem {
  float q[QT][DP + 1];
  float k[KC][DP + 1];
  float v[KC][DP];
  float e[QT][KC + 1];
};

// Element d (< D) of head h's rotated row: x * cos + rot(x) * sin, the
// half-rotation form (rot(x)[d] = -x[d + D/2] below D/2, x[d - D/2] above).
__device__ __forceinline__ float rope_at(const float* __restrict__ row, const float* __restrict__ c,
                                         const float* __restrict__ s, int d, int D) {
  const int half = D >> 1;
  const float xr = d < half ? -row[d + half] : row[d - half];
  return __fadd_rn(__fmul_rn(row[d], c[d]), __fmul_rn(xr, s[d]));
}

template <int DP>
__global__ void __launch_bounds__(THREADS) f32_attention_kernel(
    const float* __restrict__ qkv, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float* __restrict__ out, int N, int n_valid, int hq,
    int hkv, int D, float scale2) {
  extern __shared__ float4 smem_raw[];
  F32Smem<DP>& sm = *reinterpret_cast<F32Smem<DP>*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const size_t row_stride = (size_t)(hq + 2 * hkv) * D;
  const float* base = qkv + (size_t)b * N * row_stride;
  const int kcol = (hq + kvh) * D, vcol = (hq + hkv + kvh) * D;
  constexpr int OJ = DP / 16;  // output columns a thread: tx + 16 j

  for (int x = tid; x < QT * DP; x += THREADS) {
    const int r = x / DP, d = x % DP, row = q0 + r;
    float val = 0.f;
    if (row < N && d < D) {
      const float* qr = base + row * row_stride + h * D;
      val = __fmul_rn(rope_at(qr, cos_t + (size_t)row * D, sin_t + (size_t)row * D, d, D),
                      scale2);
    }
    sm.q[r][d] = val;
  }

  // The chunk's K rows rotated (and with V its V rows), zero past n_valid
  // and past D.
  auto stage = [&](int k0, bool with_v) {
    for (int x = tid; x < KC * DP; x += THREADS) {
      const int c = x / DP, d = x % DP, key = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < n_valid && d < D) {
        const float* kr = base + key * row_stride;
        kv = rope_at(kr + kcol, cos_t + (size_t)key * D, sin_t + (size_t)key * D, d, D);
        if (with_v) vv = kr[vcol + d];
      }
      sm.k[c][d] = kv;
      if (with_v) sm.v[c][d] = vv;
    }
  };
  auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.q[4 * ty + i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = sm.k[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
  };

  // Pass 1: each row's exact max over the valid keys.
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < n_valid; k0 += KC) {
    __syncthreads();
    stage(k0, false);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j < n_valid)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));

  // Pass 2: e = exp2(s - m), l and o += e @ V.
  float l[4] = {0.f, 0.f, 0.f, 0.f}, acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < n_valid; k0 += KC) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = k0 + tx + 16 * j < n_valid;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = valid ? (float)exp2((double)__fadd_rn(s[i][j], -m[i])) : 0.f;
        l[i] = __fadd_rn(l[i], e);
        sm.e[4 * ty + i][tx + 16 * j] = e;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < KC; ++c) {
      float ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ev[i] = sm.e[4 * ty + i][c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const float vv = sm.v[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ev[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], o));

  const size_t out_stride = (size_t)hq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    const float r = __fdiv_rn(1.0f, l[i]);
    float* orow = out + ((size_t)b * N + row) * out_stride + h * D;
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = __fmul_rn(acc[i][j], r);
    }
  }
}

template <int DP>
cudaError_t launch_dp(const float* qkv, const float* cos_t, const float* sin_t, float* out, int B,
                      int N, int n_valid, int hq, int hkv, int D, float scale2, cudaStream_t st) {
  const int smem = (int)sizeof(F32Smem<DP>);
  static int set = 0;
  if (!set) {
    const cudaError_t e = cudaFuncSetAttribute(
        f32_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = 1;
  }
  const dim3 grid((N + QT - 1) / QT, hq, B);
  f32_attention_kernel<DP><<<grid, THREADS, smem, st>>>(qkv, cos_t, sin_t, out, N, n_valid, hq,
                                                        hkv, D, scale2);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, (hq + 2 hkv) * D] f32, contiguous, before RoPE; cos_t, sin_t
// [N, D] f32; keys at or past n_valid (1 <= n_valid <= N) masked; scale2 =
// fp32(1 / sqrt(D) * log2 e).  -> out [B, N, hq * D] f32, contiguous.  D
// even, at most 256.  One launch.
extern "C" int attention_f32(const void* qkv, const void* cos_t, const void* sin_t, void* out,
                             int B, int N, int n_valid, int hq, int hkv, int D, float scale2,
                             void* stream) {
  if (D < 2 || D % 2 || D > 256 || hq % hkv || n_valid < 1 || n_valid > N)
    return cudaErrorInvalidValue;
  auto Q = (const float*)qkv;
  auto C = (const float*)cos_t;
  auto S = (const float*)sin_t;
  auto O = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return launch_dp<32>(Q, C, S, O, B, N, n_valid, hq, hkv, D, scale2, st);
  if (D <= 64) return launch_dp<64>(Q, C, S, O, B, N, n_valid, hq, hkv, D, scale2, st);
  if (D <= 128) return launch_dp<128>(Q, C, S, O, B, N, n_valid, hq, hkv, D, scale2, st);
  return launch_dp<256>(Q, C, S, O, B, N, n_valid, hq, hkv, D, scale2, st);
}
