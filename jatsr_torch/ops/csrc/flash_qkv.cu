// Flash GQA attention from the unsplit fused-QKV projection, for Hopper.
//
// Replaces the TPU kernel gqa_attention_flash_qkv (_attn_kernel_flash_qkv,
// default branch: no int8_qk, no bf16_weights) in the JAX package's
// ops/attention.py.  Same math and rounding points:
//   k, q  = RoPE in bf16: x*cos + rot(x)*sin, each op rounded to bf16
//           (cos/sin are the fp32 tables cast to bf16 first)
//   q     = bf16(q * bf16(scale * log2 e))
//   s     = q @ k^T, fp32 accumulation; s = -inf where key col >= n_valid
//   e     = exp2f(s - rowmax(s)), fp32 (no fast-math exp2)
//   o     = (bf16(e) @ v) fp32, then * (1 / sum(e)), then bf16
//
// What bounds it on the H100: at the v3 serving shape (qkv [6, 345, 1792],
// Hq=20, Hkv=4, D=64) the two products are 3.66 GFLOP (3.7 us at the
// 989 TFLOP/s bf16 peak) against 12.9 MB of compulsory traffic (qkv and
// the tables in, the output out: 3.9 us at 3.35 TB/s).  The two bounds
// are level, bytes slightly ahead; the 14 M exp2 evaluations add SFU
// work beside both.
//
// Design.  Two launches in one C call.
//   1. flash_prep, fully parallel: RoPE and the q scale in bf16, and V
//      transposed, written to scratch as the exact shared-memory images
//      the attention CTAs use (q [B,Hq,nk,KSTR], K [B,Hkv,nk,KSTR],
//      V^T [B,Hkv,D,nk+8]; rows >= N are zero).  A first version did this
//      inside every attention CTA, element by element: a serial chain of
//      dependent loads that took most of the kernel's time.
//   2. flash_qkv_kernel: one CTA of 4 warps per (64-row query tile,
//      q-head, batch); each warp owns 16 query rows.  The CTA copies its
//      q tile and its kv-head's (h / G) K and V^T into shared memory with
//      cp.async.  V is transposed so both mma.sync m16n8k16 B operands
//      are contiguous 32-bit loads; row strides are padded by 8 bf16 so
//      fragment loads hit 32 distinct banks.
// The TPU kernel keeps the whole [N, N] score tile in VMEM and takes one
// row max; registers cannot hold a row of 384 fp32 scores per thread, and
// an online (running-max) softmax would round bf16(e) against a different
// max than the TPU kernel.  So the kernel makes two passes over the keys:
// pass 1 takes the exact row max, pass 2 recomputes the scores, forms e
// against that max, sums it and accumulates bf16(e) @ v in registers.  The
// score product runs twice (5.5 GFLOP in all instead of 3.7), which is
// cheaper than an HBM round trip of the 57 MB fp32 score tensor.
// Padded keys are zero and masked.
//
// The same file holds B12, gqa_attention_flash_out (_attn_kernel_flash_out
// in the JAX package's ops/attention.py): B2's attention with NORMALISED
// weights, then the row quant of the [N, Hq*D] output, the int8 out
// projection and its bias.  Its rounding points where they differ from B2:
//   l     = sum(e) over the row, fp32 (a third pass over the keys)
//   w     = bf16(e / l), a true fp32 divide, rounded BEFORE the product
//   o_h   = bf16(w @ v) per head, no rescale
//   so    = max(max|o_row| * INV127, 1e-12) over the whole Hq*D row
//   o_q   = rint(o / so); out = bf16(((float)(o_q @ wo) * so) * wos + bo)
// At the serving shape (qkv [6, 352, 1792], keys masked past 345, wo
// [1280, 1280]) it is 3.80 GFLOP bf16 (3.84 us at 989 TFLOP/s) plus 6.92 G
// int8 operations (3.50 us at 1979 TOP/s) against 14.6 MB (4.4 us at
// 3.35 TB/s): operations bound it.  Design: four launches in one C call,
// flash_prep, the attention kernel below with NORM = true (it writes the
// bf16 o to device memory), quant_rows and gemm_dequant<true> of
// int8_gemm.cuh.  The TPU kernel keeps o in VMEM and quantises it there; a
// CTA here owns one head of 64 rows, not the whole 1280-wide row the
// quantisation needs, so o makes one round trip (5.4 MB, L2-resident).

#include <math.h>

#include "int8_gemm.cuh"

namespace {

constexpr int D = 64;          // head dim; the wrapper checks
constexpr int BQ = 64;         // query rows per CTA
constexpr int BKEY = 64;       // keys per inner block
constexpr int KSTR = D + 8;    // smem row stride of K and q (bf16 elements)

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// RoPE of element d of one head row (half rotation), bf16 rounding per op.
__device__ __forceinline__ float rope(const __nv_bfloat16* x, int d, float c, float s) {
  float xd = __bfloat162float(x[d]);
  float xr = (d < D / 2) ? -__bfloat162float(x[d + D / 2]) : __bfloat162float(x[d - D / 2]);
  float a = bf16r(xd * bf16r(c));
  float b = bf16r(xr * bf16r(s));
  return bf16r(a + b);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Scratch images of q (roped, scaled), K (roped) and V^T; see the header.
__global__ void __launch_bounds__(256) flash_prep(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ qp,
    __nv_bfloat16* __restrict__ kp, __nv_bfloat16* __restrict__ vtp,
    int N, int nk, int hq, int hkv, float scale2) {
  __shared__ float tile[32][D + 1];
  const int hh = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * 32;
  const int td = (hq + 2 * hkv) * D;
  const bool is_v = hh >= hq + hkv;
  for (int e = threadIdx.x; e < 32 * D; e += blockDim.x) {
    const int i = e / D, d = e % D, j = r0 + i;
    float val = 0.f;
    if (j < N) {
      const __nv_bfloat16* x = qkv + ((size_t)b * N + j) * td + hh * D;
      if (is_v) {
        val = __bfloat162float(x[d]);
      } else {
        val = rope(x, d, cos_t[j * D + d], sin_t[j * D + d]);
        if (hh < hq) val = bf16r(val * scale2);
      }
    }
    if (hh < hq)
      qp[(((size_t)b * hq + hh) * nk + j) * KSTR + d] = __float2bfloat16_rn(val);
    else if (!is_v)
      kp[(((size_t)b * hkv + hh - hq) * nk + j) * KSTR + d] = __float2bfloat16_rn(val);
    else
      tile[i][d] = val;
  }
  if (!is_v) return;
  __syncthreads();
  const int vstr = nk + 8;
  __nv_bfloat16* vt = vtp + ((size_t)b * hkv + hh - hq - hkv) * D * vstr;
  for (int e = threadIdx.x; e < 32 * D; e += blockDim.x) {
    const int d = e / 32, i = e % 32;
    vt[d * vstr + r0 + i] = __float2bfloat16_rn(tile[i][d]);
  }
}

// Asynchronous 16-byte copies of `bytes` (a multiple of 16) into shared memory.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int off = threadIdx.x * 16; off < bytes; off += blockDim.x * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + off), "l"(s + off));
}

// NORM = false is B2: pass 1 takes the exact row max, pass 2 accumulates
// bf16(e) @ v and sum(e), and the output is scaled by 1 / sum(e) at the end.
// NORM = true is B12's attention: a pass for sum(e) sits between the two,
// so that pass 3 can form w = bf16(e / l) before its product, and each
// head's output is bf16(w @ v) as it stands.
template <bool NORM>
__global__ void __launch_bounds__(128) flash_qkv_kernel(
    const __nv_bfloat16* __restrict__ qp, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vtp, __nv_bfloat16* __restrict__ out,
    int N, int n_valid, int hq, int hkv, int nk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vstr = nk + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [nk][KSTR]
  __nv_bfloat16* vt = ks + nk * KSTR;                           // [D][vstr]
  __nv_bfloat16* qs = vt + D * vstr;                            // [BQ][KSTR]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  copy_async(ks, kp + ((size_t)b * hkv + kvh) * nk * KSTR, nk * KSTR * 2);
  copy_async(vt, vtp + ((size_t)b * hkv + kvh) * D * vstr, D * vstr * 2);
  copy_async(qs, qp + (((size_t)b * hq + h) * nk + qt * BQ) * KSTR, BQ * KSTR * 2);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;

  uint32_t qa[4][4];  // A fragments of the warp's 16 x 64 q rows
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p = qs + (r0 + gid) * KSTR + kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * KSTR);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * KSTR + 8);
  }

  // Scores of key block jb: s[nt][0..1] row gid, s[nt][2..3] row gid+8,
  // keys jb*64 + nt*8 + tig*2 + {0, 1}.
  auto scores = [&](int jb, float s[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* p = ks + (jb * BKEY + nt * 8 + gid) * KSTR + kk * 16 + tig * 2;
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 8));
      }
      const int col = jb * BKEY + nt * 8 + tig * 2;
      if (col >= n_valid) s[nt][0] = s[nt][2] = -INFINITY;
      if (col + 1 >= n_valid) s[nt][1] = s[nt][3] = -INFINITY;
    }
  };
  // The two rows' sums over the quad of lanes that share them.
  auto quad_sum = [&](float& a, float& c) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
  };

  const int nblk = nk / BKEY;
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int jb = 0; jb < nblk; ++jb) {  // pass 1: exact row max
    float s[8][4];
    scores(jb, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  float l0 = 0.f, l1 = 0.f;
  if (NORM) {
    for (int jb = 0; jb < nblk; ++jb) {  // the row sum of e, before any product
      float s[8][4];
      scores(jb, s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        l0 += exp2f(s[nt][0] - m0) + exp2f(s[nt][1] - m0);
        l1 += exp2f(s[nt][2] - m1) + exp2f(s[nt][3] - m1);
      }
    }
    quad_sum(l0, l1);
  }

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int jb = 0; jb < nblk; ++jb) {  // e (B2: and sum(e)) or w, then @ v
    float s[8][4];
    scores(jb, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      if (NORM) {
        s[nt][0] = __fdiv_rn(s[nt][0], l0);
        s[nt][1] = __fdiv_rn(s[nt][1], l0);
        s[nt][2] = __fdiv_rn(s[nt][2], l1);
        s[nt][3] = __fdiv_rn(s[nt][3], l1);
      } else {
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys kk*16 .. kk*16+15 of the block
      uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]), pack2(s[2 * kk][2], s[2 * kk][3]),
                        pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* p = vt + (dt * 8 + gid) * vstr + jb * BKEY + kk * 16 + tig * 2;
        mma_bf16(acc[dt], pa, *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }
  }
  float rr0 = 1.0f, rr1 = 1.0f;
  if (!NORM) {
    quad_sum(l0, l1);
    rr0 = 1.0f / l0;
    rr1 = 1.0f / l1;
  }

  const int row0 = qt * BQ + r0 + gid, row1 = row0 + 8;
  const int ostr = hq * D;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * D + dt * 8 + tig * 2;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * N + row0) * ostr + col) =
          NORM ? pack2(acc[dt][0], acc[dt][1]) : pack2(acc[dt][0] * rr0, acc[dt][1] * rr0);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * N + row1) * ostr + col) =
          NORM ? pack2(acc[dt][2], acc[dt][3]) : pack2(acc[dt][2] * rr1, acc[dt][3] * rr1);
  }
}

// Dynamic shared memory for N keys (keys padded to a multiple of 64).
int smem_bytes(int N) {
  const int nk = (N + BKEY - 1) / BKEY * BKEY;
  return (nk * KSTR + D * (nk + 8) + BQ * KSTR) * 2;
}

// flash_prep into scratch, then the attention kernel into out [B, N, hq * 64].
template <bool NORM>
cudaError_t attention(const void* qkv, const void* cos_t, const void* sin_t, void* scratch,
                      __nv_bfloat16* out, int B, int N, int n_valid, int hq, int hkv,
                      float scale2, cudaStream_t st) {
  const int nk = (N + BKEY - 1) / BKEY * BKEY;
  __nv_bfloat16* qp = (__nv_bfloat16*)scratch;
  __nv_bfloat16* kp = qp + (size_t)B * hq * nk * KSTR;
  __nv_bfloat16* vtp = kp + (size_t)B * hkv * nk * KSTR;
  flash_prep<<<dim3(nk / 32, hq + 2 * hkv, B), 256, 0, st>>>(
      (const __nv_bfloat16*)qkv, (const float*)cos_t, (const float*)sin_t, qp, kp, vtp, N, nk,
      hq, hkv, scale2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = smem_bytes(N);
  e = cudaFuncSetAttribute(flash_qkv_kernel<NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BQ - 1) / BQ, hq, B);
  flash_qkv_kernel<NORM><<<grid, 128, smem, st>>>(qp, kp, vtp, out, N, n_valid, hq, hkv, nk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_qkv_smem_bytes(int N) { return smem_bytes(N); }

// Bytes of scratch for the prep images (q, K, V^T), all 16-byte aligned.
extern "C" long long flash_qkv_scratch_bytes(int B, int N, int hq, int hkv) {
  const long long nk = (N + BKEY - 1) / BKEY * BKEY;
  return 2LL * B * ((hq + hkv) * nk * KSTR + hkv * D * (nk + 8));
}

// qkv [B, N, (hq + 2 hkv) * 64] bf16, cos/sin [N, 64] f32 -> out [B, N, hq * 64]
// bf16.  scale2 is bf16(scale * log2 e), passed as a float.  scratch holds
// flash_qkv_scratch_bytes(B, N, hq, hkv) bytes.
extern "C" int flash_qkv(const void* qkv, const void* cos_t, const void* sin_t, void* scratch,
                         void* out, int B, int N, int n_valid, int hq, int hkv, float scale2,
                         void* stream) {
  return attention<false>(qkv, cos_t, sin_t, scratch, (__nv_bfloat16*)out, B, N, n_valid, hq,
                          hkv, scale2, (cudaStream_t)stream);
}

// B12.  As flash_qkv, then the out projection: wo [hq * 64, H] s8, wos and
// bo [H] f32 -> out [B, N, H] bf16.  Scratch besides the prep images: o
// [B * N, hq * 64] bf16, oq [B * N, hq * 64] s8, so [B * N] f32.  Needs
// H % 128 == 0.
extern "C" int flash_out(const void* qkv, const void* cos_t, const void* sin_t, const void* wo,
                         const void* wos, const void* bo, void* scratch, void* o, void* oq,
                         void* so, void* out, int B, int N, int n_valid, int hq, int hkv, int H,
                         float scale2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = attention<true>(qkv, cos_t, sin_t, scratch, (__nv_bfloat16*)o, B, N, n_valid,
                                  hq, hkv, scale2, st);
  if (e != cudaSuccess) return e;
  const int M = B * N, K = hq * D;
  quant_rows<<<(M + 7) / 8, 256, 0, st>>>((const __nv_bfloat16*)o, (int8_t*)oq, (float*)so,
                                          nullptr, M, K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gemm_dequant<true><<<dim3(H / BN, (M + BM - 1) / BM), 128, 0, st>>>(
      (const int8_t*)oq, (const int8_t*)wo, (const float*)wos, (const float*)bo,
      (const float*)so, (__nv_bfloat16*)out, M, K, H);
  return cudaGetLastError();
}
