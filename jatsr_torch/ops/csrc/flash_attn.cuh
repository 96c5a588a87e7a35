// The attention body of B12, the flash attention with the int8 out
// projection fused in (flash_qkv.cu).  (B2 and B11 run attention_rows.cuh's
// body with its deferred epilogue, attention_deferred.cu; B15 and B16 its
// natural one.)
// flash_qkv.cu first writes the exact shared-memory images of q, K and V^T
// to scratch with its prep launch (q [B,Hq,nk,KSTR], K [B,Hkv,nk,KSTR], V^T
// [B,Hkv,D,nk+8]; rows >= N are zero; nk = N rounded up to 64), then
// launches attention_kernel below.
//
// A CTA of 4 warps owns a 64-row query tile of one q-head; each warp owns
// 16 query rows.  The CTA copies its kv-head's K and V^T (and the q tile) into
// shared memory with cp.async.  V is transposed so both mma.sync m16n8k16 B
// operands are contiguous 32-bit loads; row strides are padded by 8 bf16 so
// fragment loads hit 32 distinct banks.
//
// The TPU kernel keeps the whole [N, N] score tile in VMEM and takes one row
// max; an online (running-max) softmax would round bf16(w) against another
// max than the TPU kernel.  So the kernel makes three passes over the keys:
// the exact row max; the row sum of e (so that w = bf16(e / l) can round
// before its product); then w, accumulated @ v in registers.  The score
// product runs three times, which is cheaper than an HBM round trip of the
// fp32 scores.

#pragma once

#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim; the wrappers check
constexpr int BQ = 64;         // query rows per CTA
constexpr int BKEY = 64;       // keys per inner block
constexpr int KSTR = D + 8;    // smem row stride of K and q (bf16 elements)

// Keys covered by the shared-memory images of N rows.
__host__ __device__ __forceinline__ int key_rows(int N) { return (N + BKEY - 1) / BKEY * BKEY; }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous 16-byte copies of `bytes` (a multiple of 16) into shared memory.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int off = threadIdx.x * 16; off < bytes; off += blockDim.x * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + off), "l"(s + off));
}

// One warp's 16 query rows of q-head h in the tile qt, from the q tile qs
// and the kv-head's ks and vt in shared memory, into out [B, N, hq * 64].
// q carries bf16(scale * log2 e); keys at col >= n_valid are masked;
// e = exp2f(s - m); w = bf16(e / sum(e)), a true divide; o = bf16(w @ v).
__device__ __forceinline__ void attend(const __nv_bfloat16* ks, const __nv_bfloat16* vt,
                                       const __nv_bfloat16* qs, __nv_bfloat16* __restrict__ out,
                                       int qt, int h, int b, int N, int n_valid, int hq, int nk) {
  const int vstr = nk + 8;
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

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int jb = 0; jb < nblk; ++jb) {  // w, then @ v
    float s[8][4];
    scores(jb, s);
    // e, then w, as two statements: as one expression ptxas gave the kernel
    // 119 registers instead of 117, and it ran 5 % slower on an H100.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      s[nt][0] = __fdiv_rn(s[nt][0], l0);
      s[nt][1] = __fdiv_rn(s[nt][1], l0);
      s[nt][2] = __fdiv_rn(s[nt][2], l1);
      s[nt][3] = __fdiv_rn(s[nt][3], l1);
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

  const int row0 = qt * BQ + r0 + gid, row1 = row0 + 8;
  const int ostr = hq * D;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * D + dt * 8 + tig * 2;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * N + row0) * ostr + col) =
          pack2(acc[dt][0], acc[dt][1]);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)b * N + row1) * ostr + col) =
          pack2(acc[dt][2], acc[dt][3]);
  }
}

// A CTA per (64-row query tile, q-head, batch).
__global__ void __launch_bounds__(128) attention_kernel(
    const __nv_bfloat16* __restrict__ qp, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vtp, __nv_bfloat16* __restrict__ out, int N, int n_valid,
    int hq, int hkv, int nk) {
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
  attend(ks, vt, qs, out, qt, h, b, N, n_valid, hq, nk);
}

// Dynamic shared memory of attention_kernel for N keys.
int smem_bytes(int N) {
  const int nk = key_rows(N);
  return (nk * KSTR + D * (nk + 8) + BQ * KSTR) * 2;
}

// Bytes of scratch for the prep images (q, K, V^T), all 16-byte aligned.
long long image_bytes(int B, int N, int hq, int hkv) {
  const long long nk = key_rows(N);
  return 2LL * B * ((hq + hkv) * nk * KSTR + hkv * D * (nk + 8));
}

// The three images inside scratch.
struct Images {
  __nv_bfloat16 *q, *k, *vt;
};

Images images(void* scratch, int B, int N, int hq, int hkv) {
  const size_t nk = key_rows(N);
  __nv_bfloat16* q = (__nv_bfloat16*)scratch;
  __nv_bfloat16* k = q + (size_t)B * hq * nk * KSTR;
  return {q, k, k + (size_t)B * hkv * nk * KSTR};
}

// attention_kernel on prepared images into out [B, N, hq * 64] bf16.
cudaError_t run_attention(const Images& im, __nv_bfloat16* out, int B, int N, int n_valid,
                          int hq, int hkv, cudaStream_t st) {
  const int smem = smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BQ - 1) / BQ, hq, B);
  attention_kernel<<<grid, 128, smem, st>>>(im.q, im.k, im.vt, out, N, n_valid, hq, hkv,
                                            key_rows(N));
  return cudaGetLastError();
}

}  // namespace
