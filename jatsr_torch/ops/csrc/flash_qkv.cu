// Flash GQA attention with the int8 out projection fused in, for Hopper.
//
// Replaces the TPU kernel gqa_attention_flash_out (_attn_kernel_flash_out
// in the JAX package's ops/attention.py, :534, pallas_call :565), B12: B2's
// attention from the unsplit fused-QKV projection with NORMALISED weights,
// then the row quant of the [N, Hq*D] output, the int8 out projection and
// its bias.  Its rounding points:
//   k, q  = RoPE in bf16: x*cos + rot(x)*sin, each op rounded to bf16
//           (cos/sin are the fp32 tables cast to bf16 first)
//   q     = bf16(q * bf16(scale * log2 e))
//   s     = q @ k^T, fp32 accumulation; s = -inf where key col >= n_valid
//   e     = exp2f(s - rowmax(s)), fp32 (no fast-math exp2)
//   l     = sum(e) over the row, fp32
//   w     = bf16(e / l), a true fp32 divide, rounded BEFORE the product
//   o_h   = bf16(w @ v) per head, no rescale
//   so    = max(max|o_row| * INV127, 1e-12) over the whole Hq*D row
//   o_q   = rint(o / so); out = bf16(((float)(o_q @ wo) * so) * wos + bo)
// (B2 itself, the same attention with deferred normalisation, is
// attention_deferred.cu.)
//
// What bounds it on the H100: at the serving shape (qkv [6, 352, 1792],
// keys masked past 345, wo [1280, 1280]) it is 3.80 GFLOP bf16 (3.84 us at
// 989 TFLOP/s) plus 6.92 G int8 operations (3.50 us at 1979 TOP/s) against
// 14.6 MB (4.4 us at 3.35 TB/s): operations bound it.
//
// Design.  Four launches in one C call:
//   1. flash_prep, fully parallel: RoPE and the q scale in bf16, and V
//      transposed, written to scratch as the exact shared-memory images
//      the attention CTAs use (flash_attn.cuh).  A first version did this
//      inside every attention CTA, element by element: a serial chain of
//      dependent loads that took most of the kernel's time.
//   2. attention_kernel of flash_attn.cuh: one CTA of 4 warps per (64-row
//      query tile, q-head, batch), mma.sync m16n8k16 bf16, three passes
//      over the keys (the exact row max, the row sum, then w @ v); it
//      writes the bf16 o to device memory.  Padded keys are zero and masked.
//   3. quant_rows and 4. gemm_dequant<true> of int8_gemm.cuh.  The TPU
//      kernel keeps o in VMEM and quantises it there; a CTA here owns one
//      head of 64 rows, not the whole 1280-wide row the quantisation needs,
//      so o makes one round trip (5.4 MB, L2-resident).

#include "flash_attn.cuh"
#include "int8_gemm.cuh"

namespace {

// RoPE of element d of one head row (half rotation), bf16 rounding per op.
__device__ __forceinline__ float rope(const __nv_bfloat16* x, int d, float c, float s) {
  float xd = __bfloat162float(x[d]);
  float xr = (d < D / 2) ? -__bfloat162float(x[d + D / 2]) : __bfloat162float(x[d - D / 2]);
  float a = bf16r(xd * bf16r(c));
  float b = bf16r(xr * bf16r(s));
  return bf16r(a + b);
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

// flash_prep into scratch, then the attention kernel into out [B, N, hq * 64].
cudaError_t attention(const void* qkv, const void* cos_t, const void* sin_t, void* scratch,
                      __nv_bfloat16* out, int B, int N, int n_valid, int hq, int hkv,
                      float scale2, cudaStream_t st) {
  const int nk = key_rows(N);
  const Images im = images(scratch, B, N, hq, hkv);
  flash_prep<<<dim3(nk / 32, hq + 2 * hkv, B), 256, 0, st>>>(
      (const __nv_bfloat16*)qkv, (const float*)cos_t, (const float*)sin_t, im.q, im.k, im.vt, N,
      nk, hq, hkv, scale2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return run_attention(im, out, B, N, n_valid, hq, hkv, st);
}

}  // namespace

extern "C" int flash_qkv_smem_bytes(int N) { return smem_bytes(N); }

// Bytes of scratch for the prep images (q, K, V^T), all 16-byte aligned.
extern "C" long long flash_qkv_scratch_bytes(int B, int N, int hq, int hkv) {
  return image_bytes(B, N, hq, hkv);
}

// qkv [B, N, (hq + 2 hkv) * 64] bf16, cos/sin [N, 64] f32, wo [hq * 64, H]
// s8, wos and bo [H] f32 -> out [B, N, H] bf16.  scale2 is bf16(scale *
// log2 e), passed as a float.  scratch holds flash_qkv_scratch_bytes(B, N,
// hq, hkv) bytes of prep images; besides them o [B * N, hq * 64] bf16, oq
// [B * N, hq * 64] s8, so [B * N] f32.  Needs H % 128 == 0.
extern "C" int flash_out(const void* qkv, const void* cos_t, const void* sin_t, const void* wo,
                         const void* wos, const void* bo, void* scratch, void* o, void* oq,
                         void* so, void* out, int B, int N, int n_valid, int hq, int hkv, int H,
                         float scale2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = attention(qkv, cos_t, sin_t, scratch, (__nv_bfloat16*)o, B, N, n_valid, hq,
                            hkv, scale2, st);
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
