// Flash GQA attention on split, RoPE'd q, k and v, for Hopper: a TPU kernel
// of the JAX package's ops/attention.py behind one prep launch and the
// attention body of flash_attn.cuh.
//
// B11 replaces gqa_attention_flash (_attn_kernel_flash).  Its rounding
// points:
//   Np    = N rounded up to 8; q, k and v are zero-padded to Np rows
//   q     = bf16(q * bf16(scale * log2 e))
//   s     = q @ k^T, fp32 accumulation, with NO key mask: the Np - N padded
//           keys score exactly 0 and take part in the row max
//   e     = exp2f(s - m), m = max over all Np columns
//   l     = sum(e over Np) - npad * exp2f(-m)   (the padded keys' share)
//   o     = (bf16(e) @ v) fp32, then * (1 / l), then bf16
// So where every real score of a row is below 0, the padding sets the max;
// a masked softmax (B2's) rounds bf16(e) against another max and gives
// another result.  Here the keys run to Np with zero rows, masked only past
// Np: attention_kernel<kDeferred> with n_valid = Np and npad = Np - N.
//
// What bounds it on the H100: at the v3 serving shape (q [6, 345, 1280],
// k/v [6, 345, 256], 20/4 heads, D = 64) the two products are 3.66 GFLOP
// (3.7 us at the 989 TFLOP/s bf16 peak) against 12.7 MB of compulsory
// traffic (q, k, v in, the output out: 3.8 us at 3.35 TB/s).  Bytes bound
// it, by a hair.
//
// Design.  Two launches in one C call: split_prep writes the shared-memory
// images (q scaled in bf16, K, V^T) from the [B, N, H * 64] views, whose
// row stride it takes, so a v that is a column slice of the fused qkv
// projection needs no copy; then the attention body, which makes two passes
// over the keys (the exact row max, then e, sum(e) and bf16(e) @ v).
// (B15 and B16, the natural-softmax kernels on the same inputs, are
// attention_natural.cu.)

#include "flash_attn.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

// Scratch images of q (times qscale, rounded to bf16), K and V^T from
// [B, N, H * 64] views with row strides q_row, k_row and v_row (elements).
__global__ void __launch_bounds__(256) split_prep(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, long long q_row, long long k_row, long long v_row,
    __nv_bfloat16* __restrict__ qp, __nv_bfloat16* __restrict__ kp,
    __nv_bfloat16* __restrict__ vtp, int N, int nk, int hq, int hkv, float qscale) {
  __shared__ float tile[32][D + 1];
  const int hh = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * 32;
  const bool is_q = hh < hq, is_v = hh >= hq + hkv;
  const __nv_bfloat16* src = is_q ? q + hh * D : is_v ? v + (hh - hq - hkv) * D : k + (hh - hq) * D;
  const long long row = is_q ? q_row : is_v ? v_row : k_row;
  for (int e = threadIdx.x; e < 32 * D; e += blockDim.x) {
    const int i = e / D, d = e % D, j = r0 + i;
    float val = 0.f;
    if (j < N) {
      val = __bfloat162float(src[((long long)b * N + j) * row + d]);
      if (is_q) val = __fmul_rn(val, qscale);  // exact: the store rounds it once
    }
    if (is_q)
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

}  // namespace

extern "C" int attention_split_smem_bytes(int N) { return smem_bytes(N); }

extern "C" long long attention_split_scratch_bytes(int B, int N, int hq, int hkv) {
  return image_bytes(B, N, hq, hkv);
}

// q [B, N, hq * 64], k and v [B, N, hkv * 64] bf16 views with row strides
// q_row, k_row, v_row -> out [B, N, hq * 64] bf16 (contiguous), with
// qscale = bf16(scale * log2 e).  scratch holds
// attention_split_scratch_bytes(B, N, hq, hkv) bytes.
extern "C" int attention_split(const void* q, const void* k, const void* v, long long q_row,
                               long long k_row, long long v_row, void* scratch, void* out, int B,
                               int N, int hq, int hkv, float qscale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = key_rows(N);
  const Images im = images(scratch, B, N, hq, hkv);
  split_prep<<<dim3(nk / 32, hq + 2 * hkv, B), 256, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, q_row, k_row,
      v_row, im.q, im.k, im.vt, N, nk, hq, hkv, qscale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int np = (N + 7) / 8 * 8;
  return run_attention<kDeferred>(im, (__nv_bfloat16*)out, B, N, np, np - N, hq, hkv, st);
}
