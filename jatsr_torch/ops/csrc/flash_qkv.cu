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
//   w     = bf16(e / l), a correctly rounded divide, rounded BEFORE the product
//   o_h   = bf16(w @ v) per head, no rescale
//   so    = max(max|o_row| * INV127, 1e-12) over the whole Hq*D row
//   o_q   = rint(o / so)                          a true divide
//   out   = bf16(((float)(o_q @ wo) * so) * wos + bo), each op rounded
//
// What bounds it on the H100: at the serving shape (qkv [6, 352, 1792],
// keys masked past 345, wo [1280, 1280]) it is 3.80 GFLOP bf16 (3.84 us at
// 989 TFLOP/s) plus 6.92 G int8 operations (3.50 us at 1979 TOP/s) against
// 14.6 MB (4.4 us at 3.35 TB/s): operations bound it.
//
// Design.  Three launches in one C call:
//   1. The attention: attention_rows.cuh's body with its normed epilogue,
//      on B2's grid (a CTA per (kv-head, batch, group of 16-row tiles), the
//      G q-heads side by side over K and V loaded and rotated once, the
//      launch plan ops/attention.py:_deferred_plan).  q, K and V come by
//      cp.async straight from three column views of the qkv projection;
//      q and K are rotated in shared memory (B2's RoPE pass, the q scale
//      folded in); the scores once, in registers, with the exact row max;
//      w = bf16(e / l) by fdiv_rn.cuh's correctly rounded divide (B15's);
//      it writes the bf16 o.  Every N <= 1024 and head dims 16, 32, 64 and
//      128 run: past 768 keys at D = 64, V takes K's buffer once the scores
//      are done; at D = 128 (8-warp CTAs) past 640 keys the plan takes
//      attention_stream.cuh's mode (K and V in 128-key chunks).
//   2. s8_rows.cuh's row quant (quant_rows_v, the divide form: one warp a
//      row, the row in registers), which lets the next launch start at its
//      first instruction; 3. s8_dequant.cuh's s8 wgmma GEMM with the bias
//      (B3's epilogue) on o_q and the out projection's weight K-major, wo_t
//      [H, Hq*D], which the DiT makes once; it starts under programmatic
//      stream serialisation and waits only before reading o_q and so.  The
//      TPU kernel keeps o in VMEM and quantises it there; a CTA here owns
//      one kv-head's rows, not the whole Hq*D row the quantisation needs, so
//      o makes one round trip (5.4 MB at the serving shape, L2-resident).
//      Keeping o on chip would take a cluster of the hkv CTAs of a row tile
//      swapping row maxima and int32 partial products through distributed
//      shared memory: untried (ROADMAP has the sums).

#include "attention_stream.cuh"
#include "s8_dequant.cuh"
#include "s8_split.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(max_warps(D) * 32, 1) normed_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const RopeTables rt) {
  rows_attention<D, Epilogue::kNormed, false, true, Grid::kOwn>(q, k, v, out, p, TrainRows{}, rt);
}

// The streaming mode (attention_stream.cuh), which the plan takes only at
// D = 128, past 640 keys.
__global__ void __launch_bounds__(STREAM_WARPS * 32, 1) normed_stream_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const RopeTables rt) {
  stream_attention<128, Epilogue::kNormed, true>(q, k, v, out, p, rt);
}

template <class Kernel>
cudaError_t launch(Kernel kernel, int& smem_set, const void* q, const void* k, const void* v,
                   void* o, const NaturalPlan& p, const RopeTables& rt, dim3 grid, int warps,
                   int smem, cudaStream_t st) {
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<grid, warps * 32, smem, st>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                         (const __nv_bfloat16*)v, (__nv_bfloat16*)o, p, rt);
  return cudaGetLastError();
}

template <int D>
cudaError_t attention(const void* q, const void* k, const void* v, void* o, const NaturalPlan& p,
                      const RopeTables& rt, dim3 grid, int warps, int smem, cudaStream_t st) {
  static int smem_set[2] = {0, 0};
  if (D == 128 && p.stream)
    return launch(normed_stream_kernel, smem_set[1], q, k, v, o, p, rt, grid, warps, smem, st);
  if (p.stream) return cudaErrorInvalidValue;  // no streaming instance below D = 128
  return launch(normed_kernel<D>, smem_set[0], q, k, v, o, p, rt, grid, warps, smem, st);
}

// The attention launch at head dim D (16, 32, 64 or 128).
cudaError_t attention_d(const void* q, const void* k, const void* v, void* o,
                        const NaturalPlan& p, const RopeTables& rt, dim3 grid, int D, int warps,
                        int smem, cudaStream_t st) {
  switch (D) {
    case 16: return attention<16>(q, k, v, o, p, rt, grid, warps, smem, st);
    case 32: return attention<32>(q, k, v, o, p, rt, grid, warps, smem, st);
    case 64: return attention<64>(q, k, v, o, p, rt, grid, warps, smem, st);
    case 128: return attention<128>(q, k, v, o, p, rt, grid, warps, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k and v: the three column views of qkv [B, N, (hq + 2 hkv) * D] bf16
// (16-byte aligned, row stride in the plan), D 16, 32, 64 or 128; cos/sin [N, D]
// f32; wo_t [H, hq * D] s8 (the out projection's weight K-major), wos and bo
// [H] f32 -> out [B, N, H] bf16.  o [B * N, hq * D] bf16, oq [B * N, hq *
// D] s8 and so [B * N] f32 are scratch.  The attention is one launch of
// grid (gx, gy, B) with `warps` warps and `smem` bytes of dynamic shared
// memory.  Needs H % 128 == 0.
extern "C" int flash_out(const void* q, const void* k, const void* v, const NaturalPlan* plan,
                         const float* cos_t, const float* sin_t, const void* wo_t, const void* wos,
                         const void* bo, void* o, void* oq, void* so, void* out, int D, int B,
                         int gx, int gy, int warps, int smem, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = attention_d(q, k, v, o, *plan, RopeTables{cos_t, sin_t}, dim3(gx, gy, B),
                                    D, warps, smem, st);
  if (e != cudaSuccess) return e;
  const int M = B * plan->N, K = plan->hq * D;
  return s8_quant_dequant<true>(o, oq, so, wo_t, wos, bo, out, M, K, H, st);
}

// ---- B12 row-parallel (tensor parallelism, s8_split.cuh) -------------------
// A rank's heads: q, k and v the column views of its qkv columns (its q
// heads, then its kv heads' k and v), the plan of its heads; wo_t [H, hq *
// D] s8 its rows of the out projection K-major (each head padded as
// flash_out's).  Part 1: the attention launch as flash_out's -> o [B * N,
// hq * D] bf16, then amax [B * N] f32, max|o_row| over the rank's heads
// (two launches).  The caller takes the max over the ranks; part 2: the
// codes at the whole row's floored scale and the s8 wgmma GEMM writing int32
// -> oq, so [B * N] f32, acc [B * N, H] s32 (two launches).  The caller adds
// acc over the ranks; part 3: out [B * N, H] bf16 = ((float)acc * so) * wos
// + bo, each op rounded: flash_out's epilogue, the bias added once.
extern "C" int flash_out_split1(const void* q, const void* k, const void* v,
                                const NaturalPlan* plan, const float* cos_t, const float* sin_t,
                                void* o, void* amax, int D, int B, int gx, int gy, int warps,
                                int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = attention_d(q, k, v, o, *plan, RopeTables{cos_t, sin_t},
                                    dim3(gx, gy, B), D, warps, smem, st);
  return e != cudaSuccess ? e
                          : launch_row_absmax(o, amax, B * plan->N, plan->hq * D, st);
}

extern "C" int flash_out_split2(const void* o, const void* amax, const void* wo_t, void* oq,
                                void* so, void* acc, int M, int K, int H, void* stream) {
  return launch_quant_acc(o, amax, wo_t, oq, so, acc, M, K, H, (cudaStream_t)stream);
}

extern "C" int flash_out_split3(const void* acc, const void* so, const void* wos, const void* bo,
                                void* out, int M, int H, void* stream) {
  return launch_dequant_acc(acc, so, wos, out, M, H, 0, (cudaStream_t)stream, bo);
}

// The GEMM stage alone, on a quant launch's oq [M, K] s8 and so [M] f32:
// wo_t [H, K] s8, wos and bo [H] f32 -> out [M, H] bf16, launched without
// programmatic stream serialisation.  Needs H % 128 == 0, K % 16 == 0.
extern "C" int flash_out_gemm(const void* oq, const void* so, const void* wo_t, const void* wos,
                              const void* bo, void* out, int M, int K, int H, void* stream) {
  return s8_dequant<true, __nv_bfloat16>(oq, so, wo_t, wos, bo, out, M, K, H, false,
                                         (cudaStream_t)stream);
}
