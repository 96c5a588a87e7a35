// The base-2 flash GQA attention with deferred normalisation, for Hopper:
// one launch of attention_rows.cuh's body with its deferred epilogue, no
// prep launch and no scratch.
//
// Replaces two TPU kernels of the JAX package's ops/attention.py:
//   B2   gqa_attention_flash_qkv  (:415, _attn_kernel_flash_qkv :237,
//                                  pallas_call :449; default branch)
//   B11  gqa_attention_flash      (:186, _attn_kernel_flash :134,
//                                  pallas_call :213)
// Their rounding points:
//   B2   k, q = RoPE in bf16 from the unsplit fused-QKV projection:
//               bf16(bf16(x cos) + bf16(rot(x) sin)), one rounding per
//               operation, cos and sin the fp32 tables cast to bf16 first
//        s    = -inf where key col >= n_valid
//   B11  q, k, v already RoPE'd; N padded to Np = round_up(N, 8) with zero
//        rows and NOT masked: the Np - N zero keys score exactly 0 and take
//        part in the row max
//   both q'   = bf16(q * bf16(scale * log2 e)); s = q' @ k^T, fp32
//        e    = exp2f(s - m), m the exact row max
//        l    = sum(e) (B11: minus npad * exp2f(-m), the zero keys' share)
//        o    = bf16((bf16(e) @ v) * rcp_rn(l))
//
// What bounds it on the H100: at the serving shapes (B2: qkv [6, 352,
// 1792], keys masked past 345; B11: q [6, 345, 1280], k/v [6, 345, 256])
// the two products are 3.66 GFLOP (3.7 us at the 989 TFLOP/s bf16 peak)
// against 13.2 and 12.7 MB of compulsory traffic (3.93 and 3.80 us at
// 3.35 TB/s).  Bytes bound both, by a hair.
//
// Design (the body and its layout: attention_rows.cuh, attention_natural.cu):
//  1. One launch.  q, K and V come by 16-byte cp.async straight from the
//     [B, N, H * D] views at their row strides: for B2 three column views
//     of the unsplit qkv (row stride (hq + 2 hkv) * 64), for B11 its q, k
//     and v (k and v may be column slices of the fused projection).  Rows
//     at or past N are zero-filled by cp.async's source size.
//  2. B2's RoPE inside the kernel, in shared memory, outside the register-
//     heavy score loop: once K has landed the CTA rotates its K rows in
//     place (a thread two (d, d + 32) element pairs at a time, the fp32
//     tables read from L2), and each round the pair's own warps rotate its
//     q rows (four pairs at a time) behind the pair's barrier and scale them
//     in the same pass, after the rotation's rounding (one rounding, as
//     B11's and B10's packed multiply at the fragment load rounds it; there
//     it left B2's kernel spilling); a barrier follows before any scores.
//     This costs B2 about 9 us of its time at the serving shape (PERF.md):
//     each CTA reads the whole 180 KB table for K, and each round waits on
//     its q rows' table reads.  Staging the tables in shared memory or
//     prefetching them into L1 made the kernel spill and run slower.
//  3. The scores once, in registers: a warp holds 16 rows x 128 keys; the
//     exact row max and the row sum are combined across the W = nk / 128
//     warps of a row group in warp order; exp2f once a score; bf16(e) @ V
//     over the warp's chunk (ldmatrix.trans); the W partial outputs added in
//     warp order, times rcp_rn(l), rounded once.  l is summed again from
//     shared memory after the product, so that it is not live across it.
//  4. B11's zero keys: the mask limit is Np, the rows between N and Np are
//     zero-filled (not masked), and npad * exp2f(-m) comes off l once,
//     after the warp-order sum (B2's kernel has no such keys: no code).
//  5. The grid: B16's per-kv-head layout, the G q-heads side by side over K
//     and V loaded (and for B2 rotated) once: 15 warps at G = 5, N <= 384.
//     Two plans (ops/attention.py:_deferred_plan), one kernel for both (the
//     plan's span): the per-kv-head grid (120 CTAs of 5 rounds at the
//     serving shape) and the balanced one (132 CTAs of 4 rounds, K and V
//     reloaded where a span crosses a (batch, kv-head)).  Each kernel takes
//     the one that was faster at its serving shape (PERF.md; timed by
//     tools/torch_deferred_grids.py): B2 the per-kv-head grid (a reload
//     would rotate K again), B11 the balanced.
//  6. int8_qk (B2's int8 value product, attention_rows.cuh's int8 v
//     epilogue): a launch of v_codes_kernel first, then B2's launch with
//     V's codes and scales in place of V.  The codes are quantised per
//     (batch, kv-head, column) over all N rows, the rows past n_valid too
//     (align_n's padded patches: real values, masked only as keys), as the
//     JAX kernel's v block holds them; a zero-padded head column gets sv =
//     1e-12 and code 0.  They are written K-major, [B, hkv, D, nk] s8 (each
//     32-key block in kperm order, zero past N), which the s8 mma reads as
//     its B operand by ldmatrix.  The scores, e and l are B2's; w_q =
//     rn(e * 127) goes straight from the score registers into the A
//     fragments.
//  Every N <= 1024 runs (W <= 8 key chunks; past 768, K and V no longer
//  fit together at D = 64 and V takes K's buffer), at head dims 16, 32, 64
//  and 128 (8-warp CTAs at 128; past 640 keys there, K and the partial
//  outputs outgrow shared memory and the plan takes attention_stream.cuh's mode: K and V
//  in 128-key chunks, three passes over K, RoPE on each chunk as it lands).
//
// Registers (-Xptxas -v, sm_90a): 128 a thread (the 16-warp CTA caps them),
// no spills; chip_smoke.py's [build] line prints them on every run.  Which
// of the choices above spill is a matter of ptxas's allocation at the cap:
// every other combination of them tried on CUDA 12.8 spilled.

#include "attention_stream.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

template <int D, bool ROPE>
__global__ void __launch_bounds__(max_warps(D) * 32, 1) deferred_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const RopeTables rt) {
  rows_attention<D, Epilogue::kDeferred, false, ROPE, Grid::kPlan>(q, k, v, out, p, TrainRows{},
                                                                  rt);
}

// The streaming mode (attention_stream.cuh), which the plans take only at
// D = 128 (past 640 keys K and the partial outputs outgrow shared memory; the flash kernels
// stop at 1024 keys).
template <int D, bool ROPE>
__global__ void __launch_bounds__(STREAM_WARPS * 32, 1) deferred_stream_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const RopeTables rt) {
  stream_attention<D, Epilogue::kDeferred, ROPE>(q, k, v, out, p, rt);
}

// int8_qk: B2 on V's codes (v_codes_kernel) with the int8 v epilogue.
template <int D>
__global__ void __launch_bounds__(max_warps(D) * 32, 1) deferred_s8v_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const int8_t* __restrict__ codes, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const RopeTables rt, const float* __restrict__ sv) {
  rows_attention<D, Epilogue::kInt8V, false, true, Grid::kPlan>(
      q, k, reinterpret_cast<const __nv_bfloat16*>(codes), out, p, TrainRows{}, rt, sv);
}

__global__ void __launch_bounds__(STREAM_WARPS * 32, 1) deferred_s8v_stream_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const int8_t* __restrict__ codes, __nv_bfloat16* __restrict__ out, const NaturalPlan p,
    const RopeTables rt, const float* __restrict__ sv) {
  stream_attention<128, Epilogue::kInt8V, true>(
      q, k, reinterpret_cast<const __nv_bfloat16*>(codes), out, p, rt, sv);
}

// V's codes for the int8 value product.  CTA (column group of 16, kv-head,
// batch) of 256 threads: the absmax of each of its 16 columns over the N
// rows of v (row stride v_row), sv = max(absmax * f32(1/127), 1e-12), then
// codes[b, kvh, d, key'] = rn(v[key, d] / sv) (a true divide), key' the
// position of key in its 32-key block's kperm order, zero past N; nk a
// multiple of 128.
__device__ __forceinline__ float value_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float value_f32(float x) { return x; }

// V in bf16, or in fp32 (the fp32 mode of int8_qk, attention_f32.cu).
template <class T>
__global__ void __launch_bounds__(256) v_codes_kernel(const T* __restrict__ v, long long v_row,
                                                      int N, int hkv, int D, int nk,
                                                      int8_t* __restrict__ codes,
                                                      float* __restrict__ sv) {
  __shared__ float red[16][17];
  __shared__ float scale[16];
  const int groups = D / 16, kvh = blockIdx.x / groups, c0 = (blockIdx.x % groups) * 16;
  const int b = blockIdx.y, col = threadIdx.x & 15, stripe = threadIdx.x >> 4;
  const T* src = v + (long long)b * N * v_row + (long long)kvh * D + c0;
  float m = 0.f;
  for (int r = stripe; r < N; r += 16) m = fmaxf(m, fabsf(value_f32(src[r * v_row + col])));
  red[stripe][col] = m;
  __syncthreads();
  if (threadIdx.x < 16) {
    float a = red[0][threadIdx.x];
    for (int i = 1; i < 16; ++i) a = fmaxf(a, red[i][threadIdx.x]);
    const float s = fmaxf(__fmul_rn(a, kInv127), 1e-12f);
    scale[threadIdx.x] = s;
    sv[((long long)b * hkv + kvh) * D + c0 + threadIdx.x] = s;
  }
  __syncthreads();
  int8_t* dst = codes + (((long long)b * hkv + kvh) * D + c0) * nk;
  for (int i = threadIdx.x; i < 16 * (nk / 4); i += blockDim.x) {
    const int d = i / (nk / 4), pos = (i - d * (nk / 4)) * 4;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = ((pos + j) & ~31) + kperm((pos + j) & 31);
      if (key < N) {
        const float x = value_f32(src[key * v_row + d]);
        word |= ((uint32_t)__float2int_rn(__fdiv_rn(x, scale[d])) & 0xffu) << (8 * j);
      }
    }
    *reinterpret_cast<uint32_t*>(dst + (long long)d * nk + pos) = word;
  }
}

template <class Kernel>
cudaError_t launch(Kernel kernel, int& smem_set, const void* q, const void* k, const void* v,
                   void* out, const NaturalPlan& p, const RopeTables& rt, dim3 grid, int warps,
                   int smem, cudaStream_t st) {
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<grid, warps * 32, smem, st>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                         (const __nv_bfloat16*)v, (__nv_bfloat16*)out, p, rt);
  return cudaGetLastError();
}

template <int D, bool ROPE>
cudaError_t launch_rope(const void* q, const void* k, const void* v, void* out,
                        const NaturalPlan& p, const RopeTables& rt, dim3 grid, int warps, int smem,
                        cudaStream_t st) {
  static int smem_set[2] = {0, 0};
  if (D == 128 && p.stream)
    return launch(deferred_stream_kernel<128, ROPE>, smem_set[1], q, k, v, out, p, rt, grid,
                  warps, smem, st);
  if (p.stream) return cudaErrorInvalidValue;  // no streaming instance below D = 128
  return launch(deferred_kernel<D, ROPE>, smem_set[0], q, k, v, out, p, rt, grid, warps, smem,
                st);
}

template <int D>
cudaError_t launch_s8v(const void* q, const void* k, const void* codes, void* out,
                       const NaturalPlan& p, const RopeTables& rt, const float* sv, dim3 grid,
                       int warps, int smem, cudaStream_t st) {
  static int smem_set[2] = {0, 0};
  auto go = [&](auto kernel, int& set) {
    if (smem > set) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      set = smem;
    }
    kernel<<<grid, warps * 32, smem, st>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                           (const int8_t*)codes, (__nv_bfloat16*)out, p, rt, sv);
    return cudaGetLastError();
  };
  if (D == 128 && p.stream) return go(deferred_s8v_stream_kernel, smem_set[1]);
  if (p.stream) return cudaErrorInvalidValue;  // no streaming instance below D = 128
  return go(deferred_s8v_kernel<D>, smem_set[0]);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, const NaturalPlan& p,
                     const RopeTables& rt, dim3 grid, int warps, int smem, cudaStream_t st) {
  return rt.cos ? launch_rope<D, true>(q, k, v, out, p, rt, grid, warps, smem, st)
                : launch_rope<D, false>(q, k, v, out, p, rt, grid, warps, smem, st);
}

}  // namespace

// q [B, N, hq * D], k and v [B, N, hkv * D] bf16 views (16-byte aligned,
// row strides in the plan), D 16, 32, 64 or 128 -> out [B, N, hq * D] bf16,
// contiguous.  With cos_t and sin_t ([N, D] f32, 8-byte aligned) q and K
// are RoPE'd first (B2); with null tables they are taken as they are
// (B11).  The plan's span picks the grid: 0 the per-kv-head grid, else the
// balanced one.  One launch of grid (gx, gy, B) with `warps` warps and
// `smem` bytes of dynamic shared memory.
extern "C" int attention_deferred(const void* q, const void* k, const void* v, void* out,
                                  const NaturalPlan* plan, const float* cos_t, const float* sin_t,
                                  int D, int B, int gx, int gy, int warps, int smem, void* stream) {
  const RopeTables rt{cos_t, sin_t};
  const dim3 grid(gx, gy, B);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<16>(q, k, v, out, *plan, rt, grid, warps, smem, st);
    case 32: return launch_d<32>(q, k, v, out, *plan, rt, grid, warps, smem, st);
    case 64: return launch_d<64>(q, k, v, out, *plan, rt, grid, warps, smem, st);
    case 128: return launch_d<128>(q, k, v, out, *plan, rt, grid, warps, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// int8_qk, first launch: v [B, N, hkv * D] bf16 (f32: fp32) view (row
// stride v_row, D a multiple of 16) -> codes [B, hkv, D, nk] s8 and sv [B,
// hkv, D] f32 (see v_codes_kernel).  Used by B2 at every head dim
// (attention_wide.cu's too) and, on fp32 v, by its fp32 mode
// (attention_f32.cu).
extern "C" int attention_v_codes(const void* v, long long v_row, int B, int N, int hkv, int D,
                                 int nk, void* codes, void* sv, int f32, void* stream) {
  if (D % 16 || nk % 128) return cudaErrorInvalidValue;
  const dim3 grid(hkv * D / 16, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    v_codes_kernel<float><<<grid, 256, 0, st>>>((const float*)v, v_row, N, hkv, D, nk,
                                                (int8_t*)codes, (float*)sv);
  else
    v_codes_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>((const __nv_bfloat16*)v, v_row, N, hkv,
                                                        D, nk, (int8_t*)codes, (float*)sv);
  return cudaGetLastError();
}

// int8_qk, second launch: B2 as attention_deferred with the RoPE tables,
// on V's codes and scales (attention_v_codes) in place of v.
extern "C" int attention_deferred_s8v(const void* q, const void* k, const void* codes, void* out,
                                      const NaturalPlan* plan, const float* cos_t,
                                      const float* sin_t, const float* sv, int D, int B, int gx,
                                      int gy, int warps, int smem, void* stream) {
  const RopeTables rt{cos_t, sin_t};
  const dim3 grid(gx, gy, B);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_s8v<16>(q, k, codes, out, *plan, rt, sv, grid, warps, smem, st);
    case 32: return launch_s8v<32>(q, k, codes, out, *plan, rt, sv, grid, warps, smem, st);
    case 64: return launch_s8v<64>(q, k, codes, out, *plan, rt, sv, grid, warps, smem, st);
    case 128: return launch_s8v<128>(q, k, codes, out, *plan, rt, sv, grid, warps, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
