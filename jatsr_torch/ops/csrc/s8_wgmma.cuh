// The s8 GEMM core for Hopper: wgmma.mma_async s8 x s8 -> s32 with the
// int32 accumulators in registers, fed by TMA through a ring of
// shared-memory stages.  A sibling of bf16_wgmma.cuh, whose mbarrier, TMA
// and descriptor primitives it shares; its tile serves B1 and B3
// (norm_mod.cu), B4 (w8a8_fused.cu) and B5 (dense_gelu_quant.cu), and B13
// (mlp_full.cu) builds its own loops on these primitives.  Each csrc/*.cu
// that includes this file is built into its own shared library, so
// everything here lives in an anonymous namespace.
//
// The tile: 128 x 128 outputs a CTA of two warpgroups, two CTAs an SM, so
// that one CTA's epilogue runs beside the other's products (128 registers
// a thread: a third, producer warp would cut that to 96 and spill).  Each
// warpgroup owns 64 rows: per stage four wgmma.mma_async m64n128k32 (64
// s32 accumulators a thread), then each of its 4 warps arrives on the
// stage's "empty" mbarrier.  Thread 0 also produces: it issues a stage's two
// TMA copies, which complete on the stage's "full" mbarrier with their byte
// count, once all 8 warps have released the stage.  wgmma takes 8-bit operands K-major only (the PTX ISA allows
// the transposed operand for .f16 and .bf16 alone), so both operands are
// K-major: A an [M, K] int8 matrix, B the weight as [N, K] (the serving
// DiT keeps that copy beside the [K, N] one, made once).  A stage is 128
// deep in K: one 128-byte row of int8, the TMA box's inner extent under the
// 128-byte swizzle, four k-steps of 32.  A is one [128 rows][128 k] box
// (16 KB), B one [128 rows][128 k] box (16 KB); three stages of 32 KB (97
// KB a CTA with the barriers and the alignment: two fit an SM).  The boxes
// zero-fill rows past M and N, so a caller needs no padding; K must be a
// multiple of 128 (H = 1280 is ten).
//
// Descriptors (sm_90a, 128-byte swizzle, every box 1024-byte aligned): both
// operands K-major, as bf16_wgmma.cuh's A: stride between 8-row groups
// (SBO) 1024 bytes; a k-step of 32 advances the start address by 32 bytes
// inside the swizzled row.

#pragma once

#include "bf16_wgmma.cuh"

namespace {

constexpr int S8_BM = 128;                           // output rows a CTA
constexpr int S8_BN = 128;                           // output columns a CTA
constexpr int S8_BK = 128;                           // depth of a stage (bytes)
constexpr int S8_STAGES = 3;                         // the ring
constexpr int S8_THREADS = 256;                      // two warpgroups
constexpr int S8_ACC = S8_BN / 2;                    // s32 accumulators a consumer thread
constexpr int S8_A_BYTES = S8_BM * S8_BK;            // 16 KB
constexpr int S8_STAGE_BYTES = S8_A_BYTES + S8_BN * S8_BK;  // + 16 KB
// Dynamic shared memory: the stages, the full and empty barriers, and up to
// 1023 bytes to align the stages to 1024.
constexpr int S8_SMEM = S8_STAGES * S8_STAGE_BYTES + 2 * S8_STAGES * 8 + 1024;

// d += A B for one k-step of 32: A 64 x 32 and B 32 x 128, both K-major,
// s8 x s8 -> s32 (exact).
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Programmatic dependent launch: a kernel launched with programmatic stream
// serialisation (s8_launch below) may start while the launch before it
// drains.  griddep_launch lets the next launch start; griddep_wait waits
// until the launch before has finished and its writes are visible.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void s8_fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One 128 x 128 output tile over `nk` k-blocks of 128 on a CTA of
// S8_THREADS.  load(kb, a, b, bar) issues the TMA copies of k-block kb (A
// into a, B into b: [128][128] boxes), completing on bar with
// S8_STAGE_BYTES bytes; it runs on thread 0.  pre(row, col) runs on every
// thread before its products (loads whose latency the products hide);
// epi(acc, row, col, stage) after them: acc[4 i + e] is output (row + 8 (e
// >> 1), 8 i + col + (e & 1)) of the tile, i < 16, row < 128, col even, and
// `stage` the ring's S8_STAGES * S8_STAGE_BYTES bytes, free by then (every
// product is done) for the epilogue to stage its outputs.  One group of
// products stays in flight: once k-block kb's are issued, kb - 1's are
// waited for and its stage released; thread 0 then refills that stage with
// k-block kb - 1 + S8_STAGES when all 8 warps have released it.  Dynamic
// shared memory: S8_SMEM bytes.
template <class Load, class Pre, class Epi>
__device__ __forceinline__ void s8_gemm_tile(int nk, const Load& load, const Pre& pre,
                                             const Epi& epi) {
  extern __shared__ __align__(1024) unsigned char s8_raw[];
  const uint32_t raw = wg_smem_u32(s8_raw);
  unsigned char* ring = s8_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S8_STAGES * S8_STAGE_BYTES);
  uint64_t* empty = full + S8_STAGES;
  auto issue = [&](int kb) {  // thread 0: k-block kb into its stage
    const int s = kb % S8_STAGES;
    unsigned char* a = ring + s * S8_STAGE_BYTES;
    mbar_expect_tx(&full[s], S8_STAGE_BYTES);
    load(kb, a, a + S8_A_BYTES, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S8_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < S8_STAGES && kb < nk; ++kb) issue(kb);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row = wg * 64 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  pre(row, col);
  int acc[S8_ACC];
#pragma unroll
  for (int i = 0; i < S8_ACC; ++i) acc[i] = 0;
  s8_fence_acc(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S8_STAGES;
    mbar_wait(&full[s], (kb / S8_STAGES) & 1);
    const uint32_t a = wg_smem_u32(ring + s * S8_STAGE_BYTES) + wg * 64 * S8_BK;
    const uint32_t b = wg_smem_u32(ring + s * S8_STAGE_BYTES + S8_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk)
      wgmma_s8_m64n128k32(acc, wg_desc(a + kk * 32, 16, 1024), wg_desc(b + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // k-block kb - 1's products are done: its stage is free
    s8_fence_acc(acc);
    if (kb > 0) {
      const int p = (kb - 1) % S8_STAGES;
      if (lane == 0) mbar_arrive(&empty[p]);
      if (threadIdx.x == 0 && kb - 1 + S8_STAGES < nk) {
        mbar_wait(&empty[p], ((kb - 1) / S8_STAGES) & 1);
        issue(kb - 1 + S8_STAGES);
      }
      __syncwarp();  // warp 0 reconverges before its next .aligned wgmma
    }
  }
  wgmma_wait_all();
  s8_fence_acc(acc);
  __syncthreads();  // both warpgroups are done with the ring
  epi(acc, row, col, ring);
}

// ---- host side: tensor maps ----------------------------------------------

// A 2-D int8 tensor map of `rows` rows of `cols` bytes, row stride `ld`
// bytes (a multiple of 16; a column view of a wider matrix where ld >
// cols), boxes of [box_rows][128] under the 128-byte swizzle, zero fill
// outside.
cudaError_t s8_tensor_map_ld(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                             int box_rows) {
  const EncodeTiled encode = wg_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {S8_BK, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same, row stride `cols`.
cudaError_t s8_tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  return s8_tensor_map_ld(map, base, rows, cols, cols, box_rows);
}

// Launches `kernel` on `st` with `smem` bytes of dynamic shared memory (the
// attribute set at a kernel's first launch), and with programmatic stream
// serialisation where `pdl` is set.
template <auto kernel, class... A>
cudaError_t s8_launch(dim3 grid, int threads, int smem, bool pdl, cudaStream_t st, A... args) {
  static int set = -1;
  if (set != smem) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
