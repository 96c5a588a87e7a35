// The bf16 GEMM core for Hopper: wgmma.mma_async with fp32 accumulators in
// registers, fed by TMA through a ring of shared-memory stages.  Its
// consumers are snake_tr_stream.cu (B8, wg_gemm_tile at BN = 192),
// dac_res.cu (B6 and B9) and snake_tr.cu (B7), the last two with their own
// loops on these primitives at BN = 96 or 192.  Each csrc/*.cu that
// includes this file is built into its own shared library, so everything
// here lives in an anonymous namespace.
//
// The tile: 128 x BN outputs a CTA of three warpgroups (BN 192 below; the
// tile width is a template parameter, 96 or 192: wgmma takes n in multiples
// of 8 up to 256).  Warpgroup 0 is the
// producer: one thread waits for a free stage and issues the stage's TMA
// copies, which complete on the stage's "full" mbarrier with their byte
// count.  Warpgroups 1 and 2 are the consumers, each owning 64 rows: per
// stage four wgmma.mma_async m64nBNk16 (BN / 2 fp32 accumulators a thread),
// then each of their 8 warps arrives on the stage's "empty" mbarrier.
// Stages are 64 deep in K (one 128-byte row of bf16, the TMA box's inner
// extent under the 128-byte swizzle): A a [128 rows][64 k] box, K-major;
// B BN / 64 (rounded up) [64 k][64 n] boxes, N-major, read by wgmma as the transposed
// operand (the weight stays in its [K, N] layout, N contiguous).  Five
// stages of 40 KB.  The TMA boxes zero-fill what lies outside the tensor
// (rows before 0 or past the end, columns past N), so a caller needs no
// padding.
//
// Descriptors (sm_90a, 128-byte swizzle, every box 1024-byte aligned):
// A, K-major: stride between 8-row groups (SBO) 1024 bytes; a k-step of 16
// advances the start address by 32 bytes inside the swizzled row.  B,
// N-major: SBO 1024 bytes between 8-deep k groups, LBO 8192 bytes between
// the 64-column boxes; a k-step advances the start by 16 rows, 2048 bytes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WG_BM = 128;                          // output rows a CTA
constexpr int WG_BN = 192;                          // output columns a CTA
constexpr int WG_BK = 64;                           // depth of a stage
constexpr int WG_STAGES = 5;                        // the ring
constexpr int WG_THREADS = 384;                     // producer + two consumer warpgroups
constexpr int WG_CONSUMER_WARPS = 8;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;       // 16 KB
constexpr int WG_B_BOX = 64 * WG_BK * 2;            // one [64 k][64 n] box: 8 KB
// A stage of a BN-wide tile: A, then B's boxes.
__host__ __device__ constexpr int wg_stage_bytes(int bn) { return WG_A_BYTES + (bn + 63) / 64 * WG_B_BOX; }
constexpr int WG_STAGE_BYTES = wg_stage_bytes(WG_BN);
// Dynamic shared memory: the stages, the full and empty barriers, and up to
// 1023 bytes to align the stages to 1024.
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t wg_smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg_smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wg_smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(wg_smem_u32(bar)) : "memory");
}

// Until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = wg_smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A TMA copy of the box at the given coordinates (innermost first) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(wg_smem_u32(dst)),
      "l"((uint64_t)map), "r"(wg_smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(wg_smem_u32(dst)),
      "l"((uint64_t)map), "r"(wg_smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Until at most N committed groups of this warpgroup's products are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a read or write of an accumulator across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B for one k-step of 16: A 64 x 16 (K-major), B 16 x 192 (N-major,
// the transposed operand: imm-trans-b 1), bf16, fp32 accumulators.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

// The same at n = 96: 48 fp32 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B for one k-step of 16 at n = BN (96 or 192).
template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  static_assert(BN == 96 || BN == 192, "tile width 96 or 192");
  if constexpr (BN == 96)
    wgmma_m64n96k16(d, a, b);
  else
    wgmma_m64n192k16(d, a, b);
}

// One 128 x BN output tile over `nk` k-blocks of 64.  load(kb, a, b, bar)
// issues the TMA copies of k-block kb (A into a: a [128][64] box; B into b:
// BN / 64 [64][64] boxes 8 KB apart), completing on bar with
// wg_stage_bytes(BN) bytes; it runs on one thread.  epi(row, col, v0, v1) takes outputs (row,
// col) and (row, col + 1) of the tile, col even, each pair once.  The
// producer warpgroup returns from here early: the caller does nothing after
// the call that needs the whole CTA.  Dynamic shared memory: WG_SMEM bytes
// at BN = 192.
template <int BN = WG_BN, class Load, class Epi>
__device__ __forceinline__ void wg_gemm_tile(int nk, const Load& load, const Epi& epi) {
  constexpr int STAGE = wg_stage_bytes(BN);
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  const uint32_t raw = wg_smem_u32(wg_raw);
  unsigned char* ring = wg_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * STAGE);
  uint64_t* empty = full + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % WG_STAGES;
        if (kb >= WG_STAGES) mbar_wait(&empty[s], (kb / WG_STAGES - 1) & 1);
        unsigned char* a = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        load(kb, a, a + WG_A_BYTES, &full[s]);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  wg_fence_acc(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % WG_STAGES;
    mbar_wait(&full[s], (kb / WG_STAGES) & 1);
    const uint32_t a = wg_smem_u32(ring + s * STAGE) + (wg - 1) * 64 * 128;
    const uint32_t b = wg_smem_u32(ring + s * STAGE + WG_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_k16<BN>(acc, wg_desc(a + kk * 32, 16, 1024), wg_desc(b + kk * 2048, WG_B_BOX, 1024));
    wgmma_commit();
    wgmma_wait_all();
    wg_fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // acc[4 i + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column 8 i +
  // 2 (lane % 4) + (e & 1), of the warpgroup's 64 rows.
  const int row = (wg - 1) * 64 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    epi(row, 8 * i + col, acc[4 * i], acc[4 * i + 1]);
    epi(row + 8, 8 * i + col, acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---- host side: tensor maps ----------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); null where the driver lacks it.
EncodeTiled wg_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first: sizes in elements,
// strides of dims 1.. in bytes) with the 128-byte swizzle and zero fill
// outside the tensor.
cudaError_t wg_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = wg_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
