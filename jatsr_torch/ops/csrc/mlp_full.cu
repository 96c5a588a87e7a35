// The whole serving MLP, quant(a) -> dot1 -> dequant + bias + GELU ->
// per-(row, slab) requant -> dot2 -> dequant + bias, for Hopper.
//
// Replaces the TPU kernel int8_mlp (_mlp_full_kernel) in the JAX package's
// ops/int8_matmul.py: the block MLP under fused_mlp_impl="full".  Same math
// and rounding points (the 4H hidden width is cut into n_slabs slabs of
// equal, 128-aligned width, _pick_slabs):
//   s    = max(max|a_row| * INV127, 1e-12);  a_q = rint(a * (1 / s))
//          a RECIPROCAL multiply, not the divide of B1-B5
//   y    = bf16(((float)(a_q @ w1) * s) * w1s + b1)
//   g    = bf16(gelu(y))                      tanh / A&S erf / sigmoid
//   gs   = max(max|g_row,slab| * INV127, 1e-12) per (row, slab)
//   g_q  = rint(g * (1 / gs))
//   acc2 = acc2 + (float)(g_q,slab @ w2,slab) * gs   fp32, slab by slab, in
//          slab order
//   out  = bf16(acc2 * w2s + b2)
// Every fp32 operation is __fmul_rn / __fadd_rn / __fdiv_rn (no FMA).
//
// What bounds it on the H100: at the v3 block (M = 2112, H = 1280, 4H =
// 5120, 4 slabs of 1280) the two products are 55.4 G int8 operations (28.0
// us at 1979 TOP/s) against 18.9 MB of compulsory traffic (a, both weight
// matrices, the output: 5.6 us at 3.35 TB/s): the tensor cores bound it.
//
// Design.  The TPU kernel holds both weight matrices (13.1 MB) in VMEM and
// a row block's hidden activation in registers.  Here three launches in one
// C call, each started by programmatic stream serialisation while the one
// before drains, on s8_wgmma.cuh's primitives (s8 wgmma fed by TMA), both
// weights K-major ([N1, H] and [H, N1], made once by the caller: wgmma
// reads 8-bit operands K-major only):
//   1. s8_rows.cuh's row quant, reciprocal form (the row in registers):
//      a_q [M, H] s8 and s [M].  Its fp32 mode (the JAX model at
//      dtype="float32" hands the kernel fp32 a) reads fp32 rows: the only
//      change, as in the TPU kernel, whose output stays bf16.
//   2. mlp_hidden_kernel: a CTA owns one (64-row block, slab) and keeps its
//      bf16 g on chip (64 x 1280 x 2 = 160 KB), so a slab's row max is
//      taken there: two consumer warpgroups take the slab's 128-wide column
//      tiles in turns (one's GELU epilogue beside the other's products, an
//      ordered pair of named barriers between their main loops), a producer
//      warp streams [64 x 128] a_q and [128 x 128] w1 stages through a ring
//      of four; then every thread turns the slab's g into codes.  g lies in
//      shared memory but for each warpgroup's last tile, which stays in its
//      registers (32 a thread): that leaves room for four stages, not two,
//      and the stages' reads from L2 (324 MB at v3), not the tensor cores,
//      bound this launch.  Only g_q [M, N1] s8 and gs [M, n_slabs] go
//      through device memory.  33 row blocks x 4 slabs are 132 CTAs at M =
//      2112: one a streaming multiprocessor, one wave.
//   3. mlp_out_kernel: the second product, K = N1 in slab order through a
//      ring of four stages fed by thread 0; at each slab's end the s32
//      accumulators are folded into fp32 ones with their rows' gs and
//      zeroed.  64 s32 and 64 fp32 accumulators a thread need more than the
//      128 registers of two CTAs an SM, so one CTA an SM, of three
//      warpgroups: 192 x 128 tiles, 110 at M = 2112 (one wave; 128-row
//      tiles would be 170, 1.3 waves), each stage's 16 KB of w2 shared by
//      192 rows.
//
// The split entry (tensor parallelism: a rank holds a span of w1's columns
// and the same span of w2's rows, the slabs those of the whole N1) keeps
// these numbers bit for bit, in three parts with the ranks' collectives
// between them:
//   1. the same row quant, then s8_gelu.cuh's pass 1 on the rank's columns
//      (g by s8_gelu_of, the hidden kernel's), each row's max |g| a
//      128-column tile, then slab_rowmax: gmax [M, n_slabs] of the slabs
//      the rank touches (the caller zeroes the rest).  The ranks take the
//      max (exact).
//   2. mlp_codes_kernel: the product again, g by the same instructions,
//      gs = max(gmax * INV127, 1e-12) and rint(g * (1 / gs)) as the hidden
//      kernel writes them; then s8_split.cuh's s8_acc_kernel once for each
//      slab's part the rank holds, its int32 product into the slab's own
//      [M, N2] plane.  The ranks add the planes (exact).
//   3. mlp_fold: acc2 = acc2 + (float)acc_j * gs_j over every slab j in
//      order, then bf16(acc2 * w2s + b2), mlp_out_kernel's operations.

#include "s8_gelu.cuh"
#include "s8_rows.cuh"
#include "s8_split.cuh"

namespace {

// ---- 2. the first product, GELU and the per-(row, slab) codes ------------
constexpr int H_BM = 64;                                   // rows a CTA
constexpr int H_STAGES = 4;                                // the ring
constexpr int H_THREADS = 288;                             // 2 consumer warpgroups + producer
constexpr int H_MAX_SLAB = 1280;                           // g's room on chip
constexpr int H_REG_TILES = 2;  // the last column tile of each warpgroup stays in registers
constexpr int H_A_BYTES = H_BM * S8_BK;                    // 8 KB
constexpr int H_STAGE_BYTES = H_A_BYTES + S8_BN * S8_BK;   // + 16 KB
// The column tiles whose g goes to shared memory: all but the last two.
__host__ __device__ constexpr int h_smem_tiles(int slab) {
  return slab / S8_BN > H_REG_TILES ? slab / S8_BN - H_REG_TILES : 0;
}
// A row of g in shared memory: those tiles in bf16 and 16 bytes, so that
// the 8 rows of a warp's store hit distinct banks.
__host__ __device__ constexpr int h_gstride(int slab) {
  return 2 * S8_BN * h_smem_tiles(slab) + 16;
}
// The ring, g, the row maxima of each warpgroup and the reciprocal scales,
// the full and empty barriers, and up to 1023 bytes to align the ring:
// 232,256 bytes at a slab of 1280, 192 below the H100's limit.
__host__ __device__ constexpr int h_smem(int slab) {
  return H_STAGES * H_STAGE_BYTES + H_BM * h_gstride(slab) + 3 * H_BM * 4 + 2 * H_STAGES * 8 +
         1024;
}

// Named barriers 1 and 2: "warpgroup 0 (1) may start its next tile's main
// loop", arrived at by the other warpgroup's 128 threads when its own main
// loop is done.
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

template <int GELU>
__global__ void __launch_bounds__(H_THREADS, 1) mlp_hidden_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, const float* __restrict__ bias,
    int8_t* __restrict__ gq, float* __restrict__ gs, int M, int K, int N1, int slab) {
  extern __shared__ __align__(1024) unsigned char h_raw[];
  const uint32_t raw = wg_smem_u32(h_raw);
  unsigned char* ring = h_raw + (((raw + 1023) & ~1023u) - raw);
  const int gstr = h_gstride(slab);
  unsigned char* gbuf = ring + H_STAGES * H_STAGE_BYTES;
  float* rmax = reinterpret_cast<float*>(gbuf + H_BM * gstr);  // [2][64]
  float* rcps = rmax + 2 * H_BM;                                // [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(rcps + H_BM);
  uint64_t* empty = full + H_STAGES;
  const int j = blockIdx.x, m0 = blockIdx.y * H_BM, c0 = j * slab;
  const int nk = K / S8_BK, ntiles = slab / S8_BN, nsm = h_smem_tiles(slab);
  griddep_launch();  // the second product may set up as these CTAs finish
  if (threadIdx.x == 0) {
    for (int st = 0; st < H_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // the 4 warps of the warpgroup that read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  // The last tile of each warpgroup, g in bf16 pairs: greg[h][i] holds rows
  // row + 8 h, columns 8 i + col and + 1 of tile treg.
  uint32_t greg[2][S8_BN / 8];
  int treg = -1;
  if (threadIdx.x >= 256) {
    // The producer: stage i holds k-block i % nk of column tile i / nk.
    if (lane == 0) {
      for (int i = 0; i < nk * ntiles; ++i) {
        const int st = i % H_STAGES, t = i / nk, kb = i % nk;
        if (i >= H_STAGES) mbar_wait(&empty[st], (i / H_STAGES - 1) & 1);
        unsigned char* a = ring + st * H_STAGE_BYTES;
        mbar_expect_tx(&full[st], H_STAGE_BYTES);
        tma_load_2d(a + H_A_BYTES, &bm, &full[st], kb * S8_BK, c0 + t * S8_BN);
        if (i == 0) griddep_wait();  // a_q: the quant launch's
        tma_load_2d(a, &am, &full[st], kb * S8_BK, m0);
      }
    }
  } else {
    // Warpgroup wg takes column tiles wg, wg + 2, ...; its thread holds
    // rows row and row + 8 of the 64, columns 8 i + col and + 1.
    griddep_wait();  // s: the quant launch's
    float sr[2], amax[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) sr[h] = m0 + row + 8 * h < M ? s[m0 + row + 8 * h] : 0.f;
    for (int t = wg; t < ntiles; t += 2) {
      // The other warpgroup's main loop of tile t - 1 is done, so no stage
      // wait below runs more than one phase ahead of its barrier.
      if (t > 0) named_sync(1 + wg);
      int acc[S8_ACC];
#pragma unroll
      for (int i = 0; i < S8_ACC; ++i) acc[i] = 0;
      s8_fence_acc(acc);
      for (int kb = 0; kb < nk; ++kb) {
        const int i = t * nk + kb, st = i % H_STAGES;
        mbar_wait(&full[st], (i / H_STAGES) & 1);
        const uint32_t a = wg_smem_u32(ring + st * H_STAGE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S8_BK / 32; ++kk)
          wgmma_s8_m64n128k32(acc, wg_desc(a + kk * 32, 16, 1024),
                              wg_desc(a + H_A_BYTES + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // stage i - 1's products are done: release it
        s8_fence_acc(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % H_STAGES]);
        __syncwarp();
      }
      wgmma_wait_all();
      s8_fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(t * nk + nk - 1) % H_STAGES]);
      if (t + 1 < ntiles) named_arrive(2 - wg);
      // The epilogue, beside the other warpgroup's products: g in bf16
      // into its slab row (or, the last tile, the registers), and the rows'
      // running max |g|.
      const bool keep = t >= nsm;
      if (keep) treg = t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* gr = gbuf + (row + 8 * h) * gstr + t * S8_BN * 2;
#pragma unroll
        for (int i = 0; i < S8_BN / 8; ++i) {
          const int c = c0 + t * S8_BN + 8 * i + col;
          const float2 w = *reinterpret_cast<const float2*>(ws + c);
          const float2 bb = *reinterpret_cast<const float2*>(bias + c);
          const float g0 = s8_gelu_of<GELU, true>(acc[4 * i + 2 * h], sr[h], w.x, bb.x);
          const float g1 = s8_gelu_of<GELU, true>(acc[4 * i + 2 * h + 1], sr[h], w.y, bb.y);
          amax[h] = fmaxf(amax[h], fmaxf(fabsf(g0), fabsf(g1)));
          const __nv_bfloat162 p = __floats2bfloat162_rn(g0, g1);  // exact: bf16-valued
          if (keep)
            greg[h][i] = *reinterpret_cast<const uint32_t*>(&p);
          else
            *reinterpret_cast<__nv_bfloat162*>(gr + (8 * i + col) * 2) = p;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
      if (col == 0) rmax[wg * H_BM + row + 8 * h] = amax[h];
    }
  }
  __syncthreads();  // g and both warpgroups' row maxima are on chip
  const int n_slabs = N1 / slab;
  if (threadIdx.x < H_BM) {
    const int r = threadIdx.x;
    const float sc = fmaxf(__fmul_rn(fmaxf(rmax[r], rmax[H_BM + r]), INV127), 1e-12f);
    rcps[r] = __fdiv_rn(1.0f, sc);
    if (m0 + r < M) gs[(size_t)(m0 + r) * n_slabs + j] = sc;
  }
  __syncthreads();
  // The codes, rint(g * (1 / gs)).  The register tiles' through the ring
  // (free: every stage is consumed; rows of 272 bytes), the rest 16 a
  // thread at a time from g in shared memory.
  constexpr int RSTR = H_REG_TILES * S8_BN + 16;
  if (treg >= 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float rcp = rcps[row + 8 * h];
      unsigned char* dst = ring + (row + 8 * h) * RSTR + (treg - nsm) * S8_BN;
#pragma unroll
      for (int i = 0; i < S8_BN / 8; ++i) {
        const uint32_t q0 = (uint32_t)__float2int_rn(__fmul_rn(bf16_lo(greg[h][i]), rcp)) & 0xffu;
        const uint32_t q1 = (uint32_t)__float2int_rn(__fmul_rn(bf16_hi(greg[h][i]), rcp)) & 0xffu;
        *reinterpret_cast<uint16_t*>(dst + 8 * i + col) = (uint16_t)(q0 | (q1 << 8));
      }
    }
  }
  const int per_row = nsm * S8_BN / 16;
  for (int x = threadIdx.x; x < H_BM * per_row; x += H_THREADS) {
    const int rr = x / per_row, cc = (x % per_row) * 16;
    if (m0 + rr >= M) break;  // rows past M come last
    const uint4* src = reinterpret_cast<const uint4*>(gbuf + rr * gstr + cc * 2);
    const float rcp = rcps[rr];
    uint32_t w[4];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 u = src[v];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
      float f[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(e[q]);
      const uint2 p = quant8_rcp(f, rcp);
      w[2 * v] = p.x;
      w[2 * v + 1] = p.y;
    }
    *reinterpret_cast<uint4*>(gq + (size_t)(m0 + rr) * N1 + c0 + cc) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  const int nreg = ntiles - nsm, reg_row = nreg * S8_BN / 16;
  for (int x = threadIdx.x; x < H_BM * reg_row; x += H_THREADS) {
    const int rr = x / reg_row, cc = (x % reg_row) * 16;
    if (m0 + rr >= M) break;
    *reinterpret_cast<uint4*>(gq + (size_t)(m0 + rr) * N1 + c0 + nsm * S8_BN + cc) =
        *reinterpret_cast<const uint4*>(ring + rr * RSTR + cc);
  }
}

// ---- 3. the second product, folded slab by slab ---------------------------
constexpr int O_BM = 192;                                  // rows a CTA: 3 warpgroups
constexpr int O_STAGES = 4;
constexpr int O_THREADS = 384;
constexpr int O_A_BYTES = O_BM * S8_BK;                    // 24 KB
constexpr int O_STAGE_BYTES = O_A_BYTES + S8_BN * S8_BK;   // + 16 KB
constexpr int O_SMEM = O_STAGES * O_STAGE_BYTES + 2 * O_STAGES * 8 + 1024;

__global__ void __launch_bounds__(O_THREADS, 1) mlp_out_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ gs, const float* __restrict__ ws, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int M, int N1, int N2, int slab) {
  extern __shared__ __align__(1024) unsigned char o_raw[];
  const uint32_t raw = wg_smem_u32(o_raw);
  unsigned char* ring = o_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + O_STAGES * O_STAGE_BYTES);
  uint64_t* empty = full + O_STAGES;
  const int n0 = blockIdx.x * S8_BN, m0 = blockIdx.y * O_BM;
  const int nk = N1 / S8_BK, skb = slab / S8_BK, n_slabs = N1 / slab;
  auto issue = [&](int kb) {  // thread 0: k-block kb into its stage
    const int st = kb % O_STAGES;
    unsigned char* a = ring + st * O_STAGE_BYTES;
    mbar_expect_tx(&full[st], O_STAGE_BYTES);
    tma_load_2d(a + O_A_BYTES, &bm, &full[st], kb * S8_BK, n0);  // w2: no dependence
    if (kb == 0) griddep_wait();                                  // g_q: launch 2's
    tma_load_2d(a, &am, &full[st], kb * S8_BK, m0);
  };
  // Thread 0 refills k-block r's stage with r + O_STAGES once every warp
  // has released it.
  auto refill = [&](int r) {
    if (r + O_STAGES >= nk) return;
    mbar_wait(&empty[r % O_STAGES], (r / O_STAGES) & 1);
    issue(r + O_STAGES);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < O_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], O_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < O_STAGES && kb < nk; ++kb) issue(kb);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int row = wg * 64 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  griddep_wait();  // gs: launch 2's
  int acc[S8_ACC];
  float acc2[S8_ACC];
#pragma unroll
  for (int i = 0; i < S8_ACC; ++i) {
    acc[i] = 0;
    acc2[i] = 0.f;
  }
  s8_fence_acc(acc);
  float g[2] = {0.f, 0.f};
  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb % O_STAGES;
    if (kb % skb == 0) {  // a slab starts: its rows' scales, used at its end
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + row + 8 * h;
        g[h] = r < M ? gs[(size_t)r * n_slabs + kb / skb] : 0.f;
      }
    }
    mbar_wait(&full[st], (kb / O_STAGES) & 1);
    const uint32_t a = wg_smem_u32(ring + st * O_STAGE_BYTES) + wg * 64 * S8_BK;
    const uint32_t b = wg_smem_u32(ring + st * O_STAGE_BYTES + O_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk)
      wgmma_s8_m64n128k32(acc, wg_desc(a + kk * 32, 16, 1024), wg_desc(b + kk * 32, 16, 1024));
    wgmma_commit();
    const bool end = (kb + 1) % skb == 0;
    if (end)
      wgmma_wait_all();
    else
      wgmma_wait<1>();
    s8_fence_acc(acc);
    // k-block kb - 1 is released here unless it ended a slab (then it was
    // released at once); a slab's last k-block at once.
    const bool prev = kb > 0 && kb % skb != 0;
    if (lane == 0) {
      if (prev) mbar_arrive(&empty[(kb - 1) % O_STAGES]);
      if (end) mbar_arrive(&empty[st]);
    }
    if (threadIdx.x == 0) {
      if (prev) refill(kb - 1);
      if (end) refill(kb);
    }
    __syncwarp();  // warp 0 reconverges before its next .aligned wgmma
    if (end) {     // acc2 += (float)acc * gs, in slab order; acc = 0
#pragma unroll
      for (int i = 0; i < S8_ACC; ++i) {
        acc2[i] = __fadd_rn(acc2[i], __fmul_rn(__int2float_rn(acc[i]), g[(i >> 1) & 1]));
        acc[i] = 0;
      }
      s8_fence_acc(acc);
    }
  }
  __syncthreads();  // every product is done: the ring stages the outputs
  // out = bf16(acc2 * w2s + b2) through shared memory (rows of 272 bytes:
  // the 8 rows of a store hit distinct banks), then 16-byte stores.
  constexpr int STR = S8_BN * 2 + 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < S8_BN / 8; ++i) {
      const int c = n0 + 8 * i + col;
      const float2 w = *reinterpret_cast<const float2*>(ws + c);
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      const float y0 = __fadd_rn(__fmul_rn(acc2[4 * i + 2 * h], w.x), bb.x);
      const float y1 = __fadd_rn(__fmul_rn(acc2[4 * i + 2 * h + 1], w.y), bb.y);
      *reinterpret_cast<__nv_bfloat162*>(ring + (row + 8 * h) * STR + (8 * i + col) * 2) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < O_BM * S8_BN / 8; x += O_THREADS) {
    const int rr = x / (S8_BN / 8), cc = (x % (S8_BN / 8)) * 8;
    if (m0 + rr < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + rr) * N2 + n0 + cc) =
          *reinterpret_cast<const uint4*>(ring + rr * STR + cc * 2);
  }
}

// Checks the shapes the three launches take; the slab width.
int mlp_slab(int K, int N1, int N2, int n_slabs) {
  if (K % S8_BK || K > 4096 || N2 % S8_BN || n_slabs < 1 || N1 % n_slabs) return 0;
  const int slab = N1 / n_slabs;
  return slab % S8_BN || slab > H_MAX_SLAB ? 0 : slab;
}

cudaError_t launch_hidden(const void* aq, const void* s, const void* w1t, const void* w1s,
                          const void* b1, void* gq, void* gs, int M, int K, int N1, int slab,
                          int gelu_impl, cudaStream_t st) {
  CUtensorMap am, bm;
  cudaError_t e = s8_tensor_map(&am, aq, M, K, H_BM);
  if (e == cudaSuccess) e = s8_tensor_map(&bm, w1t, N1, K, S8_BN);
  if (e != cudaSuccess) return e;
  const dim3 grid(N1 / slab, (M + H_BM - 1) / H_BM);
  auto S = (const float*)s;
  auto WS = (const float*)w1s;
  auto B = (const float*)b1;
  auto Q = (int8_t*)gq;
  auto GS = (float*)gs;
  const int smem = h_smem(slab);
  if (gelu_impl == 1)
    return s8_launch<mlp_hidden_kernel<1>>(grid, H_THREADS, smem, true, st, am, bm, S, WS, B, Q,
                                           GS, M, K, N1, slab);
  if (gelu_impl == 2)
    return s8_launch<mlp_hidden_kernel<2>>(grid, H_THREADS, smem, true, st, am, bm, S, WS, B, Q,
                                           GS, M, K, N1, slab);
  return s8_launch<mlp_hidden_kernel<0>>(grid, H_THREADS, smem, true, st, am, bm, S, WS, B, Q,
                                         GS, M, K, N1, slab);
}

cudaError_t launch_out(const void* gq, const void* gs, const void* w2t, const void* w2s,
                       const void* b2, void* out, int M, int N1, int N2, int slab,
                       cudaStream_t st) {
  CUtensorMap am, bm;
  cudaError_t e = s8_tensor_map(&am, gq, M, N1, O_BM);
  if (e == cudaSuccess) e = s8_tensor_map(&bm, w2t, N2, N1, S8_BN);
  if (e != cudaSuccess) return e;
  const dim3 grid(N2 / S8_BN, (M + O_BM - 1) / O_BM);
  return s8_launch<mlp_out_kernel>(grid, O_THREADS, O_SMEM, true, st, am, bm, (const float*)gs,
                                   (const float*)w2s, (const float*)b2, (__nv_bfloat16*)out, M,
                                   N1, N2, slab);
}

// The three launches, the first on bf16 rows or (A_F32) fp32 ones.
template <bool A_F32>
cudaError_t mlp_launches(const void* a, const void* w1t, const void* w1s, const void* b1,
                         const void* w2t, const void* w2s, const void* b2, void* aq, void* s,
                         void* gq, void* gs, void* out, int M, int K, int N1, int N2,
                         int n_slabs, int gelu_impl, cudaStream_t st) {
  const int slab = mlp_slab(K, N1, N2, n_slabs);
  if (!slab) return cudaErrorInvalidValue;
  cudaError_t e = A_F32 ? launch_quant_rows_f32<true>(a, aq, s, M, K, st)
                        : launch_quant_rows<true>(a, aq, s, M, K, st);
  if (e == cudaSuccess)
    e = launch_hidden(aq, s, w1t, w1s, b1, gq, gs, M, K, N1, slab, gelu_impl, st);
  return e != cudaSuccess ? e : launch_out(gq, gs, w2t, w2s, b2, out, M, N1, N2, slab, st);
}

// ---- the split entry ------------------------------------------------------

template <int GELU>
__global__ void __launch_bounds__(S8_THREADS, 2) mlp_rowmax_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, const float* __restrict__ bias,
    float* __restrict__ part, int M, int K, int N) {
  s8_gelu_tile<GELU, 1, true, true>(am, bm, s, ws, bias, part, nullptr, nullptr, M, K, N);
}

// part [M, nt] (max |g| of each of the rank's 128-column tiles, tile t at
// whole column 128 (tile0 + t)) -> gmax [M, n_slabs]: each row's max over
// the tiles of each slab of tps tiles the rank touches, a thread a row.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256) slab_rowmax(const float* __restrict__ part,
                                                   float* __restrict__ gmax, int M, int nt,
                                                   int tile0, int tps, int n_slabs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  int cur = tile0 / tps;
  float m = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int g = (tile0 + t) / tps;
    if (g != cur) {
      gmax[(size_t)r * n_slabs + cur] = m;
      m = 0.f;
      cur = g;
    }
    m = fmaxf(m, part[(size_t)r * nt + t]);
  }
  gmax[(size_t)r * n_slabs + cur] = m;
}

// The rank's codes: tile (blockIdx.y, blockIdx.x) of a_q [M, K] @ w1t [N,
// K]^T again, g as pass 1 has it, then rint(g * (1 / gs)) with gs of the
// tile's slab from gmax: the hidden kernel's scale and codes.  The codes go
// through shared memory (rows of 144 bytes), then 16-byte stores.
template <int GELU>
__global__ void __launch_bounds__(S8_THREADS, 2) mlp_codes_kernel(
    const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ s, const float* __restrict__ ws, const float* __restrict__ bias,
    const float* __restrict__ gmax, int8_t* __restrict__ gq, int M, int K, int N, int tile0,
    int tps, int n_slabs) {
  const int n0 = blockIdx.x * S8_BN, m0 = blockIdx.y * S8_BM;
  const int slab = (tile0 + blockIdx.x) / tps;
  s8_gemm_tile(
      K / S8_BK,
      [&](int kb, unsigned char* a, unsigned char* b, uint64_t* bar) {
        tma_load_2d(a, &am, bar, kb * S8_BK, m0);
        tma_load_2d(b, &bm, bar, kb * S8_BK, n0);
      },
      [](int, int) {},
      [&](const int (&acc)[S8_ACC], int row, int col, unsigned char* stage) {
        constexpr int STR = S8_BN + 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row + 8 * h;
          const bool ok = r < M;
          const float sr = ok ? s[r] : 0.f;
          const float sc =
              ok ? fmaxf(__fmul_rn(gmax[(size_t)r * n_slabs + slab], INV127), 1e-12f) : 1.f;
          const float rcp = __fdiv_rn(1.0f, sc);
#pragma unroll
          for (int i = 0; i < S8_BN / 8; ++i) {
            const int c = n0 + 8 * i + col;
            const float2 w = *reinterpret_cast<const float2*>(ws + c);
            const float2 bb = *reinterpret_cast<const float2*>(bias + c);
            const float g0 = s8_gelu_of<GELU, true>(acc[4 * i + 2 * h], sr, w.x, bb.x);
            const float g1 = s8_gelu_of<GELU, true>(acc[4 * i + 2 * h + 1], sr, w.y, bb.y);
            const uint32_t q0 = (uint32_t)__float2int_rn(__fmul_rn(g0, rcp)) & 0xffu;
            const uint32_t q1 = (uint32_t)__float2int_rn(__fmul_rn(g1, rcp)) & 0xffu;
            *reinterpret_cast<uint16_t*>(stage + (row + 8 * h) * STR + 8 * i + col) =
                (uint16_t)(q0 | (q1 << 8));
          }
        }
        __syncthreads();
        for (int x = threadIdx.x; x < S8_BM * S8_BN / 16; x += S8_THREADS) {
          const int rr = x / (S8_BN / 16), cc = (x % (S8_BN / 16)) * 16;
          if (m0 + rr < M)
            *reinterpret_cast<uint4*>(gq + (size_t)(m0 + rr) * N + n0 + cc) =
                *reinterpret_cast<const uint4*>(stage + rr * STR + cc);
        }
      });
}

// acc [n_slabs, M, N2] s32 (every slab's product, summed over the ranks),
// gmax [M, n_slabs] -> out [M, N2] bf16: mlp_out_kernel's fold in slab order
// and its epilogue, an output a thread.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256) mlp_fold(const int* __restrict__ acc,
                                                const float* __restrict__ gmax,
                                                const float* __restrict__ ws,
                                                const float* __restrict__ bias,
                                                __nv_bfloat16* __restrict__ out, int M, int N,
                                                int n_slabs) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int r = (int)(i / N), c = (int)(i % N);
  float a2 = 0.f;
  for (int j = 0; j < n_slabs; ++j) {
    const float g = fmaxf(__fmul_rn(gmax[(size_t)r * n_slabs + j], INV127), 1e-12f);
    a2 = __fadd_rn(a2, __fmul_rn(__int2float_rn(acc[(size_t)j * M * N + i]), g));
  }
  out[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(a2, ws[c]), bias[c]));
}

// The rank's span [col0, col0 + N1l) of the whole N1 in slabs of `slab`:
// both multiples of 128, the span inside N1.
bool split_ok(int K, int N1l, int N2, int col0, int slab, int n_slabs) {
  return K % S8_BK == 0 && N1l % S8_BN == 0 && N1l > 0 && N2 % S8_BN == 0 &&
         col0 % S8_BN == 0 && slab % S8_BN == 0 && col0 + N1l <= slab * n_slabs;
}

cudaError_t launch_rowmax(const CUtensorMap& am, const CUtensorMap& bm, const void* s,
                          const void* ws, const void* b, void* part, int M, int K, int N,
                          int gelu_impl, cudaStream_t st) {
  const dim3 grid(N / S8_BN, (M + S8_BM - 1) / S8_BM);
  auto S = (const float*)s;
  auto WS = (const float*)ws;
  auto B = (const float*)b;
  auto P = (float*)part;
  if (gelu_impl == 1)
    return s8_launch<mlp_rowmax_kernel<1>>(grid, S8_THREADS, S8_SMEM, true, st, am, bm, S, WS, B,
                                           P, M, K, N);
  if (gelu_impl == 2)
    return s8_launch<mlp_rowmax_kernel<2>>(grid, S8_THREADS, S8_SMEM, true, st, am, bm, S, WS, B,
                                           P, M, K, N);
  return s8_launch<mlp_rowmax_kernel<0>>(grid, S8_THREADS, S8_SMEM, true, st, am, bm, S, WS, B, P,
                                         M, K, N);
}

cudaError_t launch_codes(const CUtensorMap& am, const CUtensorMap& bm, const void* s,
                         const void* ws, const void* b, const void* gmax, void* gq, int M, int K,
                         int N, int tile0, int tps, int n_slabs, int gelu_impl, cudaStream_t st) {
  const dim3 grid(N / S8_BN, (M + S8_BM - 1) / S8_BM);
  auto S = (const float*)s;
  auto WS = (const float*)ws;
  auto B = (const float*)b;
  auto G = (const float*)gmax;
  auto Q = (int8_t*)gq;
  if (gelu_impl == 1)
    return s8_launch<mlp_codes_kernel<1>>(grid, S8_THREADS, S8_SMEM, false, st, am, bm, S, WS, B,
                                          G, Q, M, K, N, tile0, tps, n_slabs);
  if (gelu_impl == 2)
    return s8_launch<mlp_codes_kernel<2>>(grid, S8_THREADS, S8_SMEM, false, st, am, bm, S, WS, B,
                                          G, Q, M, K, N, tile0, tps, n_slabs);
  return s8_launch<mlp_codes_kernel<0>>(grid, S8_THREADS, S8_SMEM, false, st, am, bm, S, WS, B, G,
                                        Q, M, K, N, tile0, tps, n_slabs);
}

}  // namespace

// Launch 1 alone: a [M, K] bf16 -> aq [M, K] s8, s [M] f32 (reciprocal
// codes).  Needs K <= 4096, K % 8 == 0.
extern "C" int mlp_quant(const void* a, void* aq, void* s, int M, int K, void* stream) {
  return launch_quant_rows<true>(a, aq, s, M, K, (cudaStream_t)stream);
}

// Launch 2 alone, on launch 1's aq and s: w1t [N1, K] s8 (w1 K-major), w1s
// and b1 [N1] f32 -> gq [M, N1] s8, gs [M, n_slabs] f32.
extern "C" int mlp_hidden(const void* aq, const void* s, const void* w1t, const void* w1s,
                          const void* b1, void* gq, void* gs, int M, int K, int N1, int n_slabs,
                          int gelu_impl, void* stream) {
  const int slab = mlp_slab(K, N1, S8_BN, n_slabs);
  if (!slab) return cudaErrorInvalidValue;
  return launch_hidden(aq, s, w1t, w1s, b1, gq, gs, M, K, N1, slab, gelu_impl,
                       (cudaStream_t)stream);
}

// Launch 3 alone, on launch 2's gq and gs: w2t [N2, N1] s8 (w2 K-major),
// w2s and b2 [N2] f32 -> out [M, N2] bf16.
extern "C" int mlp_out(const void* gq, const void* gs, const void* w2t, const void* w2s,
                       const void* b2, void* out, int M, int N1, int N2, int n_slabs,
                       void* stream) {
  const int slab = mlp_slab(S8_BK, N1, N2, n_slabs);
  if (!slab) return cudaErrorInvalidValue;
  return launch_out(gq, gs, w2t, w2s, b2, out, M, N1, N2, slab, (cudaStream_t)stream);
}

// a [M, K] bf16; w1t [N1, K] s8 (w1 K-major), w1s and b1 [N1] f32; w2t
// [N2, N1] s8 (w2 K-major), w2s and b2 [N2] f32.  Scratch: aq [M, K] s8, s
// [M] f32, gq [M, N1] s8, gs [M, n_slabs] f32.  Output: out [M, N2] bf16.
// Needs K % 128 == 0, K <= 4096, N1 = n_slabs * slab with slab % 128 == 0
// and slab <= 1280, N2 % 128 == 0 (the wrapper checks).  Three launches.
extern "C" int int8_mlp(const void* a, const void* w1t, const void* w1s, const void* b1,
                        const void* w2t, const void* w2s, const void* b2, void* aq, void* s,
                        void* gq, void* gs, void* out, int M, int K, int N1, int N2, int n_slabs,
                        int gelu_impl, void* stream) {
  return mlp_launches<false>(a, w1t, w1s, b1, w2t, w2s, b2, aq, s, gq, gs, out, M, K, N1, N2,
                             n_slabs, gelu_impl, (cudaStream_t)stream);
}

// The same on a [M, K] fp32: the fp32 mode, whose row quant reads fp32 rows.
extern "C" int int8_mlp_f32(const void* a, const void* w1t, const void* w1s, const void* b1,
                            const void* w2t, const void* w2s, const void* b2, void* aq, void* s,
                            void* gq, void* gs, void* out, int M, int K, int N1, int N2,
                            int n_slabs, int gelu_impl, void* stream) {
  return mlp_launches<true>(a, w1t, w1s, b1, w2t, w2s, b2, aq, s, gq, gs, out, M, K, N1, N2,
                            n_slabs, gelu_impl, (cudaStream_t)stream);
}

// ---- B13 on a rank's columns (tensor parallelism; see the top) ------------
// The rank holds columns [col0, col0 + N1l) of the whole N1 (n_slabs slabs
// of `slab`): w1t [N1l, K] s8 (its columns of w1, K-major), w1s and b1
// [N1l] f32, w2t [N2, N1l] s8 (its rows of w2, K-major).  Part 1: a [M, K]
// bf16 -> aq [M, K] s8, s [M] f32 (the row quant), part [M, N1l / 128]
// f32 scratch, gmax [M, n_slabs] f32 (the entries of the slabs the rank
// touches written; the caller zeroes the rest).  Three launches.
extern "C" int mlp_split1(const void* a, const void* w1t, const void* w1s, const void* b1,
                          void* aq, void* s, void* part, void* gmax, int M, int K, int N1l,
                          int N2, int col0, int slab, int n_slabs, int gelu_impl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split_ok(K, N1l, N2, col0, slab, n_slabs) || K > 4096) return cudaErrorInvalidValue;
  cudaError_t e = launch_quant_rows<true>(a, aq, s, M, K, st);
  CUtensorMap am, bm;
  if (e == cudaSuccess) e = s8_maps(&am, &bm, aq, w1t, M, K, N1l);
  if (e == cudaSuccess) e = launch_rowmax(am, bm, s, w1s, b1, part, M, K, N1l, gelu_impl, st);
  if (e != cudaSuccess) return e;
  slab_rowmax<><<<(M + 255) / 256, 256, 0, st>>>((const float*)part, (float*)gmax, M,
                                                  N1l / S8_BN, col0 / S8_BN, slab / S8_BN,
                                                  n_slabs);
  return cudaGetLastError();
}

// Part 2, on part 1's aq and s and gmax maxed over the ranks: gq [M, N1l]
// s8 (the rank's codes) and acc [n_slabs, M, N2] s32, the int32 product of
// each slab's part the rank holds written into that slab's plane (the
// caller zeroes the others).  One launch, then one a slab part.
extern "C" int mlp_split2(const void* aq, const void* s, const void* w1t, const void* w1s,
                          const void* b1, const void* gmax, const void* w2t, void* gq, void* acc,
                          int M, int K, int N1l, int N2, int col0, int slab, int n_slabs,
                          int gelu_impl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split_ok(K, N1l, N2, col0, slab, n_slabs)) return cudaErrorInvalidValue;
  CUtensorMap am, bm;
  cudaError_t e = s8_maps(&am, &bm, aq, w1t, M, K, N1l);
  if (e == cudaSuccess)
    e = launch_codes(am, bm, s, w1s, b1, gmax, gq, M, K, N1l, col0 / S8_BN, slab / S8_BN,
                     n_slabs, gelu_impl, st);
  for (int g = col0 / slab; e == cudaSuccess && g * slab < col0 + N1l; ++g) {
    const int lo = (g * slab > col0 ? g * slab : col0) - col0;
    const int hi = ((g + 1) * slab < col0 + N1l ? (g + 1) * slab : col0 + N1l) - col0;
    e = launch_s8_acc((const int8_t*)gq + lo, N1l, (const int8_t*)w2t + lo, N1l,
                      (int*)acc + (size_t)g * M * N2, M, hi - lo, N2, false, st);
  }
  return e;
}

// Part 3, on acc summed over the ranks: w2s, b2 [N2] f32 -> out [M, N2]
// bf16.  One launch.
extern "C" int mlp_split3(const void* acc, const void* gmax, const void* w2s, const void* b2,
                          void* out, int M, int N2, int n_slabs, void* stream) {
  const size_t n = (size_t)M * N2;
  mlp_fold<><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)acc, (const float*)gmax, (const float*)w2s, (const float*)b2,
      (__nv_bfloat16*)out, M, N2, n_slabs);
  return cudaGetLastError();
}
