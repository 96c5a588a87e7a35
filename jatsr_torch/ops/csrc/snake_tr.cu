// snake -> ConvTranspose1d (K = 2s) by the polyphase identity, for Hopper.
//
// Replaces the TPU kernel snake_conv_transpose_fused (_snake_tr_kernel, B7)
// in the JAX package's ops/dac_kernels.py.  It computes
//   flat[t*s + p] = y[t] @ w[p] + y[t-1] @ w[p+s] + b,   y = bf16(snake(x, a))
//   out[m]        = flat[m + pad],  m in [0, m_out)
// with bf16 products summed in fp32, y zero outside [0, T) and the bias added
// with __fadd_rn.  (B8, the same product on stage 0's pre-snaked input, is
// snake_tr_stream.cu.)
//
// What bounds it on the H100, at one 2884-frame decode segment: stage 1
// (768 -> 384, s 8, T 23,072) is 2.18e11 bf16 operations (0.22 ms at 989
// TFLOP/s); stages 2 and 3 (384 -> 192, s 4; 192 -> 96, s 2) move 0.85 and
// 1.13 GB of fp32 x in and out (0.25, 0.34 ms at 3.35 TB/s).
//
// Design at Cin <= 384 (stages 2 and 3): snake_tr_rows, one persistent CTA
// an SM walking tiles of 128 rows t of one batch element, each tile through
// all s phases and all Cout columns, as the TPU kernel's row block does.
// Flat row t is out rows t*s - pad .. t*s + s - 1 - pad, so a tile writes
// the whole of out rows [t0*s - pad, (t0 + 128)*s - pad) (those in [0,
// m_out)), a phase at a time, with 16-byte streaming stores.  The tile's
// y = bf16(snake(x)) of rows t0 - 1 .. t0 + 127 (the halo row t0 - 1 for
// the second tap) lives in shared memory only: x is read from device memory
// once and snaked once, and y never goes through device memory.  Roles:
//   warp 0, one thread: the weight's TMA ring.  For each phase p, tap and
//     64-channel block the stage holds [64 k][BN n] of w[p + tap s], read in
//     place from the [2s Cin, Cout] weight as N-major 128-byte-swizzled
//     boxes (B8's operand B); BN = 96 at Cout 96, else 192.
//   the snake warps (3, or 7 at BN 96): x arrives by TMA in chunks of
//     [129 rows][32 or 64 channels] fp32 (rows outside [0, T) zero-filled, and
//     snake(0) = 0) through a ring of staging buffers that one snake thread
//     refills; they snake each element once (snake.cuh's snake_batch, eight
//     at a time) and store y as bf16.  A tile's y block cb (64 channels) is
//     written once the consumers have read the previous tile's block cb for
//     the last time (mbarrier yfree[cb]), and announced by yfull[cb].
//   two consumer warpgroups, 64 rows t each: per phase, wgmma over depth
//     2 Cin (tap 0 on y[t], tap 1 on y[t-1]), then the epilogue.
// The one-row shift between the taps: y is stored K-major without swizzle,
// in 8-channel strips of 16-byte rows (core matrices of 8 rows x 16 bytes,
// rows 16 bytes apart), so an A descriptor may start at any row: tap 1's
// starts one row (16 bytes) before tap 0's.  Strips are 130 rows (2080
// bytes) apart, so the snake warps' 16-byte stores hit distinct banks.
// The weight is re-read from L2 for every tile: 1.18 MB a tile at stage 2
// (1.7 GB over the stage), 147 KB at stage 3.
//
// Design at Cin 768 (stage 1): its y would take 198 KB of shared memory a
// 128-row tile, and the stage is bound by the tensor cores, so a snake pass
// (snake_b16: x read once, y = 35 MB written once) runs in front of B8's
// polyphase_wgmma (snake_tr_stream.cu), whose products never wait on a
// snake.
//
// Numerics: snake.cuh's snake (bit-equal to snake_batch), bf16 y, fp32
// sums; only the order of the sums differs from the mma.sync version.

#include "bf16_wgmma.cuh"
#include "snake.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

constexpr int TR_TB = 128;                      // rows t a tile
constexpr int TR_ROWS = TR_TB + 1;              // x and y rows a tile: t0 - 1 .. t0 + 127
constexpr int TR_STRIP = 130 * 16;              // bytes between y's 8-channel strips

struct TrArgs {
  const float* alpha;  // [Cin]
  const float* bias;   // [Cout]
  float* out;          // [B, m_out, Cout]
  int B, T, Cin, Cout, s, pad, m_out, stages, xbufs;
};

// A wgmma shared-memory descriptor without swizzle (layout type 0), K-major:
// core matrices of 8 rows x 16 bytes; `lbo` bytes between the 8-channel
// strips (along K), `sbo` between 8-row groups (along M).
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// Orders this thread's shared-memory stores before later async-proxy
// (wgmma) reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbar_wait that traps after ~2^34 cycles (~9 s) instead of hanging the
// card where a phase never completes.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
  const uint32_t a = wg_smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  }
}

// The snake warps' own barrier (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void snake_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stages 2 and 3.  NWG warpgroups: the last two are the consumers, the
// first NWG - 2 hold the producer warp and 4 (NWG - 2) - 1 snake warps.  x
// arrives in chunks of XC (32 or 64) channels.  Dynamic shared memory
// (ops/dac_kernels.py:_tr_plan): the 1024-aligned ring of `stages` weight
// stages, `xbufs` x chunks, y (Cin / 8 strips), the mbarriers, then alpha,
// 1 / (alpha + 1e-9) and the bias in fp32.
template <int BN, int NWG, int XC, bool B16>
__global__ void __launch_bounds__(NWG * 128, 1) snake_tr_rows(
    const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
    const TrArgs p) {
  constexpr int BOXES = (BN + 63) / 64;
  constexpr int STAGE = BOXES * WG_B_BOX;
  constexpr int SW = 4 * (NWG - 2) - 1;  // snake warps: warps 1 .. SW
  constexpr int ST = 32 * SW;
  constexpr int CW0 = 4 * (NWG - 2);     // the first consumer warp
  constexpr int XBYTES = TR_ROWS * XC * 4;
  constexpr int CPB = 64 / XC;           // x chunks a 64-channel block of y
  constexpr int G = XC / 8;              // 8-channel groups a chunk
  static_assert(ST % G == 0, "a snake thread keeps its channels");
  const int Cin = p.Cin, Cout = p.Cout, S = p.stages, NX = p.xbufs, s = p.s;
  const int kc = Cin / 64, nchunks = Cin / XC, ntiles = (Cout + BN - 1) / BN;
  const int mtiles = (p.T + TR_TB) / TR_TB;  // rows t in [0, T]
  const int tiles = p.B * mtiles;
  extern __shared__ __align__(1024) unsigned char raw[];
  const uint32_t raw_u32 = wg_smem_u32(raw);
  unsigned char* ring = raw + (((raw_u32 + 1023) & ~1023u) - raw_u32);
  unsigned char* xs = ring + S * STAGE;
  unsigned char* y = xs + NX * XBYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(y + (Cin / 8) * TR_STRIP);
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;
  uint64_t* yfull = xfull + NX;
  uint64_t* yfree = yfull + kc;
  const int nbar = 2 * S + NX + 2 * kc;
  float* alpha = reinterpret_cast<float*>(full + nbar + (nbar & 1));  // 16-byte aligned
  float* inv = alpha + Cin;
  float* bias = inv + Cin;  // ntiles * BN, zero past Cout
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WG_CONSUMER_WARPS);
    }
    for (int i = 0; i < NX; ++i) mbar_init(&xfull[i], 1);
    for (int i = 0; i < kc; ++i) {
      mbar_init(&yfull[i], ST);
      mbar_init(&yfree[i], WG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < Cin; c += blockDim.x) {
    alpha[c] = snake_a_t<B16>(p.alpha[c]);
    inv[c] = snake_inv_t<B16>(p.alpha[c]);
  }
  for (int n = threadIdx.x; n < ntiles * BN; n += blockDim.x) bias[n] = n < Cout ? p.bias[n] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {  // the producer: one thread keeps the weight ring full
    if (lane == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int nt = 0; nt < ntiles; ++nt)
          for (int ph = 0; ph < s; ++ph)
            for (int cb = 0; cb < kc; ++cb)
              for (int tap = 0; tap < 2; ++tap, ++it) {
                const int st = it % S;
                if (it >= (uint32_t)S) mbar_wait_or_trap(&empty[st], (it / S - 1) & 1);
                unsigned char* b = ring + st * STAGE;
                mbar_expect_tx(&full[st], STAGE);
                const int krow = (ph + tap * s) * Cin + cb * 64;
#pragma unroll
                for (int j = 0; j < BOXES; ++j)
                  tma_load_2d(b + j * WG_B_BOX, &wm, &full[st], nt * BN + 64 * j, krow);
              }
    }
    return;
  }

  if (warp <= SW) {  // the snake warps: x chunks -> y, each element once
    const int w = threadIdx.x - 32, g = w % G;  // g: the thread's 8 channels of a chunk
    auto issue = [&](int q) {  // chunk q of this CTA's walk into its buffer
      const int lt = q / nchunks, c = q % nchunks;
      const int tile = blockIdx.x + lt * gridDim.x;
      if (tile >= tiles) return;
      uint64_t* bar = &xfull[q % NX];
      mbar_expect_tx(bar, XBYTES);
      tma_load_3d(xs + (q % NX) * XBYTES, &xm, bar, c * XC, (tile % mtiles) * TR_TB - 1,
                  tile / mtiles);
    };
    if (w == 0)
      for (int q = 0; q < NX; ++q) issue(q);
    int q = 0, lt = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
      for (int c = 0; c < nchunks; ++c, ++q) {
        const int cb = c / CPB;
        if (c % CPB == 0 && lt > 0) mbar_wait_or_trap(&yfree[cb], (lt - 1) & 1);
        mbar_wait_or_trap(&xfull[q % NX], (q / NX) & 1);
        const float* xc = reinterpret_cast<const float*>(xs + (q % NX) * XBYTES) + 8 * g;
        const int ch = c * XC + 8 * g;
        float a[8], iv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = alpha[ch + j], iv[j] = inv[ch + j];
        unsigned char* ys = y + (ch >> 3) * TR_STRIP;
        for (int r = w / G; r < TR_ROWS; r += ST / G) {
          const float4 v0 = *reinterpret_cast<const float4*>(xc + r * XC);
          const float4 v1 = *reinterpret_cast<const float4*>(xc + r * XC + 4);
          const float xv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
          float yv[8];
          snake_batch_t<8, B16>(xv, a, iv, yv);
          *reinterpret_cast<uint4*>(ys + r * 16) =
              make_uint4(pack_bf16(yv[0], yv[1]), pack_bf16(yv[2], yv[3]),
                         pack_bf16(yv[4], yv[5]), pack_bf16(yv[6], yv[7]));
        }
        snake_sync(ST);  // every snake thread is done with the chunk's buffer
        if (w == 0) issue(q + NX);
        if (c % CPB == CPB - 1) {
          fence_async_shared();
          mbar_arrive(&yfull[cb]);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup cw owns rows t0 + 64 cw .. + 63 of a tile.
  const int cw = (warp - CW0) >> 2;
  const int row = cw * 64 + (warp & 3) * 16 + (lane >> 2), col = 2 * (lane & 3);
  const bool odd = lane & 1;
  const uint32_t ya = wg_smem_u32(y) + cw * 64 * 16;  // y's row slot of t0 + 64 cw - 1
  const uint32_t rb = wg_smem_u32(ring);
  uint32_t it = 0;
  int lt = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
    const int b = tile / mtiles, t0 = (tile % mtiles) * TR_TB;
    for (int nt = 0; nt < ntiles; ++nt)
      for (int ph = 0; ph < s; ++ph) {
        const bool first = nt == 0 && ph == 0, last = nt == ntiles - 1 && ph == s - 1;
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        wg_fence_acc(acc);
        for (int cb = 0; cb < kc; ++cb) {
          if (first) mbar_wait_or_trap(&yfull[cb], lt & 1);
          for (int tap = 0; tap < 2; ++tap, ++it) {
            const int st = it % S;
            mbar_wait_or_trap(&full[st], (it / S) & 1);
            // tap 0 reads y[t] (slot r + 1), tap 1 y[t - 1] (slot r)
            const uint32_t a = ya + cb * 8 * TR_STRIP + (tap ? 0 : 16);
            const uint32_t bb = rb + st * STAGE;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_k16<BN>(acc, plain_desc(a + kk * 2 * TR_STRIP, TR_STRIP, 128),
                            wg_desc(bb + kk * 2048, WG_B_BOX, 1024));
            wgmma_commit();
            wgmma_wait<1>();  // the k-block before this one is done
            wg_fence_acc(acc);
            if ((cb > 0 || tap > 0) && lane == 0) {
              mbar_arrive(&empty[(it - 1) % S]);
              if (last && tap == 0) mbar_arrive(&yfree[cb - 1]);  // block cb - 1's last read
            }
            __syncwarp();  // whole again before the next .aligned wgmma
          }
        }
        wgmma_wait_all();
        wg_fence_acc(acc);
        if (lane == 0) {
          mbar_arrive(&empty[(it - 1) % S]);
          if (last) mbar_arrive(&yfree[kc - 1]);
        }
        __syncwarp();
        // acc[4 i + e]: row `row` (+ 8 for e >= 2), column 8 i + col + (e
        // & 1).  Lane pairs swap a column pair, so that each lane holds
        // four adjacent columns of one row: the even lane row `row`, the
        // odd lane row `row + 8`.
        const float* bs = bias + nt * BN;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float s0 = odd ? acc[4 * i] : acc[4 * i + 2];
          const float s1 = odd ? acc[4 * i + 1] : acc[4 * i + 3];
          const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const int r = row + (odd ? 8 : 0), c = 8 * i + col - (odd ? 2 : 0);
          float4 v = odd ? make_float4(g0, g1, acc[4 * i + 2], acc[4 * i + 3])
                         : make_float4(acc[4 * i], acc[4 * i + 1], g0, g1);
          const float4 bv = *reinterpret_cast<const float4*>(bs + c);
          v.x = __fadd_rn(v.x, bv.x);
          v.y = __fadd_rn(v.y, bv.y);
          v.z = __fadd_rn(v.z, bv.z);
          v.w = __fadd_rn(v.w, bv.w);
          const int t = t0 + r, m = t * s + ph - p.pad, n = nt * BN + c;
          if (t <= p.T && m >= 0 && m < p.m_out && n < Cout)
            __stcs(reinterpret_cast<float4*>(p.out + ((size_t)b * p.m_out + m) * Cout + n), v);
        }
      }
  }
}

// Stage 1's snake pass: y[i] = bf16(snake(x[i], a[i % C])), eight elements
// a thread at a time (C % 8 == 0), the per-channel alpha and reciprocal in
// shared memory (2 C floats of dynamic shared memory); B16: the bf16 mode.
template <bool B16>
__global__ void __launch_bounds__(256) snake_b16_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ alpha,
                                                        __nv_bfloat16* __restrict__ y, size_t n,
                                                        int C) {
  extern __shared__ float tab[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    tab[c] = snake_a_t<B16>(alpha[c]);
    tab[C + c] = snake_inv_t<B16>(alpha[c]);
  }
  __syncthreads();
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8; i < n;
       i += (size_t)gridDim.x * blockDim.x * 8) {
    const float4 v0 = __ldcs(reinterpret_cast<const float4*>(x + i));
    const float4 v1 = __ldcs(reinterpret_cast<const float4*>(x + i + 4));
    const int c = (int)(i % C);
    const float xv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    float a[8], iv[8], yv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = tab[c + j], iv[j] = tab[C + c + j];
    snake_batch_t<8, B16>(xv, a, iv, yv);
    *reinterpret_cast<uint4*>(y + i) = make_uint4(pack_bf16(yv[0], yv[1]), pack_bf16(yv[2], yv[3]),
                                                  pack_bf16(yv[4], yv[5]), pack_bf16(yv[6], yv[7]));
  }
}

// x [B, T, Cin] fp32 as a TMA map of [129 rows][xc channels] boxes, no
// swizzle, rows outside [0, T) zero-filled.
cudaError_t x_map(CUtensorMap* map, const void* x, int B, int T, int Cin, int xc) {
  const EncodeTiled encode = wg_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * 4, (cuuint64_t)T * Cin * 4};
  const cuuint32_t box[3] = {(cuuint32_t)xc, TR_ROWS, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(x), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int NWG, int XC, bool B16>
cudaError_t launch_rows(const CUtensorMap& xm, const CUtensorMap& wm, const TrArgs& a, int grid,
                        int smem, cudaStream_t st) {
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        snake_tr_rows<BN, NWG, XC, B16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  snake_tr_rows<BN, NWG, XC, B16><<<grid, NWG * 128, smem, st>>>(xm, wm, a);
  return cudaGetLastError();
}

}  // namespace

// Stages 2 and 3 (Cin a multiple of 64 up to 384): x [B, T, Cin] fp32,
// alpha [Cin] fp32, w [2s, Cin, Cout] bf16, bias [Cout] fp32 -> out [B,
// m_out, Cout] fp32; all 16-byte aligned.  One launch of `grid` CTAs of
// `threads` threads (512 at bn 96, 384 at bn 192) with `smem` bytes of
// dynamic shared memory, `stages` weight stages and `xbufs` x chunks of
// `xc` channels (32 or 64; ops/dac_kernels.py:_tr_plan).  Needs Cout % 8
// == 0.  b16: the snake in the bf16 mode (snake.cuh).
extern "C" int snake_conv_transpose_rows(const void* x, const void* alpha, const void* w,
                                         const void* bias, void* out, int B, int T, int Cin,
                                         int Cout, int s, int pad, int m_out, int bn, int threads,
                                         int stages, int xbufs, int xc, int grid, int smem,
                                         int b16, void* stream) {
  CUtensorMap xm, wm;
  cudaError_t e = x_map(&xm, x, B, T, Cin, xc);
  if (e != cudaSuccess) return e;
  const cuuint64_t w_dims[2] = {(cuuint64_t)Cout, (cuuint64_t)2 * s * Cin};
  const cuuint64_t w_strides[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t w_box[2] = {64, WG_BK};
  e = wg_tensor_map(&wm, w, 2, w_dims, w_strides, w_box);
  if (e != cudaSuccess) return e;
  const TrArgs a{(const float*)alpha, (const float*)bias, (float*)out, B, T, Cin, Cout, s, pad,
                 m_out, stages, xbufs};
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 96 && threads == 512 && xc == 64)
    return b16 ? launch_rows<96, 4, 64, true>(xm, wm, a, grid, smem, st)
               : launch_rows<96, 4, 64, false>(xm, wm, a, grid, smem, st);
  if (bn == 192 && threads == 384 && xc == 32)
    return b16 ? launch_rows<192, 3, 32, true>(xm, wm, a, grid, smem, st)
               : launch_rows<192, 3, 32, false>(xm, wm, a, grid, smem, st);
  return cudaErrorInvalidValue;
}

// Stage 1's snake pass: x [n] fp32 (rows of C channels, C % 8 == 0), alpha
// [C] -> y [n] bf16, on `blocks` blocks of 256 threads; b16: the bf16 mode.
extern "C" int snake_b16(const void* x, const void* alpha, void* y, long long n, int C,
                         int blocks, int b16, void* stream) {
  if (b16)
    snake_b16_kernel<true><<<blocks, 256, 2 * C * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)x, (const float*)alpha, (__nv_bfloat16*)y, (size_t)n, C);
  else
    snake_b16_kernel<false><<<blocks, 256, 2 * C * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)x, (const float*)alpha, (__nv_bfloat16*)y, (size_t)n, C);
  return cudaGetLastError();
}
