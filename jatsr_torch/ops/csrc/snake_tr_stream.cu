// The polyphase ConvTranspose1d of decoder stage 0 on pre-snaked bf16 input,
// for Hopper: one wgmma GEMM a phase.
//
// Replaces the TPU kernel _snake_conv_transpose_streamed (B8,
// _snake_tr_stream_kernel, pallas_call :604) in the JAX package's
// ops/dac_kernels.py (:569).  It computes, for K = 2s,
//   flat[t*s + p] = y[t] @ w[p] + y[t-1] @ w[p+s] + b,   t in [0, T]
//   out[m]        = flat[m + pad],  m in [0, m_out)
// on y = bf16(snake(x)) (its wrapper snakes x first), with bf16 products
// summed in fp32, y zero outside [0, T) and the bias added with __fadd_rn.
// The TPU kernel streams the weights one phase at a time because stage 0's
// (37.7 MB) overflow a core's VMEM; here the phases are a grid dimension.
//
// What bounds it on the H100, at one 2884-frame decode segment (Cin 1536 ->
// Cout 768, s 8, m_out 23,072): 1.09e11 bf16 operations (0.110 ms at 989
// TFLOP/s) against 117 MB of compulsory traffic (y, w and the fp32 out:
// 0.035 ms at 3.35 TB/s): the tensor cores.
//
// Design: bf16_wgmma.cuh's tile.  For phase p the rows t of the output form
// one GEMM [T + 1, 2 Cin] x [2 Cin, Cout]: A = [y[t], y[t-1]], B = [w[p];
// w[p+s]].  A CTA takes 128 rows t x 192 columns of one phase: 2 Cin / 64
// k-blocks, the first Cin / 64 of tap 0, the rest of tap 1.  A k-block's A
// is one TMA box of y at rows t0 (tap 0) or t0 - 1 (tap 1), batch b: the box
// zero-fills y[-1] and y[T].., so the taps need no padded copy.  Its B is
// three boxes of the [2s Cin, Cout] weight, N contiguous, read in place.
// The epilogue adds the bias and writes out[m], m = t s + p - pad, where
// 0 <= m < m_out and t <= T: no flat buffer, no slice.  Grid: (row tiles x
// column tiles, phase, batch), the column tiles of one row tile adjacent so
// that they share A in L2.  At stage 0: 23 x 4 x 8 = 736 CTAs, 5.6 waves of
// 132.  Sum order is the only change from the mma.sync tile it replaced.
// Needs Cin % 64 == 0 (a k-block never straddles the taps; B8's gate takes
// Cin % 128 == 0) and Cout % 8 == 0 (16-byte rows for the tensor map).

#include "bf16_wgmma.cuh"

extern "C" const char* jt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

namespace {

__global__ void __launch_bounds__(WG_THREADS, 1) polyphase_wgmma(
    const __grid_constant__ CUtensorMap ya, const __grid_constant__ CUtensorMap wb,
    const float* __restrict__ bias, float* __restrict__ out, int T, int Cin, int Cout, int s,
    int pad, int m_out) {
  const int p = blockIdx.y, b = blockIdx.z;
  const int ntiles = (Cout + WG_BN - 1) / WG_BN;
  const int t0 = (blockIdx.x / ntiles) * WG_BM, n0 = (blockIdx.x % ntiles) * WG_BN;
  const int kc = Cin / WG_BK;  // k-blocks a tap
  wg_gemm_tile(
      2 * kc,
      [&](int kb, unsigned char* a, unsigned char* w, uint64_t* bar) {
        const int tap = kb / kc, c0 = (kb % kc) * WG_BK;
        tma_load_3d(a, &ya, bar, c0, t0 - tap, b);
        const int krow = (p + tap * s) * Cin + c0;
#pragma unroll
        for (int j = 0; j < WG_BN / 64; ++j) tma_load_2d(w + j * WG_B_BOX, &wb, bar, n0 + 64 * j, krow);
      },
      [&](int r, int c, float v0, float v1) {
        const int t = t0 + r, n = n0 + c, m = t * s + p - pad;
        if (t > T || m < 0 || m >= m_out || n >= Cout) return;
        *reinterpret_cast<float2*>(out + ((size_t)b * m_out + m) * Cout + n) =
            make_float2(__fadd_rn(v0, bias[n]), __fadd_rn(v1, bias[n + 1]));
      });
}

}  // namespace

// y [B, T, Cin] bf16 (snaked), w [2s, Cin, Cout] bf16, bias [Cout] fp32 ->
// out [B, m_out, Cout] fp32; all 16-byte aligned.  One launch of grid (gx,
// s, B), gx = ceil((T + 1) / 128) * ceil(Cout / 192), with `smem` bytes of
// dynamic shared memory (ops/dac_kernels.py's plan).  Needs Cin % 64 == 0
// and Cout % 8 == 0.
extern "C" int snake_conv_transpose_streamed(const void* y, const void* w, const void* bias,
                                             void* out, int B, int T, int Cin, int Cout, int s,
                                             int pad, int m_out, int gx, int smem, void* stream) {
  CUtensorMap ya, wb;
  const cuuint64_t a_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)T * Cin * 2};
  const cuuint32_t a_box[3] = {WG_BK, WG_BM, 1};
  cudaError_t e = wg_tensor_map(&ya, y, 3, a_dims, a_strides, a_box);
  if (e != cudaSuccess) return e;
  const cuuint64_t w_dims[2] = {(cuuint64_t)Cout, (cuuint64_t)2 * s * Cin};
  const cuuint64_t w_strides[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t w_box[2] = {64, WG_BK};
  e = wg_tensor_map(&wb, w, 2, w_dims, w_strides, w_box);
  if (e != cudaSuccess) return e;
  static int smem_set = 0;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(polyphase_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  polyphase_wgmma<<<dim3(gx, s, B), WG_THREADS, smem, (cudaStream_t)stream>>>(
      ya, wb, (const float*)bias, (float*)out, T, Cin, Cout, s, pad, m_out);
  return cudaGetLastError();
}
