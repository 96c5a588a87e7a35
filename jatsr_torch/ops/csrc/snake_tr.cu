// snake -> ConvTranspose1d (K = 2s) by the polyphase identity, for Hopper.
//
// Replaces the TPU kernel snake_conv_transpose_fused (_snake_tr_kernel, B7)
// in the JAX package's ops/dac_kernels.py.  It computes
//   flat[t*s + p] = y[t] @ w[p] + y[t-1] @ w[p+s] + b,   y = bf16(snake(x, a))
//   out[m]        = flat[m + pad],  m in [0, m_out)
// with bf16 products summed in fp32 and y zero outside [0, T).  (B8, the
// same product on stage 0's pre-snaked input, is snake_tr_stream.cu, on
// bf16_wgmma.cuh.)
//
// What bounds it on the H100, at one 2884-frame decode segment: stage 1
// (768 -> 384, s 8, T 23,072) is 2.18e11 bf16 operations (0.22 ms at 989
// TFLOP/s); stages 2 and 3 (s 4 and 2) move 0.85 and 1.13 GB (0.25, 0.34
// ms at 3.35 TB/s).
//
// Design.  A first pass snakes x into a bf16 y.  For phase p the output rows
// m = t*s + p - pad form one GEMM over the input times t in [0, T] with
// depth 2 Cin: A is [y[t], y[t-1]], B is
// [w[p]; w[p+s]] read in place from the [2s, Cin, Cout] weight (bf16_gemm.cuh,
// taps 2, shift_step -1).  The epilogue adds the bias and writes out[m]
// directly, dropping rows outside [0, m_out): no flat buffer, no slice, no
// channel padding.  Grid: (row tiles x column tiles, phase, batch).

#include "bf16_gemm.cuh"

namespace {

__global__ void __launch_bounds__(256) snake_rows(const float* __restrict__ x,
                                                  const float* __restrict__ a,
                                                  __nv_bfloat16* __restrict__ y, size_t n, int C) {
  snake_pass(x, a, y, n, C, (size_t)blockIdx.x * blockDim.x + threadIdx.x,
             (size_t)gridDim.x * blockDim.x);
}

__global__ void __launch_bounds__(NT) polyphase_kernel(const __nv_bfloat16* __restrict__ y,
                                                       const __nv_bfloat16* __restrict__ w,
                                                       const float* __restrict__ bias,
                                                       float* __restrict__ out, int T, int Cin,
                                                       int Cout, int s, int pad, int m_out) {
  __shared__ __align__(16) GemmSmem sm;
  const int p = blockIdx.y, b = blockIdx.z;
  const int ntiles = (Cout + BN - 1) / BN;
  const int mt = blockIdx.x / ntiles, nt = blockIdx.x % ntiles;
  const Gemm g{y, w + (size_t)p * Cin * Cout, (long long)s * Cin * Cout, T, Cin, Cout, T + 1, 2,
               0, -1};
  gemm_tile(g, b, mt * BM, nt * BN, sm, [&](int bb, int t, int n, float v0, float v1) {
    const int m = t * s + p - pad;
    if (m < 0 || m >= m_out) return;
    *reinterpret_cast<float2*>(out + ((size_t)bb * m_out + m) * Cout + n) =
        make_float2(__fadd_rn(v0, bias[n]), __fadd_rn(v1, bias[n + 1]));
  });
}

}  // namespace

// x [B, T, Cin] fp32, alpha [Cin], y [B, T, Cin] bf16 scratch, w [2s,
// Cin, Cout] bf16, bias [Cout] fp32 -> out [B, m_out, Cout] fp32.  Needs
// Cin % 8 == 0 and Cout % 8 == 0 (the wrapper checks).
extern "C" int snake_conv_transpose(const void* x, const void* alpha, void* y, const void* w,
                                    const void* bias, void* out, int B, int T, int Cin, int Cout,
                                    int s, int pad, int m_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)B * T * Cin;
  const size_t blocks = (n / 4 + 255) / 256;
  snake_rows<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, st>>>(
      (const float*)x, (const float*)alpha, (__nv_bfloat16*)y, n, Cin);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int ntiles = (Cout + BN - 1) / BN;
  const dim3 grid(((T + 1 + BM - 1) / BM) * ntiles, s, B);
  polyphase_kernel<<<grid, NT, 0, st>>>((const __nv_bfloat16*)y, (const __nv_bfloat16*)w,
                                        (const float*)bias, (float*)out, T, Cin, Cout, s, pad,
                                        m_out);
  return cudaGetLastError();
}
