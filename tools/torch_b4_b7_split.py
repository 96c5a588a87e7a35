#!/usr/bin/env python3
"""Times B4's and B7's launches one by one on the card, for this tree's
kernels or another tree's.

    python3 tools/torch_b4_b7_split.py [CSRC_DIR]

B4 (``int8_matmul_fused``, the out projection) at the main path's shape,
a [2112, 1280] bf16 x [1280, 1280] int8; B7 (``snake_conv_transpose_fused``)
at the three decoder stages of one 2884-frame decode segment: Cin 768 ->
384 (s 8, T 23,072), 384 -> 192 (s 4, T 184,576), 192 -> 96 (s 2, T
738,304), batch 1.  Each launch runs alone through ``chip_smoke.py``'s
``time_ms`` (the card spins while the host queues the calls; inputs rotated
past the 50 MB L2), on the inputs the launch before it wrote; then each
kernel's whole entry.

CSRC_DIR is a ``jatsr_torch/ops/csrc`` (default: this tree's).  A tree
without ``w8a8_fused.cu`` (B4 as ``quant_rows`` and the ``mma.sync``
``gemm_dequant`` of ``matmul_fused.cu``) and whose ``snake_tr.cu`` has no
``snake_conv_transpose_rows`` (B7 as a snake pass and the ``mma.sync``
``polyphase_kernel``) is reached through shims compiled beside its
sources; this tree through its own C entries (B4: ``w8a8_quant``,
``w8a8_gemm``, then both with the GEMM overlapping the quant's tail; B7: stage 1's ``snake_b16`` and B8's kernel, stages 2 and
3 the one launch of ``snake_tr_rows``).  Prints one line per launch and a
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from jatsr_torch.ops import _build  # noqa: E402
from jatsr_torch.ops import dac_kernels as dk  # noqa: E402

M, K, N = 2112, 1280, 1280
STAGES = [(768, 384, 8, 23_072), (384, 192, 4, 184_576), (192, 96, 2, 738_304)]
REPS, DAC_REPS = 200, 20

SHIM_B4 = r"""
#include "{src}"
extern "C" int split_quant(const void* a, void* aq, void* s, int M, int K, void* st) {{
  quant_rows<<<(M + 7) / 8, 256, 0, (cudaStream_t)st>>>((const __nv_bfloat16*)a, (int8_t*)aq,
                                                         (float*)s, nullptr, M, K);
  return cudaGetLastError();
}}
extern "C" int split_gemm(const void* aq, const void* s, const void* wq, const void* ws,
                          void* out, int M, int K, int N, void* st) {{
  gemm_dequant<false><<<dim3(N / BN, (M + BM - 1) / BM), 128, 0, (cudaStream_t)st>>>(
      (const int8_t*)aq, (const int8_t*)wq, (const float*)ws, nullptr, (const float*)s,
      (__nv_bfloat16*)out, M, K, N);
  return cudaGetLastError();
}}
"""

SHIM_B7 = r"""
#include "{src}"
extern "C" int split_snake(const void* x, const void* a, void* y, long long n, int C, void* st) {{
  const size_t blocks = ((size_t)n / 4 + 255) / 256;
  snake_rows<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, (cudaStream_t)st>>>(
      (const float*)x, (const float*)a, (__nv_bfloat16*)y, (size_t)n, C);
  return cudaGetLastError();
}}
extern "C" int split_poly(const void* y, const void* w, const void* b, void* out, int B, int T,
                          int Cin, int Cout, int s, int pad, int m_out, void* st) {{
  const int ntiles = (Cout + BN - 1) / BN;
  const dim3 grid(((T + 1 + BM - 1) / BM) * ntiles, s, B);
  polyphase_kernel<<<grid, NT, 0, (cudaStream_t)st>>>(
      (const __nv_bfloat16*)y, (const __nv_bfloat16*)w, (const float*)b, (float*)out, T, Cin,
      Cout, s, pad, m_out);
  return cudaGetLastError();
}}
"""


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _shim(text, src, csrc, out_dir, name):
    """A shared library of ``text`` (a shim that includes ``src``)."""
    shim = out_dir / f"{name}.cu"
    shim.write_text(text.format(src=src))
    so = out_dir / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(so), str(shim)], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(so))


def _sets(*tensors):
    """Copies of ``tensors`` that together exceed the L2."""
    n = chip_smoke.rotations(sum(t.nbytes for t in tensors))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else _build.CSRC
    tag = "parent" if csrc != _build.CSRC else "this"
    new_b4 = (csrc / "w8a8_fused.cu").exists()
    new_b7 = "snake_conv_transpose_rows" in (csrc / "snake_tr.cu").read_text()
    # A tree whose B7 entries take the snake mode (0: fp32) before the stream.
    mode = (0,) if "int b16" in (csrc / "snake_tr.cu").read_text() else ()
    out_dir = _build.BUILD / f"b4_b7_split_{tag}"  # gitignored, as the kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows = []

    def record(name, fn, sets, reps):
        ms = chip_smoke.time_ms(fn, sets, reps)
        rows.append({"launch": name, "ms": ms})
        print(f"[split] {tag} {name}: {ms:.5f} ms", flush=True)

    # ---- B4 --------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                        dtype=torch.int8)
    ws = (torch.rand((N,), generator=gen, device="cuda") + 0.5) / (127 * K ** 0.5)
    aq = torch.empty((M, K), dtype=torch.int8, device="cuda")
    s = torch.empty((M,), dtype=torch.float32, device="cuda")
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    if new_b4:
        lib = (_build.load("w8a8_fused") if tag == "this"
               else _shim('#include "{src}"\n', csrc / "w8a8_fused.cu", csrc,
                          out_dir, "w8a8_fused"))

        def quant(a_, aq_, s_):
            assert lib.w8a8_quant(_ptr(a_), _ptr(aq_), _ptr(s_), M, K,
                                  stream) == 0

        def gemm(aq_, s_, w_):
            assert lib.w8a8_gemm(_ptr(aq_), _ptr(s_), _ptr(w_), _ptr(ws),
                                 _ptr(out), M, K, N, stream) == 0

        def whole(a_, w_):
            assert lib.w8a8_fused(_ptr(a_), _ptr(w_), _ptr(ws), _ptr(aq),
                                  _ptr(s), _ptr(out), M, K, N, stream) == 0

        weight = w_q.t().contiguous()  # the K-major copy the DiT keeps
    else:
        lib = _shim(SHIM_B4, csrc / "matmul_fused.cu", csrc, out_dir,
                    "shim_b4")

        def quant(a_, aq_, s_):
            assert lib.split_quant(_ptr(a_), _ptr(aq_), _ptr(s_), M, K,
                                   stream) == 0

        def gemm(aq_, s_, w_):
            assert lib.split_gemm(_ptr(aq_), _ptr(s_), _ptr(w_), _ptr(ws),
                                  _ptr(out), M, K, N, stream) == 0

        def whole(a_, w_):
            assert lib.matmul_fused(_ptr(a_), _ptr(w_), _ptr(ws), _ptr(aq),
                                    _ptr(s), _ptr(out), M, K, N, stream) == 0

        weight = w_q
    record("B4 quant", quant, _sets(a, aq, s), REPS)
    quant(a, aq, s)
    gsets = _sets(aq, s, weight)
    record("B4 GEMM", gemm, gsets, REPS)
    if new_b4:
        record("B4 quant + GEMM, overlapped",
               lambda a_, w_: whole(a_, w_), _sets(a, weight), REPS)
    else:
        record("B4 whole entry", whole, _sets(a, weight), REPS)

    # ---- B7 --------------------------------------------------------------
    if new_b7:
        tr = (_build.load("snake_tr") if tag == "this"
              else _shim('#include "{src}"\n', csrc / "snake_tr.cu", csrc,
                         out_dir, "snake_tr"))
        st = (_build.load("snake_tr_stream") if tag == "this"
              else _shim('#include "{src}"\n', csrc / "snake_tr_stream.cu",
                         csrc, out_dir, "snake_tr_stream"))
    else:
        tr = _shim(SHIM_B7, csrc / "snake_tr.cu", csrc, out_dir, "shim_b7")
    for ci, co, stride, T in STAGES:
        x, w, b, al = chip_smoke.transpose_inputs(torch, 1, T, ci, co, stride,
                                                  chip_smoke.SEED + ci)
        pad, op = (stride + 1) // 2, stride % 2
        m_out = (T - 1) * stride - 2 * pad + 2 * stride + op
        y = torch.empty((1, T, ci), dtype=torch.bfloat16, device="cuda")
        o = torch.empty((1, m_out, co), dtype=torch.float32, device="cuda")
        name = f"B7 {ci}->{co} s{stride}"
        xsets = [(t,) for t in (x.clone() for _ in range(
            chip_smoke.rotations(x.nbytes)))]
        if not new_b7:
            def snake(x_):
                assert tr.split_snake(_ptr(x_), _ptr(al), _ptr(y),
                                      ctypes.c_longlong(x_.numel()), ci,
                                      stream) == 0

            def poly(y_):
                assert tr.split_poly(_ptr(y_), _ptr(w), _ptr(b), _ptr(o), 1, T,
                                     ci, co, stride, pad, m_out, stream) == 0

            record(f"{name} snake pass", snake, xsets, DAC_REPS)
            snake(x)
            record(f"{name} polyphase GEMM (mma.sync)", poly,
                   [(t,) for t in (y.clone() for _ in range(
                       chip_smoke.rotations(y.nbytes)))], DAC_REPS)
            continue
        plan = dk._tr_plan(1, T, ci, co, stride, dk._sm_count(0))
        if plan.route == "stream":
            sp = plan.stream

            def snake(x_):
                assert tr.snake_b16(_ptr(x_), _ptr(al), _ptr(y),
                                    ctypes.c_longlong(x_.numel()), ci,
                                    plan.snake_blocks, *mode, stream) == 0

            def poly(y_):
                assert st.snake_conv_transpose_streamed(
                    _ptr(y_), _ptr(w), _ptr(b), _ptr(o), 1, T, ci, co, stride,
                    pad, m_out, sp.grid[0], sp.smem, stream) == 0

            record(f"{name} snake pass", snake, xsets, DAC_REPS)
            snake(x)
            record(f"{name} polyphase GEMM (B8's wgmma kernel)", poly,
                   [(t,) for t in (y.clone() for _ in range(
                       chip_smoke.rotations(y.nbytes)))], DAC_REPS)
            continue

        def rows_launch(x_):
            assert tr.snake_conv_transpose_rows(
                _ptr(x_), _ptr(al), _ptr(w), _ptr(b), _ptr(o), 1, T, ci, co,
                stride, pad, m_out, plan.bn, plan.threads, plan.stages,
                plan.xbufs, plan.xc, plan.grid, plan.smem, *mode,
                stream) == 0

        record(f"{name} one launch (snake_tr_rows)", rows_launch, xsets,
               DAC_REPS)
        del x, xsets, y, o
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "card": chip_smoke.card_line(),
                      "launches": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
