#!/usr/bin/env python3
"""Times B5's and B13's launches one by one on the card, for this tree's
kernels or another tree's.

    python3 tools/torch_b5_b13_split.py [CSRC_DIR]

B5 (``int8_dense_gelu_quant``) at its two path shapes: mlp_in, a [2070,
1280] bf16 x [1280, 5120] int8 (the second and the split-attention paths),
and the patch embed, [2112, 8192] x [8192, 512] (every serving path); B13
(``int8_mlp``) at the v3 block, [2112, 1280] x [1280, 5120] x [5120, 1280]
in four slabs of 1280 (the third path).  Each launch runs alone through
``chip_smoke.py``'s ``time_ms`` (the card spins while the host queues the
calls; inputs rotated past the 50 MB L2), on the inputs the launch before
it wrote; then each kernel's whole entry.

CSRC_DIR is a ``jatsr_torch/ops/csrc`` (default: this tree's).  A tree
whose ``mlp_full.cu`` still has ``gemm_gelu_slabs`` (B5 as ``quant_rows``,
the ``mma.sync`` ``gemm_gelu`` with its fp32 g and ``requant``; B13 as
``quant_rows_rcp``, ``gemm_gelu_slabs``, ``requant_slabs`` and
``gemm_slabs_dequant``) is reached through shims compiled beside its
sources; this tree through its own C entries (B5: ``dgq_quant`` and the
two passes of ``dgq_passes``; B13: ``mlp_quant``, ``mlp_hidden`` and
``mlp_out``).  Prints one line per launch and a JSON line with the card's
name and power limit.
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

B5_SHAPES = {"mlp_in": (2070, 1280, 5120), "patch": (2112, 8192, 512)}
B13_SHAPE = (2112, 1280, 5120, 1280, 4)  # M, H, N1, N2, slabs
REPS = 100

SHIM = r"""
#include "{dgq}"
#include "{mlp}"
extern "C" int split_quant(const void* a, void* aq, void* s, void* rowmax, int M, int K,
                           void* st) {{
  quant_rows<<<(M + 7) / 8, 256, 0, (cudaStream_t)st>>>((const __nv_bfloat16*)a, (int8_t*)aq,
                                                         (float*)s, (int*)rowmax, M, K);
  return cudaGetLastError();
}}
extern "C" int split_gemm_gelu(const void* aq, const void* wq, const void* ws, const void* b,
                               const void* s, void* g, void* rowmax, int M, int K, int N,
                               void* st) {{
  launch_gemm_gelu(0, true, (cudaStream_t)st, (const int8_t*)aq, (const int8_t*)wq,
                   (const float*)ws, (const float*)b, (const float*)s, (float*)g, (int*)rowmax,
                   M, K, N);
  return cudaGetLastError();
}}
extern "C" int split_requant(const void* g, const void* rowmax, void* gq, void* gs, int M, int N,
                             void* st) {{
  requant<<<M, 256, 0, (cudaStream_t)st>>>((const float*)g, (const int*)rowmax, (int8_t*)gq,
                                           (float*)gs, N);
  return cudaGetLastError();
}}
extern "C" int split_mlp_quant(const void* a, void* aq, void* s, void* rowmax, int n_slabs, int M,
                               int K, void* st) {{
  quant_rows_rcp<<<(M + 7) / 8, 256, 0, (cudaStream_t)st>>>(
      (const __nv_bfloat16*)a, (int8_t*)aq, (float*)s, (int*)rowmax, n_slabs, M, K);
  return cudaGetLastError();
}}
extern "C" int split_mlp_gemm1(const void* aq, const void* w1q, const void* w1s, const void* b1,
                               const void* s, void* g, void* rowmax, int n_slabs, int M, int K,
                               int N1, void* st) {{
  gemm_gelu_slabs<0><<<dim3(N1 / BN, (M + BM - 1) / BM), 128, 0, (cudaStream_t)st>>>(
      (const int8_t*)aq, (const int8_t*)w1q, (const float*)w1s, (const float*)b1,
      (const float*)s, (__nv_bfloat16*)g, (int*)rowmax, N1 / n_slabs, n_slabs, M, K, N1);
  return cudaGetLastError();
}}
extern "C" int split_mlp_requant(const void* g, const void* rowmax, void* gq, void* gs,
                                 int n_slabs, int M, int N1, void* st) {{
  requant_slabs<<<M, 256, 0, (cudaStream_t)st>>>((const __nv_bfloat16*)g, (const int*)rowmax,
                                                 (int8_t*)gq, (float*)gs, N1 / n_slabs, n_slabs,
                                                 N1);
  return cudaGetLastError();
}}
extern "C" int split_mlp_gemm2(const void* gq, const void* w2q, const void* gs, const void* w2s,
                               const void* b2, void* out, int n_slabs, int M, int N1, int N2,
                               void* st) {{
  gemm_slabs_dequant<<<dim3(N2 / BN, (M + BM - 1) / BM), 128, 0, (cudaStream_t)st>>>(
      (const int8_t*)gq, (const int8_t*)w2q, (const float*)gs, (const float*)w2s,
      (const float*)b2, (__nv_bfloat16*)out, N1 / n_slabs, n_slabs, M, N2);
  return cudaGetLastError();
}}
"""


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _shim(csrc, out_dir):
    """The parent's kernels behind plain C entries: one shim that includes
    its ``dense_gelu_quant.cu`` and ``mlp_full.cu`` (both on
    ``int8_gemm.cuh``)."""
    shim = out_dir / "shim_b5_b13.cu"
    shim.write_text(SHIM.format(dgq=csrc / "dense_gelu_quant.cu",
                                mlp=csrc / "mlp_full.cu"))
    so = out_dir / "libshim_b5_b13.so"
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
    old = "gemm_gelu_slabs" in (csrc / "mlp_full.cu").read_text()
    out_dir = _build.BUILD / f"b5_b13_split_{tag}"  # gitignored, as the kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    if old:
        lib = _shim(csrc, out_dir)
    elif tag == "this":
        lib = _build.load("dense_gelu_quant")
        mlp = _build.load("mlp_full")
    else:
        lib = ctypes.CDLL(str(_shim_lib(csrc, out_dir, "dense_gelu_quant")))
        mlp = ctypes.CDLL(str(_shim_lib(csrc, out_dir, "mlp_full")))
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows = []

    def record(name, fn, sets, reps=REPS):
        ms = chip_smoke.time_ms(fn, sets, reps)
        rows.append({"launch": name, "ms": ms})
        print(f"[split] {tag} {name}: {ms:.5f} ms", flush=True)

    def dev(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="cuda")

    f32, s8 = torch.float32, torch.int8

    # ---- B5 --------------------------------------------------------------
    for what, (M, K, N) in B5_SHAPES.items():
        a, w_q, w_s, b = chip_smoke.dense_inputs(torch, M, K, N,
                                                 chip_smoke.SEED + K)
        ws, bb = w_s.reshape(N).contiguous(), b.reshape(N).contiguous()
        aq, s, gq, gs = dev((M, K), s8), dev((M,), f32), dev((M, N), s8), \
            dev((M,), f32)
        name = f"B5 {what} {M}x{K}x{N}"
        if old:
            g, rowmax = dev((M, N), f32), dev((M,), torch.int32)

            def quant(a_):
                assert lib.split_quant(_ptr(a_), _ptr(aq), _ptr(s),
                                       _ptr(rowmax), M, K, st) == 0

            def gemm(aq_, w_):
                assert lib.split_gemm_gelu(_ptr(aq_), _ptr(w_), _ptr(ws),
                                           _ptr(bb), _ptr(s), _ptr(g),
                                           _ptr(rowmax), M, K, N, st) == 0

            def req(g_):
                assert lib.split_requant(_ptr(g_), _ptr(rowmax), _ptr(gq),
                                         _ptr(gs), M, N, st) == 0

            def whole(a_, w_):
                assert lib.dense_gelu_quant(
                    _ptr(a_), _ptr(w_), _ptr(ws), _ptr(bb), _ptr(aq), _ptr(s),
                    _ptr(g), _ptr(rowmax), _ptr(gq), _ptr(gs), M, K, N, 0, 1,
                    st) == 0

            weight = w_q
            record(f"{name} quant_rows", quant, _sets(a))
            quant(a)
            record(f"{name} gemm_gelu (mma.sync, fp32 g)", gemm,
                   _sets(aq, weight))
            gemm(aq, weight)
            record(f"{name} requant", req, _sets(g))
        else:
            part = dev((M, N // 128), f32)

            def quant(a_):
                assert lib.dgq_quant(_ptr(a_), _ptr(aq), _ptr(s), M, K,
                                     st) == 0

            def gemm(aq_, w_, passes):
                assert lib.dgq_passes(_ptr(aq_), _ptr(s), _ptr(w_), _ptr(ws),
                                      _ptr(bb), _ptr(part), _ptr(gq),
                                      _ptr(gs), M, K, N, 0, 1, passes,
                                      st) == 0

            def whole(a_, w_):
                assert lib.dense_gelu_quant(
                    _ptr(a_), _ptr(w_), _ptr(ws), _ptr(bb), _ptr(aq), _ptr(s),
                    _ptr(part), _ptr(gq), _ptr(gs), M, K, N, 0, 1, st) == 0

            weight = w_q.t().contiguous()  # the K-major copy the DiT keeps
            record(f"{name} quant", quant, _sets(a))
            quant(a)
            gsets = _sets(aq, weight)
            record(f"{name} pass 1 (row maxima)",
                   lambda aq_, w_: gemm(aq_, w_, 1), gsets)
            gemm(aq, weight, 1)
            record(f"{name} pass 2 (codes)",
                   lambda aq_, w_: gemm(aq_, w_, 2), gsets)
        record(f"{name} whole entry", whole, _sets(a, weight))
        del a, w_q, weight, aq, gq, gemm, whole
        torch.cuda.empty_cache()

    # ---- B13 -------------------------------------------------------------
    M, H, N1, N2, n_slabs = B13_SHAPE
    a, w1q, w1s, b1 = chip_smoke.dense_inputs(torch, M, H, N1,
                                              chip_smoke.SEED + 13)
    _, w2q, w2s, b2 = chip_smoke.dense_inputs(torch, 1, N1, N2,
                                              chip_smoke.SEED + 14)
    w1s, b1, w2s, b2 = (t.reshape(-1).contiguous() for t in (w1s, b1, w2s, b2))
    aq, s, gq = dev((M, H), s8), dev((M,), f32), dev((M, N1), s8)
    gs, out = dev((M, n_slabs), f32), dev((M, N2), torch.bfloat16)
    name = f"B13 {M}x{H}x{N1}x{N2}"
    if old:
        g, rowmax = dev((M, N1), torch.bfloat16), dev((M, n_slabs),
                                                      torch.int32)

        def quant(a_):
            assert lib.split_mlp_quant(_ptr(a_), _ptr(aq), _ptr(s),
                                       _ptr(rowmax), n_slabs, M, H, st) == 0

        def gemm1(aq_, w_):
            assert lib.split_mlp_gemm1(_ptr(aq_), _ptr(w_), _ptr(w1s),
                                       _ptr(b1), _ptr(s), _ptr(g),
                                       _ptr(rowmax), n_slabs, M, H, N1,
                                       st) == 0

        def req(g_):
            assert lib.split_mlp_requant(_ptr(g_), _ptr(rowmax), _ptr(gq),
                                         _ptr(gs), n_slabs, M, N1, st) == 0

        def gemm2(gq_, w_):
            assert lib.split_mlp_gemm2(_ptr(gq_), _ptr(w_), _ptr(gs),
                                       _ptr(w2s), _ptr(b2), _ptr(out),
                                       n_slabs, M, N1, N2, st) == 0

        def whole(a_, w1_, w2_):
            assert lib.int8_mlp(
                _ptr(a_), _ptr(w1_), _ptr(w1s), _ptr(b1), _ptr(w2_),
                _ptr(w2s), _ptr(b2), _ptr(aq), _ptr(s), _ptr(g), _ptr(rowmax),
                _ptr(gq), _ptr(gs), _ptr(out), M, H, N1, N2, n_slabs, 0,
                st) == 0

        w1, w2 = w1q, w2q
        record(f"{name} quant_rows_rcp", quant, _sets(a))
        quant(a)
        record(f"{name} gemm_gelu_slabs (mma.sync, bf16 g)", gemm1,
               _sets(aq, w1))
        gemm1(aq, w1)
        record(f"{name} requant_slabs", req, _sets(g))
        req(g)
        record(f"{name} gemm_slabs_dequant (mma.sync)", gemm2, _sets(gq, w2))
    else:
        def quant(a_):
            assert mlp.mlp_quant(_ptr(a_), _ptr(aq), _ptr(s), M, H, st) == 0

        def hidden(aq_, w_):
            assert mlp.mlp_hidden(_ptr(aq_), _ptr(s), _ptr(w_), _ptr(w1s),
                                  _ptr(b1), _ptr(gq), _ptr(gs), M, H, N1,
                                  n_slabs, 0, st) == 0

        def second(gq_, w_):
            assert mlp.mlp_out(_ptr(gq_), _ptr(gs), _ptr(w_), _ptr(w2s),
                               _ptr(b2), _ptr(out), M, N1, N2, n_slabs,
                               st) == 0

        def whole(a_, w1_, w2_):
            assert mlp.int8_mlp(
                _ptr(a_), _ptr(w1_), _ptr(w1s), _ptr(b1), _ptr(w2_),
                _ptr(w2s), _ptr(b2), _ptr(aq), _ptr(s), _ptr(gq), _ptr(gs),
                _ptr(out), M, H, N1, N2, n_slabs, 0, st) == 0

        w1, w2 = w1q.t().contiguous(), w2q.t().contiguous()  # K-major
        record(f"{name} quant", quant, _sets(a))
        quant(a)
        record(f"{name} hidden (first product, GELU, slab codes)", hidden,
               _sets(aq, w1))
        hidden(aq, w1)
        record(f"{name} second product", second, _sets(gq, w2))
    record(f"{name} whole entry", whole, _sets(a, w1, w2))
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "card": chip_smoke.card_line(),
                      "launches": rows}))
    return 0


def _shim_lib(csrc, out_dir, name):
    """Another tree's ``name.cu`` (new kernels) built as it is."""
    so = out_dir / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(so), str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    return so


if __name__ == "__main__":
    sys.exit(main())
