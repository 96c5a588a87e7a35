#!/usr/bin/env python3
"""Times B1's and B3's launches one by one on the card, for this tree's
``csrc/norm_mod.cu`` or another tree's.

    python3 tools/torch_prologue_split.py [CSRC_DIR]

B3 (``int8_norm_mod_dot``, qkv) and B1 (``int8_norm_mod_dense_gelu_quant``,
mlp_in) at the main path's shapes, x [6, 352, 1280] (M = 2112) and the
weights [1280, 1792] and [1280, 5120], layer norm, the sampler's shared
AdaLN row.  Each launch runs alone through ``chip_smoke.py``'s ``time_ms``
(the card spins while the host queues the calls; inputs rotated past the
50 MB L2), on the inputs the launch before it wrote.

CSRC_DIR is a ``jatsr_torch/ops/csrc`` (default: this tree's).  A tree
whose ``norm_mod.cu`` still has the ``mma.sync`` path (``requant``, the
fp32 g scratch) is reached through a shim compiled beside it that exposes
its four launches (prologue, ``gemm_dequant``, ``gemm_gelu``, ``requant``);
a tree on ``s8_wgmma.cuh`` through its own C entries (prologue, B3's
GEMM, B1's two passes).  Prints one line per launch and a JSON line with
the card's name and power limit.
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

M, NP, H = 2112, 352, 1280
N_QKV, N_MLP = 1792, 5120
REPS = 200

SHIM = r"""
#include "{src}"
extern "C" int split_prologue(const void* x, const void* sc, const void* sh, int ms, int np,
                              void* aq, void* s, void* rowmax, int M, int H, void* st) {{
  return launch_prologue(x, sc, sh, ms, np, aq, s, rowmax, M, H, 0, (cudaStream_t)st);
}}
extern "C" int split_dequant(const void* aq, const void* wq, const void* ws, const void* b,
                             const void* s, void* out, int M, int K, int N, void* st) {{
  gemm_dequant<true><<<dim3(N / BN, (M + BM - 1) / BM), 128, 0, (cudaStream_t)st>>>(
      (const int8_t*)aq, (const int8_t*)wq, (const float*)ws, (const float*)b, (const float*)s,
      (__nv_bfloat16*)out, M, K, N);
  return cudaGetLastError();
}}
extern "C" int split_gelu(const void* aq, const void* wq, const void* ws, const void* b,
                          const void* s, void* g, void* rowmax, int M, int K, int N, void* st) {{
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
"""


def _inputs(torch, N, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn((M, H), generator=gen, device="cuda") + 0.3).bfloat16()
    sc, sh = (0.5 * torch.randn((2, 1, H), generator=gen, device="cuda")
              ).bfloat16().float()
    w_q = torch.randint(-127, 128, (H, N), generator=gen, device="cuda",
                        dtype=torch.int8)
    ws = (torch.rand((N,), generator=gen, device="cuda") + 0.5) / (127 * H ** 0.5)
    b = 0.1 * torch.randn((N,), generator=gen, device="cuda")
    return x, sc, sh, w_q, ws, b


def _sets(tensors):
    """Copies of ``tensors`` that together exceed the L2."""
    n = chip_smoke.rotations(sum(t.nbytes for t in tensors))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else _build.CSRC
    src = csrc / "norm_mod.cu"
    old = "requant<<<" in src.read_text()
    out_dir = _build.BUILD / "prologue_split"  # gitignored, as the kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "parent" if csrc != _build.CSRC else "this"
    if old:
        shim = out_dir / f"shim_{tag}.cu"
        shim.write_text(SHIM.format(src=src))
        so = out_dir / f"libshim_{tag}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                        "-o", str(so), str(shim)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
    else:
        lib = _build.load("norm_mod")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows = []

    def record(name, fn, sets):
        ms = chip_smoke.time_ms(fn, sets, REPS)
        rows.append({"launch": name, "ms": ms})
        print(f"[split] {tag} {name}: {ms:.5f} ms", flush=True)

    for N, seed in ((N_QKV, 1), (N_MLP, 2)):
        x, sc, sh, w_q, ws, b = _inputs(torch, N, seed)
        aq = torch.empty((M, H), dtype=torch.int8, device="cuda")
        s = torch.empty((M,), dtype=torch.float32, device="cuda")
        rowmax = torch.zeros((M,), dtype=torch.int32, device="cuda")
        w_t = w_q.t().contiguous()

        def prologue(x_, aq_, s_):
            if old:
                err = lib.split_prologue(_ptr(x_), _ptr(sc), _ptr(sh), 0, NP,
                                         _ptr(aq_), _ptr(s_), _ptr(rowmax),
                                         M, H, stream)
            else:
                err = lib.norm_mod_prologue(_ptr(x_), _ptr(sc), _ptr(sh), 0,
                                            NP, _ptr(aq_), _ptr(s_), M, H, 0,
                                            stream)
            assert err == 0, err

        psets = _sets([x, aq, s])
        record(f"prologue N={N}", prologue, psets)
        prologue(x, aq, s)
        gsets = [(a.clone(), s_.clone(), w.clone(), w2.clone())
                 for a, s_, w, w2 in [(aq, s, w_q, w_t)] *
                 chip_smoke.rotations(aq.nbytes + w_q.nbytes)]
        if N == N_QKV:
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")

            def dot(aq_, s_, wq_, wt_):
                if old:
                    err = lib.split_dequant(_ptr(aq_), _ptr(wq_), _ptr(ws),
                                            _ptr(b), _ptr(s_), _ptr(out), M,
                                            H, N, stream)
                else:
                    err = lib.s8_dot(_ptr(aq_), _ptr(s_), _ptr(wt_), _ptr(ws),
                                     _ptr(b), _ptr(out), M, H, N, stream)
                assert err == 0, err

            record("B3 GEMM + dequant", dot, gsets)
            continue
        gq = torch.empty((M, N), dtype=torch.int8, device="cuda")
        gs = torch.empty((M,), dtype=torch.float32, device="cuda")
        if old:
            g = torch.empty((M, N), dtype=torch.float32, device="cuda")

            def gelu(aq_, s_, wq_, wt_):
                assert lib.split_gelu(_ptr(aq_), _ptr(wq_), _ptr(ws), _ptr(b),
                                      _ptr(s_), _ptr(g), _ptr(rowmax), M, H,
                                      N, stream) == 0

            record("B1 GEMM + GELU (fp32 g out)", gelu, gsets)
            gelu(*gsets[0])
            rsets = [(g.clone(),) for _ in range(chip_smoke.rotations(g.nbytes))]

            def req(g_):
                assert lib.split_requant(_ptr(g_), _ptr(rowmax), _ptr(gq),
                                         _ptr(gs), M, N, stream) == 0

            record("B1 requant", req, rsets)
        else:
            part = torch.empty((M, N // 128), dtype=torch.float32,
                               device="cuda")
            for passes, name in ((1, "B1 pass 1 (row max)"),
                                 (2, "B1 pass 2 (codes)")):
                def gelu(aq_, s_, wq_, wt_, passes=passes):
                    assert lib.s8_gelu_quant(
                        _ptr(aq_), _ptr(s_), _ptr(wt_), _ptr(ws), _ptr(b),
                        _ptr(part), _ptr(gq), _ptr(gs), M, H, N, 0, passes,
                        stream) == 0

                record(name, gelu, gsets)
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "card": chip_smoke.card_line(),
                      "launches": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
