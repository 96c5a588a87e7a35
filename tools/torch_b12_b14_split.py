#!/usr/bin/env python3
"""Times B12's and B14's launches one by one on the card, for this tree's
kernels or another tree's.

    python3 tools/torch_b12_b14_split.py [CSRC_DIR]

B14 (``int8_matmul`` behind ``w8a8_dot(impl="pallas")``) at the v3 qkv
product, [2112, 1280] bf16 x [1280, 1792] int8: the quantisation in front
of it, the GEMM, and both; B12 (``gqa_attention_flash_out``) at the third
path's shape, qkv [6, 352, 1792] (20/4 heads, head dim 64, keys masked past
345) and a [1280, 1280] out projection with a bias: the attention, the row
quant, the GEMM, and the whole entry.  Each launch runs alone through
``chip_smoke.py``'s ``time_ms`` (the card spins while the host queues the
calls; inputs rotated past the 50 MB L2), on the inputs the launch before
it wrote.

CSRC_DIR is a ``jatsr_torch/ops/csrc`` (default: this tree's).  A tree
whose ``flash_qkv.cu`` still runs ``gemm_dequant`` (the ``mma.sync`` GEMM
of ``int8_gemm.cuh``) quantises B14's A in torch ops, as its ``w8a8_dot``
did, and runs ``matmul_fused.cu``'s ``matmul_prequant`` on the weight
[K, N], and B12's ``quant_rows`` (two reads of a row) and ``gemm_dequant``;
this tree runs ``w8a8_fused.cu``'s ``prequant_quant`` and
``matmul_prequant`` (the s8 ``wgmma`` GEMM on the weight K-major, alone and
under programmatic stream serialisation behind the quant), and B12's
``quant_rows_v`` and the same GEMM with the bias.  B12's launches are
reached through a shim compiled beside the tree's ``flash_qkv.cu``.
Prints one line per launch and a JSON line with the card's name and power
limit.
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

B14_SHAPE = (2112, 1280, 1792)                  # M, K, N
B12_SHAPE = (6, 352, 345, 20, 4, 64, 1280)      # B, N, n_valid, hq, hkv, D, H
REPS = 100

SHIM = r"""
#include "{src}"
extern "C" int split_attention(const void* q, const void* k, const void* v,
                               const NaturalPlan* plan, const float* cos_t,
                               const float* sin_t, void* o, int B, int gx, int gy,
                               int warps, int smem, void* st) {{
  return attention<64>(q, k, v, o, *plan, RopeTables{{cos_t, sin_t}}, dim3(gx, gy, B), warps,
                       smem, (cudaStream_t)st);
}}
{parts}
"""

OLD_PARTS = r"""
extern "C" int split_quant(const void* o, void* oq, void* so, int M, int K, void* st) {
  quant_rows<<<(M + 7) / 8, 256, 0, (cudaStream_t)st>>>((const __nv_bfloat16*)o, (int8_t*)oq,
                                                         (float*)so, nullptr, M, K);
  return cudaGetLastError();
}
extern "C" int split_gemm(const void* oq, const void* so, const void* wo, const void* wos,
                          const void* bo, void* out, int M, int K, int H, void* st) {
  gemm_dequant<true><<<dim3(H / BN, (M + BM - 1) / BM), 128, 0, (cudaStream_t)st>>>(
      (const int8_t*)oq, (const int8_t*)wo, (const float*)wos, (const float*)bo,
      (const float*)so, (__nv_bfloat16*)out, M, K, H);
  return cudaGetLastError();
}
"""

NEW_PARTS = r"""
extern "C" int split_quant(const void* o, void* oq, void* so, int M, int K, void* st) {
  return launch_quant_rows<false>(o, oq, so, M, K, (cudaStream_t)st);
}
extern "C" int split_gemm(const void* oq, const void* so, const void* wo_t, const void* wos,
                          const void* bo, void* out, int M, int K, int H, void* st) {
  return flash_out_gemm(oq, so, wo_t, wos, bo, out, M, K, H, st);
}
"""


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _build_so(src: Path, csrc: Path, so: Path) -> ctypes.CDLL:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(so), str(src)], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(so))


def _sets(*tensors):
    """Copies of ``tensors`` that together exceed the L2."""
    n = chip_smoke.rotations(sum(t.nbytes for t in tensors))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def main() -> int:
    import torch

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (_deferred_plan, _natural_args,
                                           _qkv_views, _scale2_bf16,
                                           _sm_count, flash_out_weight_t)
    from jatsr_torch.ops.int8_matmul import _INV127

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else _build.CSRC
    tag = "parent" if csrc != _build.CSRC else "this"
    old = "gemm_dequant" in (csrc / "flash_qkv.cu").read_text()
    out_dir = _build.BUILD / f"b12_b14_split_{tag}"  # gitignored, as the kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    shim = out_dir / "shim_b12.cu"
    shim.write_text(SHIM.format(src=csrc / "flash_qkv.cu",
                                parts=OLD_PARTS if old else NEW_PARTS))
    fl = _build_so(shim, csrc, out_dir / "libshim_b12.so")
    mm = _build_so(csrc / ("matmul_fused.cu" if old else "w8a8_fused.cu"),
                   csrc, out_dir / "libb14.so")
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows = []

    def record(name, fn, sets, reps=REPS):
        ms = chip_smoke.time_ms(fn, sets, reps)
        rows.append({"launch": name, "ms": ms})
        print(f"[split] {tag} {name}: {ms:.5f} ms", flush=True)

    def dev(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="cuda")

    f32, s8, bf16 = torch.float32, torch.int8, torch.bfloat16

    # ---- B14 -------------------------------------------------------------
    M, K, N = B14_SHAPE
    a, w_q, w_s, _ = chip_smoke.dense_inputs(torch, M, K, N,
                                             chip_smoke.SEED + 15)
    ws = w_s.reshape(N).contiguous()
    aq, s = dev((M, K), s8), dev((M,), f32)
    out, out32 = dev((M, N), bf16), dev((M, N), f32)
    weight = w_q if old else w_q.t().contiguous()  # the copy the GEMM reads
    name = f"B14 {M}x{K}x{N}"
    if old:
        def quant(a_):
            sc = a_.abs().amax(dim=-1, keepdim=True).float() * _INV127
            aq.copy_(torch.round(a_.float() / sc.clamp_min(1e-12)).to(s8))
            s.copy_(sc.reshape(M))

        def gemm(aq_, w_, pdl=0):
            assert mm.matmul_prequant(_ptr(aq_), _ptr(s), _ptr(w_), _ptr(ws),
                                      _ptr(out), M, K, N, st) == 0

        qname, gname = "quant (torch ops)", "matmul_prequant (mma.sync)"
    else:
        def quant(a_):
            assert mm.prequant_quant(_ptr(a_), _ptr(aq), _ptr(s), M, K,
                                     st) == 0

        def gemm(aq_, w_, pdl=0, o=out, f32_out=0):
            assert mm.matmul_prequant(_ptr(aq_), _ptr(s), _ptr(w_), _ptr(ws),
                                      _ptr(o), M, K, N, f32_out, pdl,
                                      st) == 0

        qname, gname = "prequant_quant", "matmul_prequant (s8 wgmma)"
    record(f"{name} {qname}", quant, _sets(a))
    quant(a)
    gsets = _sets(aq, weight)
    record(f"{name} {gname}", gemm, gsets)
    if not old:
        record(f"{name} {gname}, fp32 out",
               lambda aq_, w_: gemm(aq_, w_, o=out32, f32_out=1), gsets)

    def whole(a_, w_):
        quant(a_)
        gemm(aq, w_, pdl=1)

    record(f"{name} quant + GEMM", whole, _sets(a, weight))
    del a, w_q, weight, aq, out, out32
    torch.cuda.empty_cache()

    # ---- B12 -------------------------------------------------------------
    B, Np, n_valid, hq, hkv, D, H = B12_SHAPE
    M, K = B * Np, hq * D
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 11)
    qkv = torch.randn((B, Np, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(Np, D, device="cuda")
    _, wo_q, wo_s, bo = chip_smoke.dense_inputs(torch, 1, K, H,
                                                chip_smoke.SEED + 12)
    wos, bb = wo_s.reshape(H).contiguous(), bo.reshape(H).contiguous()
    wo = wo_q if old else flash_out_weight_t(wo_q, hq, D)
    plan = _deferred_plan(Np, hq, hkv, D, B, _sm_count(0), n_valid, False)
    gx, gy, gz = plan.launch_grid(B)
    o, oq, so = dev((M, K), bf16), dev((M, K), s8), dev((M,), f32)
    out = dev((M, H), bf16)
    name = f"B12 qkv {B}x{Np}x{(hq + 2 * hkv) * D}, wo {K}x{H}"

    def views(x):
        q, k, v, c, sn = _qkv_views(x, cos, sin, hq, hkv)
        args = _natural_args(plan, q.stride(1), k.stride(1), v.stride(1),
                             _scale2_bf16(D))
        return q, k, v, c, sn, args

    def attention(x):
        q, k, v, c, sn, args = views(x)
        assert fl.split_attention(
            _ptr(q), _ptr(k), _ptr(v), ctypes.byref(args), _ptr(c), _ptr(sn),
            _ptr(o), gz, gx, gy, plan.warps, plan.smem, st) == 0

    def quant(o_):
        assert fl.split_quant(_ptr(o_), _ptr(oq), _ptr(so), M, K, st) == 0

    def gemm(oq_, w_):
        assert fl.split_gemm(_ptr(oq_), _ptr(so), _ptr(w_), _ptr(wos),
                             _ptr(bb), _ptr(out), M, K, H, st) == 0

    def whole(x, w_):
        q, k, v, c, sn, args = views(x)
        assert fl.flash_out(
            _ptr(q), _ptr(k), _ptr(v), ctypes.byref(args), _ptr(c), _ptr(sn),
            _ptr(w_), _ptr(wos), _ptr(bb), _ptr(o), _ptr(oq), _ptr(so),
            _ptr(out), D, gz, gx, gy, plan.warps, plan.smem, H, st) == 0

    record(f"{name} attention", attention, _sets(qkv))
    attention(qkv)
    record(f"{name} {'quant_rows' if old else 'quant_rows_v'}", quant,
           _sets(o))
    quant(o)
    record(f"{name} {'gemm_dequant (mma.sync)' if old else 'GEMM (s8 wgmma)'}",
           gemm, _sets(oq, wo))
    record(f"{name} whole entry", whole, _sets(qkv, wo))
    torch.cuda.synchronize()
    print(json.dumps({"tree": tag, "card": chip_smoke.card_line(),
                      "launches": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
