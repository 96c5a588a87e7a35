#!/usr/bin/env python3
"""Times the attention body at N = 1000 with CTAs of at most 16 warps (the
committed build) against CTAs of at most 15, on one card.

    python3 tools/torch_attention_warps.py

At N in (896, 1024] a row group holds eight warps of 128 keys, so a
15-warp CTA holds one (row group, head) pair and a 16-warp CTA two: twice
the rows over each K and V load, at 128 registers a thread (16 x 32 x 128
is the SM's whole register file, where 15 warps leave ptxas up to 136).
The 15-warp build is a copy of ``csrc/attention_natural.cu`` and
``csrc/attention_deferred.cu`` with ``MAX_WARPS`` 15, built into
``jatsr_torch/ops/build/warps15/``; its plans are the committed plans with
``_NATURAL_WARPS`` 15.  For B16 (v3's 20/4 heads), B2 and B11 (v1's 8/4,
B2's keys masked past 997) at batch 6, it prints each build's ms per call
(CUDA events over 50 calls on one input set, the card spinning while the
calls queue), whether the two outputs are bit-equal (no row's arithmetic depends
on the pairs a CTA holds), and the 15-warp build's registers and spills.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from jatsr_torch.models.dit import rope_cos_sin  # noqa: E402
from jatsr_torch.ops import _build  # noqa: E402
from jatsr_torch.ops import attention as A  # noqa: E402

B, N = 6, 1000


def build15():
    """The two sources with MAX_WARPS 15, built side by side: their
    libraries, C types set."""
    out = _build.BUILD / "warps15"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    rows = (out / "attention_rows.cuh").read_text()
    old = "constexpr int MAX_WARPS = 16;"
    assert old in rows
    (out / "attention_rows.cuh").write_text(
        rows.replace(old, "constexpr int MAX_WARPS = 15;"))
    libs = {}
    for name in ("attention_natural", "attention_deferred"):
        shutil.copy(_build.CSRC / f"{name}.cu", out / f"{name}.cu")
        so = out / f"lib{name}.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(out / f"{name}.cu")], capture_output=True,
                           text=True, check=True)
        for kernel, regs, spills in chip_smoke.build_report(r.stdout
                                                            + r.stderr):
            if "<64" in kernel:
                print(f"[warps15 build] {name}: {kernel}: {regs} registers, "
                      f"{spills or 'no spills'}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    libs["attention_natural"].attention_natural.restype = ctypes.c_int
    libs["attention_natural"].attention_natural.argtypes = \
        A._natural_lib().attention_natural.argtypes
    libs["attention_deferred"].attention_deferred.restype = ctypes.c_int
    libs["attention_deferred"].attention_deferred.argtypes = \
        A._deferred_lib().attention_deferred.argtypes
    return libs


def use(warps, libs):
    """Point the wrappers at a build and its plans."""
    A._NATURAL_WARPS = warps
    A._natural_plan.cache_clear()
    A._deferred_plan.cache_clear()
    A._natural_lib = (lambda: libs["attention_natural"]) if libs else \
        _committed[0]
    A._deferred_lib = (lambda: libs["attention_deferred"]) if libs else \
        _committed[1]


_committed = (A._natural_lib, A._deferred_lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    A._natural_lib()
    A._deferred_lib()
    libs = build15()
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv8 = torch.randn((B, N, 16 * 64), generator=gen,
                       device="cuda").bfloat16()
    qkv20 = torch.randn((B, N, 28 * 64), generator=gen,
                        device="cuda").bfloat16()
    cos, sin = rope_cos_sin(N, 64, device="cuda")
    q4, k4, v4 = (qkv20[..., a * 64:b * 64].reshape(B, N, -1, 64)
                  for a, b in ((0, 20), (20, 24), (24, 28)))
    q, k, v = (qkv8[..., a * 64:b * 64] for a, b in ((0, 8), (8, 12),
                                                     (12, 16)))
    kernels = {
        "B16 gqa_attention_grouped (20/4)":
            lambda: A.gqa_attention_grouped(q4, k4, v4),
        "B2 gqa_attention_flash_qkv (8/4, n_valid 997)":
            lambda: A.gqa_attention_flash_qkv(qkv8, cos, sin, 8, 4,
                                              n_valid=N - 3),
        "B11 gqa_attention_flash (8/4)":
            lambda: A.gqa_attention_flash(q, k, v, 8, 4),
    }
    for name, fn in kernels.items():
        res = {}
        for warps, lib in ((16, None), (15, libs), (16, None), (15, libs)):
            use(warps, lib)
            out = fn()
            ms = chip_smoke.time_ms(lambda *_: fn(), [()], 50)
            res.setdefault(warps, []).append((ms, out))
        same = torch.equal(res[15][0][1], res[16][0][1])
        print(f"[warps] {name} N {N} batch {B}: 16 warps "
              f"{[round(m, 5) for m, _ in res[16]]} ms, 15 warps "
              f"{[round(m, 5) for m, _ in res[15]]} ms; bit-equal {same}",
              flush=True)
    use(16, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
