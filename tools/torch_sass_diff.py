#!/usr/bin/env python3
"""Compares the SASS of the port's kernels with another tree's, on a machine
with nvcc (no card needed): the attention kernels' instances (B2, B10, B11,
B12, B15, B16, their streaming modes, and past head dim 128
``attention_wide.cu``), the DAC
kernels B6, B7, B8 and B9, B1 and B3, and the s8 ``wgmma`` kernels of B4,
B5, B12, B13 and B14 with their row quants.

    python3 tools/torch_sass_diff.py OTHER_CSRC_DIR

OTHER_CSRC_DIR is another checkout's ``jatsr_torch/ops/csrc`` (for example
a ``git archive`` of the parent commit unpacked into a gitignored
directory).  Each source of SOURCES that the other tree has is compiled in
both trees to a cubin with the port's nvcc flags; for each kernel of the
other tree it finds this tree's instance of the same name (or its new name,
RENAMED) or, where the other tree has no head-dim template argument, the
instance with head dim 64 (the same kernel with ``64`` as its first
template argument), strips addresses and encodings from ``cuobjdump -sass``
and prints the instruction counts and whether the streams are identical
(else how many instructions differ, by ``difflib``).  The kernels in
RETIRED, and every kernel of a source this tree no longer has
(``matmul_fused.cu``, B14's ``mma.sync`` GEMM, now in ``w8a8_fused.cu``),
are the other tree's that this one deleted on purpose (``int8_gemm.cuh``'s
``mma.sync`` kernels: ``requant``, ``gemm_gelu``, ``gemm_dequant``); they
are listed and not compared.  B4's GEMM ``s8_fused_kernel`` is now
``s8_dequant.cuh``'s ``s8_dequant_kernel<false, __nv_bfloat16>``, the one
body that B12 (with a bias) and B14 (bf16 or fp32) instantiate too.  A
kernel that gained a last template flag since (the snake mode of B6, B7 and
B9: ``res_units_kernel<96, false>``, ``snake_b16_kernel<false>``) is
compared with that flag off.  Exits 1 if any other pair differs.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jatsr_torch.ops import _build  # noqa: E402

SOURCES = {"attention_natural.cu": ("natural_kernel", "natural_stream_kernel"),
           "attention_deferred.cu": ("deferred_kernel",
                                     "deferred_stream_kernel"),
           "attention_train.cu": ("train_fwd_kernel", "attn_bwd_kernel",
                                  "bwd_rows_kernel"),
           "flash_qkv.cu": ("normed_kernel", "normed_stream_kernel",
                            "quant_rows", "gemm_", "requant"),
           "attention_wide.cu": ("",),
           "snake_tr.cu": ("",),
           "snake_tr_stream.cu": ("",),
           "dac_res.cu": ("",),
           "norm_mod.cu": ("",),
           "w8a8_fused.cu": ("",),
           "dense_gelu_quant.cu": ("",),
           "mlp_full.cu": ("",),
           "matmul_fused.cu": ("gemm_",)}
UNTEMPLATED = ("attention_wide.cu", "snake_tr.cu", "snake_tr_stream.cu",
               "dac_res.cu", "norm_mod.cu", "w8a8_fused.cu",
               "dense_gelu_quant.cu", "mlp_full.cu")  # matched by name
RETIRED = ("requant", "gemm_gelu", "gemm_dequant")
RENAMED = {"s8_fused_kernel": "s8_dequant_kernel<false, __nv_bfloat16>"}


def sass(src: Path, out: Path) -> dict:
    """``{demangled kernel name: [instruction, ...]}`` of one source."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = out / (src.parent.name + "_" + src.stem + ".cubin")
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(src)], capture_output=True, text=True, check=True)
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if cur and m:
            funcs[cur].append(re.sub(r"\s+", " ", m.group(1)))
    names = subprocess.run(["c++filt"], input="\n".join(funcs),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {_kernel_name(n): v for n, v in zip(names, funcs.values())}


def _kernel_name(demangled: str) -> str:
    """``f<(Epilogue)1, false>`` of ``void (anonymous namespace)::f<
    (Epilogue)1, false>(args...)``: the name up to its parameter list, the
    first ``(`` outside the template arguments."""
    n = demangled.replace("(anonymous namespace)::", "").replace("void ", "")
    depth = 0
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return n[:i]
    return n


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for f, kernels in SOURCES.items():
            if not (other / f).exists():
                continue
            (Path(tmp) / "this").mkdir(exist_ok=True)
            (Path(tmp) / "other").mkdir(exist_ok=True)
            here = (_build.CSRC / f).exists()
            new = sass(_build.CSRC / f, Path(tmp) / "this") if here else {}
            old = sass(other / f, Path(tmp) / "other")
            for name, vo in sorted(old.items()):
                if not name.startswith(kernels):
                    continue
                if not here:
                    print(f"[sass] {f} {name}: retired here (no {f})")
                    continue
                base, _, args = name.partition("<")
                key = RENAMED.get(name) or (
                    name if f in UNTEMPLATED or name in new
                    else f"{base}<64{', ' + args if args else '>'}")
                vn = new.get(key)
                if vn is None:  # a template flag added last, off
                    flagged = (f"{key[:-1]}, false>" if key.endswith(">")
                               else f"{key}<false>")
                    if flagged in new:
                        key, vn = flagged, new[flagged]
                if vn is None and name.startswith(RETIRED):
                    print(f"[sass] {f} {name}: retired here")
                    continue
                if vn is None:
                    print(f"[sass] {f} {name}: no instance {key} here")
                    differ += 1
                    continue
                ops = [o for o in difflib.SequenceMatcher(
                    None, vo, vn, autojunk=False).get_opcodes()
                    if o[0] != "equal"]
                n = sum(max(i2 - i1, j2 - j1) for _, i1, i2, j1, j2 in ops)
                differ += bool(ops)
                print(f"[sass] {f} {name} vs {key}: {len(vo)} / {len(vn)} "
                      f"instructions, "
                      f"{f'{n} differ' if ops else 'identical'}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
