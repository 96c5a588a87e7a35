#!/usr/bin/env python3
"""Compares the SASS of the attention kernels' instances (B2, B10, B11, B12,
B15, B16), of the DAC kernels B8, B6 and B9 (on ``bf16_wgmma.cuh``), of B1,
B3 and B4 (on ``s8_wgmma.cuh``) and of the ``mma.sync`` kernels of
``int8_gemm.cuh``'s users (B12's quant and GEMM, B14's GEMM) with another
tree's kernels, on a machine with nvcc (no card needed).

    python3 tools/torch_sass_diff.py OTHER_CSRC_DIR

OTHER_CSRC_DIR is another checkout's ``jatsr_torch/ops/csrc`` (for example
a ``git archive`` of the parent commit unpacked into a gitignored
directory).  Both trees' ``attention_natural.cu``, ``attention_deferred.cu``,
``attention_train.cu``, ``flash_qkv.cu``, ``snake_tr_stream.cu``,
``dac_res.cu``, ``norm_mod.cu``, ``w8a8_fused.cu`` and ``matmul_fused.cu``
(its GEMM) are compiled to cubins with the port's nvcc flags; for each
kernel of the other tree it finds this tree's instance of the same name or,
where the other tree has no head-dim template argument, the instance with
head dim 64 (the same kernel with ``64`` as its first template argument),
strips addresses and encodings from ``cuobjdump -sass`` and prints the
instruction counts and whether the streams are identical (else how many
instructions differ, by ``difflib``).  The kernels in RETIRED are the
other tree's that this one deleted on purpose (``int8_gemm.cuh``'s
``requant`` and ``gemm_gelu`` instances, which every library that included
it compiled); they are listed and not compared.  B5 and B13
(``dense_gelu_quant.cu``, ``mlp_full.cu``) were redesigned on the s8
``wgmma`` core and are not compared.  Exits 1 if any other pair differs.
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

SOURCES = {"attention_natural.cu": ("natural_kernel",),
           "attention_deferred.cu": ("deferred_kernel",),
           "attention_train.cu": ("train_fwd_kernel", "attn_bwd_kernel",
                                  "bwd_rows_kernel"),
           "flash_qkv.cu": ("normed_kernel", "quant_rows", "gemm_",
                            "requant"),
           "snake_tr_stream.cu": ("",),
           "dac_res.cu": ("",),
           "norm_mod.cu": ("",),
           "w8a8_fused.cu": ("",),
           "matmul_fused.cu": ("gemm_",)}
UNTEMPLATED = ("snake_tr_stream.cu", "dac_res.cu", "norm_mod.cu",
               "w8a8_fused.cu", "matmul_fused.cu")  # matched by name
RETIRED = ("requant", "gemm_gelu")


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
    return {n.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0]: v for n, v in zip(names, funcs.values())}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for f, kernels in SOURCES.items():
            (Path(tmp) / "this").mkdir(exist_ok=True)
            (Path(tmp) / "other").mkdir(exist_ok=True)
            new = sass(_build.CSRC / f, Path(tmp) / "this")
            old = sass(other / f, Path(tmp) / "other")
            for name, vo in sorted(old.items()):
                if not name.startswith(kernels):
                    continue
                base, _, args = name.partition("<")
                key = (name if f in UNTEMPLATED or name in new
                       else f"{base}<64{', ' + args if args else '>'}")
                vn = new.get(key)
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
