#!/usr/bin/env python3
"""Times the fp32 attention modes (``csrc/attention_f32.cu``) of this tree
against another checkout's on one card, in turns (other, this, this,
other), each through its own tree's Python wrappers, at the fp32 serving
shapes (20/4 heads, head dim 64, batch 6):

    flash_qkv  B2: qkv [6, 352, 1792], keys masked past 345
    int8_qk    B2 with the int8 value product, the same qkv
    flash      B11: q [6, 345, 1280], k/v [6, 345, 256]
    natural    B15: q [6, 345, 20, 64], k/v [6, 345, 4, 64]
    grouped    B16: the same

    python3 tools/torch_attention_f32_pair.py OTHER_ROOT

OTHER_ROOT is another checkout's root (for example a ``git archive`` of the
parent commit unpacked into a gitignored directory).  Each turn is a
process of its own that imports its tree's ``jatsr_torch`` (which builds its
kernels into that tree's ``ops/build``), draws the same inputs from seed 0
and times every mode; a mode that the other tree refuses in fp32 is timed
on this tree alone.  Prints, for each mode, each tree's mean ms a launch
over its two turns and whether the two trees' outputs are bit-equal, then
the card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, N, NP, HQ, HKV, D = 6, 345, 352, 20, 4, 64
MODES = ("flash_qkv", "int8_qk", "flash", "natural", "grouped")


def modes(att):
    """Each mode's call of ``att``'s wrapper on an input set ``x``."""
    def split(fn):
        return lambda x: fn(*(x[n].view(B, N, -1, D) for n in "qkv"))

    return {
        "flash_qkv": lambda x: att.gqa_attention_flash_qkv(
            x["qkv"], x["cos"], x["sin"], HQ, HKV, n_valid=N),
        "int8_qk": lambda x: att.gqa_attention_flash_qkv(
            x["qkv"], x["cos"], x["sin"], HQ, HKV, n_valid=N, int8_qk=True),
        "flash": lambda x: att.gqa_attention_flash(x["q"], x["k"], x["v"],
                                                   HQ, HKV),
        "natural": split(att.gqa_attention),
        "grouped": split(att.gqa_attention_grouped),
    }


def turn(tree: Path, out: Path) -> None:
    """One turn: ``tree``'s wrappers on the inputs of seed 0; each mode's
    output saved to ``out``, its ms a launch (or why the tree refuses it)
    printed as JSON."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke

    sys.path.insert(0, str(tree))
    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = {"qkv": torch.randn((B, NP, (HQ + 2 * HKV) * D), generator=gen,
                            device="cuda")}
    x["cos"], x["sin"] = rope_cos_sin(NP, D, device="cuda")
    for name, h in (("q", HQ), ("k", HKV), ("v", HKV)):
        x[name] = torch.randn((B, N, h * D), generator=gen, device="cuda")
    big = ("qkv", "q", "k", "v")
    sets = [({n: t.clone() if n in big else t for n, t in x.items()},)
            for _ in range(chip_smoke.rotations(
                sum(x[n].nbytes for n in big)))]
    outs, result = {}, {}
    for mode, fn in modes(att).items():
        try:
            outs[mode] = fn(x).cpu()
        except (NotImplementedError, TypeError, ValueError) as e:
            result[mode] = str(e).splitlines()[0]
            continue
        result[mode] = round(chip_smoke.time_ms(fn, sets, 100), 5)
    torch.save(outs, out)
    print(json.dumps(result))


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        turn(Path(sys.argv[2]), Path(sys.argv[3]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[2], file=sys.stderr)
        return 2
    import torch

    trees = {"other": Path(sys.argv[1]).resolve(), "this": ROOT}
    ms = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("other", "this", "this", "other")):
            out = Path(tmp) / f"{i}-{name}.pt"
            run = subprocess.run([sys.executable, __file__, "--turn",
                                  str(trees[name]), str(out)],
                                 capture_output=True, text=True)
            if run.returncode:
                print(run.stdout + run.stderr, file=sys.stderr)
                return 1
            ms[name].append(json.loads(run.stdout.strip().splitlines()[-1]))
        outs = {name: torch.load(Path(tmp) / f"{i}-{name}.pt")
                for i, name in enumerate(("other", "this"))}
    for mode in MODES:
        mine = [r[mode] for r in ms["this"]]
        line = f"this {sum(mine) / 2:.5f} ms (turns {mine})"
        theirs = [r[mode] for r in ms["other"]]
        if isinstance(theirs[0], str):
            line += f"; other tree refuses it ({theirs[0]})"
        else:
            same = torch.equal(outs["other"][mode], outs["this"][mode])
            line = (f"other {sum(theirs) / 2:.5f} ms (turns {theirs}); "
                    f"{line}; outputs bit-equal: {same}")
        print(f"[f32 pair] {mode}: {line}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[f32 pair] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
