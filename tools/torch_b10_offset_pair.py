#!/usr/bin/env python3
"""Times B10 (the training attention, ``ops/attention_train.py``) of this
tree against another checkout's on one card, in turns (other, this, this,
other), each through its own tree's wrappers, at the v3 training shape (q
[28, 345, 1280], k/v [28, 345, 256], dropout 0.1), in bf16
(``csrc/attention_train.cu``) and fp32 (``csrc/attention_f32.cu`` mode 5,
``csrc/attention_f32_bwd.cu``), forward and backward:

    python3 tools/torch_b10_offset_pair.py OTHER_ROOT

Each tree launches with its batch offset ``b0`` and head offset ``h0``
at 0 where its wrappers take them (the arguments a data-parallel rank
sets to its first row and a tensor-parallel rank to its first q head); a
tree whose wrappers take neither launches as it is.  OTHER_ROOT is another
checkout's root (for example a ``git archive`` of the parent commit
unpacked into a gitignored directory).  Each turn is a process of its own
that imports its tree's ``jatsr_torch`` (which builds its kernels into
that tree's ``ops/build``), draws the same inputs from seed 0 and times
each launch.  Prints each launch's mean ms a tree over its two turns,
whether the two trees' outputs (o and the row statistics; dq, dk, dv) are
bit-equal, then, on this tree alone, a tensor-parallel rank's half of the
heads (10 q heads, 2 kv heads) at ``h0 = 10`` against ``h0 = 0`` in turns
(0, 10, 10, 0), then the card's name and power limit.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, N, HQ, HKV, D, RATE, SEED = 28, 345, 20, 4, 64, 0.1, -123456789
LAUNCHES = ("fwd_bf16", "bwd_bf16", "fwd_fp32", "bwd_fp32")


def offsets(fn) -> dict:
    """The offsets ``fn`` takes, each at 0."""
    import inspect

    params = inspect.signature(fn).parameters
    return {k: 0 for k in ("b0", "h0") if k in params}


def half_heads() -> None:
    """This tree's B10 on a rank's half of the heads at h0 = 10 against
    h0 = 0, in turns: the mean ms of each, printed as JSON."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from jatsr_torch.ops import attention_train as at

    hq, hkv, h0 = HQ // 2, HKV // 2, HQ // 2
    result = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((B, N, w * D), generator=gen,
                                   device="cuda").to(dt)
                       for w in (hq, hkv, hkv, hq))
        o, st = at.attention_train_fwd(q, k, v, SEED, hq, hkv, RATE, h0=h0)
        ms = {}
        for off in (0, h0, h0, 0):
            ms.setdefault(f"fwd_{name}_h0_{off}", []).append(
                chip_smoke.time_ms(lambda *_: at.attention_train_fwd(
                    q, k, v, SEED, hq, hkv, RATE, h0=off), [()], 50))
            ms.setdefault(f"bwd_{name}_h0_{off}", []).append(
                chip_smoke.time_ms(lambda *_: at.attention_train_bwd(
                    q, k, v, o, do, SEED, hq, hkv, RATE, st, h0=off),
                    [()], 30))
        result.update({k: [round(x, 5) for x in v] for k, v in ms.items()})
        del q, k, v, do, o, st
        torch.cuda.empty_cache()
    print(json.dumps(result))


def turn(tree: Path, out: Path) -> None:
    """One turn: ``tree``'s B10 on the inputs of seed 0; the outputs saved
    to ``out``, each launch's ms printed as JSON."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke

    sys.path.insert(0, str(tree))
    from jatsr_torch.ops import attention_train as at

    outs, result = {}, {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((B, N, w * D), generator=gen,
                                   device="cuda").to(dt)
                       for w in (HQ, HKV, HKV, HQ))
        fo = offsets(at.attention_train_fwd)
        bo = offsets(at.attention_train_bwd)
        o, stats = at.attention_train_fwd(q, k, v, SEED, HQ, HKV, RATE, **fo)
        grads = at.attention_train_bwd(q, k, v, o, do, SEED, HQ, HKV, RATE,
                                       stats, **bo)
        outs[name] = [t.cpu() for t in (o, stats, *grads)]
        result[f"fwd_{name}"] = round(chip_smoke.time_ms(
            lambda *_: at.attention_train_fwd(q, k, v, SEED, HQ, HKV, RATE,
                                              **fo), [()], 50), 5)
        result[f"bwd_{name}"] = round(chip_smoke.time_ms(
            lambda *_: at.attention_train_bwd(q, k, v, o, do, SEED, HQ, HKV,
                                              RATE, stats, **bo), [()], 30),
            5)
        del q, k, v, do, o, stats, grads
        torch.cuda.empty_cache()
    torch.save(outs, out)
    print(json.dumps(result))


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        turn(Path(sys.argv[2]), Path(sys.argv[3]))
        return 0
    if sys.argv[1:] == ["--half-heads"]:
        half_heads()
        return 0
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
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
    for launch in LAUNCHES:
        mine = [r[launch] for r in ms["this"]]
        theirs = [r[launch] for r in ms["other"]]
        dt = launch.split("_")[1]
        n = slice(0, 2) if launch.startswith("fwd") else slice(2, 5)
        same = all(torch.equal(a, b) for a, b in zip(
            outs["other"][dt][n], outs["this"][dt][n]))
        a, b = sum(theirs) / 2, sum(mine) / 2
        print(f"[b10 pair] {launch}: other {a:.5f} ms (turns {theirs}); "
              f"this {b:.5f} ms (turns {mine}), {(b / a - 1) * 100:+.2f} %; "
              f"outputs bit-equal: {same}")
    run = subprocess.run([sys.executable, __file__, "--half-heads"],
                         capture_output=True, text=True)
    if run.returncode:
        print(run.stdout + run.stderr, file=sys.stderr)
        return 1
    half = json.loads(run.stdout.strip().splitlines()[-1])
    for launch in LAUNCHES:
        t0, t1 = (half[f"{launch}_h0_{off}"] for off in (0, HQ // 2))
        a, b = sum(t0) / 2, sum(t1) / 2
        print(f"[b10 pair] {launch} on 10/2 heads: h0 0 {a:.5f} ms, h0 10 "
              f"{b:.5f} ms ({(b / a - 1) * 100:+.2f} %; turns h0 0 {t0}, "
              f"h0 10 {t1})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[b10 pair] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
