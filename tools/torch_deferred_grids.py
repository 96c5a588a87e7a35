"""Time B2 and B11 (csrc/attention_deferred.cu) on each of their two grids.

One kernel serves both grids of ``ops/attention.py:_deferred_plan``: the
per-kv-head grid (120 CTAs of 5 rounds at the serving shape) and the
balanced one (132 CTAs of 4 rounds).  ``_flash_deferred`` picks B2's and
B11's grid by default; this probe times each kernel on both, in turns
(per-kv-head, balanced, balanced, per-kv-head), at the serving shapes that
``chip_smoke.py`` uses: B2 on qkv [6, 352, 1792] bf16 with keys masked past
345, B11 on q [6, 345, 1280] and k/v [6, 345, 256] bf16.  The timing is
``chip_smoke.py``'s (CUDA events behind a card-side spin, inputs rotated
past L2).  Needs one CUDA card.

Usage: python3 tools/torch_deferred_grids.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jatsr_torch.models.dit import rope_cos_sin  # noqa: E402
from jatsr_torch.ops.attention import _flash_deferred  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_deferred_grids: CUDA is not available", file=sys.stderr)
        return 2
    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    qkv = torch.randn((cs.B, cs.NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(cs.NP, D, device="cuda")
    split = qkv[:, :cs.N_VALID]
    cols = (slice(0, hq * D), slice(hq * D, (hq + hkv) * D),
            slice((hq + hkv) * D, None))
    b11 = tuple(split[..., c].contiguous() for c in cols)
    launches = {
        "flash_qkv": (lambda bal, x: _flash_deferred(
            *(x[..., c] for c in cols), hq, hkv, cs.N_VALID, cos, sin,
            balanced=bal), (qkv,)),
        "flash_split": (lambda bal, q, k, v: _flash_deferred(
            q, k, v, hq, hkv, None, balanced=bal), b11),
    }
    out = {"card": cs.card_line()}
    for name, (launch, args) in launches.items():
        sets = [tuple(a.clone() for a in args)
                for _ in range(cs.rotations(cs.nbytes_of(*args)))]
        t = {}
        for bal in (False, True, True, False):
            ms = cs.time_ms(lambda *a: launch(bal, *a), sets, 200)
            key = "balanced" if bal else "per_kv_head"
            t[key] = min(t.get(key, ms), ms)
        out[name] = t
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
