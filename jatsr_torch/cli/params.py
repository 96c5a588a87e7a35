"""CLI: parameter analysis (calculate_model_params.py +
compare_v2_v3_params.py).

Usage:
    python -m jatsr_torch.cli.params --preset v3            # per-module count
    python -m jatsr_torch.cli.params --compare v2 v3        # config + size diff

The port of the JAX package's ``cli/params.py``: closed-form counts from the
preset's config; no model is built and no device is used.
"""

from __future__ import annotations

import argparse


def analytic_counts(mcfg) -> dict:
    """Closed-form per-module parameter counts for a DiT config."""
    H, D = mcfg.hidden_size, mcfg.depth
    P, C = mcfg.patch_len, mcfg.input_channels
    kv = mcfg.num_kv_heads * mcfg.head_dim
    mlp_dim = int(H * mcfg.mlp_ratio)
    counts = {
        "patch_embed": (P * 2 * C) * mcfg.bottleneck_dim + mcfg.bottleneck_dim
        + mcfg.bottleneck_dim * H + H,
        "t_embedder": 2 * (H * H + H),
        "attention": D * (2 * H * H + 2 * H * kv),
        "mlp": D * (2 * H * mlp_dim + mlp_dim + H),
        "adaln": D * (H * 6 * H + 6 * H),
        "final_layer": H * P * C + P * C,
    }
    counts["total"] = sum(counts.values())
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default=None)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None)
    args = ap.parse_args(argv)

    from ..configs import get_preset

    def report(name):
        mcfg = get_preset(name).model
        counts = analytic_counts(mcfg)
        print(f"=== {name}: hidden {mcfg.hidden_size}, depth {mcfg.depth}, "
              f"{mcfg.num_q_heads}Q/{mcfg.num_kv_heads}KV, "
              f"norm={mcfg.norm} ===")
        for k, v in counts.items():
            pct = 100.0 * v / counts["total"]
            print(f"  {k:14s} {v/1e6:9.2f} M  ({pct:5.1f}%)")
        return counts

    if args.compare:
        a, b = args.compare
        ca, cb = report(a), report(b)
        print(f"=== {b} vs {a} ===")
        for k in ca:
            da = cb[k] - ca[k]
            print(f"  {k:14s} {da/1e6:+9.2f} M")
    else:
        report(args.preset or "v3")


if __name__ == "__main__":
    main()
