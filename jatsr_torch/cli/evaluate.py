"""CLI: audio quality metrics (the reference's calculate_metrics.py).

Usage:
    python -m jatsr_torch.cli.evaluate --pred gen.wav --gt gt.wav \
        [--lr-baseline lr.wav]

The port of the JAX package's ``cli/evaluate.py``, with the same flags and
report: LSD, Mel L1/L2 (single and multi-scale) and the quality grade; with
``--lr-baseline`` also the improvement over the LR input, as the reference
README does (README.md:290-297).  The metrics are float64 numpy on the host
(``jatsr_torch.metrics``), so no device runs them; ``--platform`` is taken
for the JAX CLI's flags and only checked.
"""

from __future__ import annotations

import argparse


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--lr-baseline", default=None)
    ap.add_argument("--sr", type=int, default=44100)
    ap.add_argument("--platform", default=None,
                    help="accepted for the JAX CLI's flags: the metrics "
                         "run on the host")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {args.platform!r}")

    from ..metrics import (
        calculate_lsd,
        calculate_mel_loss,
        calculate_multi_scale_mel_loss,
        grade_quality,
    )
    from ..utils.audio_io import load_wav

    pred, _ = load_wav(args.pred, mono=True)
    gt, _ = load_wav(args.gt, mono=True)

    def report(name, a, b):
        lsd, _ = calculate_lsd(a, b)
        l1, l2, _, _ = calculate_mel_loss(a, b, sr=args.sr)
        ms1, ms2, _ = calculate_multi_scale_mel_loss(a, b, sr=args.sr)
        print(f"--- {name} ---")
        print(f"  LSD:            {lsd:6.2f} dB")
        print(f"  Mel L1 / L2:    {l1:6.2f} / {l2:6.2f} dB")
        print(f"  MS-Mel L1 / L2: {ms1:6.2f} / {ms2:6.2f} dB")
        print(f"  Grade:          {grade_quality(lsd, l1)}")
        return lsd, l1, l2

    lsd_p, l1_p, l2_p = report("generated vs GT", pred, gt)
    if args.lr_baseline:
        lr, _ = load_wav(args.lr_baseline, mono=True)
        lsd_b, l1_b, l2_b = report("LR input vs GT (baseline)", lr, gt)
        print("--- improvement over LR baseline ---")
        for name, p, b in [("LSD", lsd_p, lsd_b), ("Mel L1", l1_p, l1_b),
                           ("Mel L2", l2_p, l2_b)]:
            sign = "+" if b - p >= 0 else ""
            pct = 100.0 * (b - p) / max(abs(b), 1e-9)
            print(f"  {name}: {sign}{b - p:.2f} dB ({sign}{pct:.1f}%)")
    return {"lsd": lsd_p, "mel_l1": l1_p, "mel_l2": l2_p}


if __name__ == "__main__":
    main()
