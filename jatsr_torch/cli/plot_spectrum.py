"""CLI: spectrogram inspection plots (the reference's plot_audio_spectrum.py
/ plot_original_spectrum.py).

Usage:
    python -m jatsr_torch.cli.plot_spectrum --input a.wav [b.wav ...] \
        [--output out.png] [--n-mels 128]

The port of the JAX package's ``cli/plot_spectrum.py``, with the same
flags.  One input -> waveform + linear + mel spectrogram panel; several
inputs -> stacked spectrogram comparison.  Needs matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", nargs="+", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--n-mels", type=int, default=128)
    args = ap.parse_args(argv)

    from ..metrics.plots import plot_audio_spectrum, plot_comparison
    from ..utils.audio_io import load_wav

    if len(args.input) == 1:
        path = Path(args.input[0])
        audio, sr = load_wav(path, mono=True)
        out = args.output or str(path.with_suffix(".spectrum.png"))
        plot_audio_spectrum(audio, sr, out, title=path.stem,
                            n_mels=args.n_mels)
    else:
        named = []
        sr = None
        for p in args.input:
            audio, sr = load_wav(p, mono=True)
            named.append((Path(p).stem, audio))
        out = args.output or "comparison.png"
        plot_comparison(named, sr, out)
    print(f"[plot_spectrum] wrote {out}")
    return out


if __name__ == "__main__":
    main()
