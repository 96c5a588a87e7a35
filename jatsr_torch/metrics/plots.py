"""Spectrogram and waveform inspection plots.

The port's copy of the JAX package's ``metrics/plots.py``: the reference's
waveform, linear spectrogram and mel spectrogram PNGs
(plot_audio_spectrum.py:16-56, plot_original_spectrum.py:26-40), from the
STFT and mel of ``metrics.audio``.  matplotlib is imported only when a
function is called: a machine without it can import this module, and a call
there raises ``ImportError`` naming matplotlib.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .audio import melspectrogram, power_to_db, stft_magnitude


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the spectrum plots need matplotlib, which is not "
                          "installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_audio_spectrum(audio: np.ndarray, sr: int, out_path: str | Path,
                        title: str = "", n_fft: int = 2048,
                        hop_length: int = 512, n_mels: int = 128) -> Path:
    """Waveform + linear-frequency dB spectrogram + mel dB spectrogram."""
    plt = _pyplot()

    audio = np.asarray(audio, np.float32)
    fig, axes = plt.subplots(3, 1, figsize=(12, 10))

    t = np.arange(len(audio)) / sr
    axes[0].plot(t, audio, linewidth=0.4)
    axes[0].set(title=f"{title} — waveform", xlabel="s", ylabel="amp")

    S = stft_magnitude(audio, n_fft, hop_length) ** 2
    db = power_to_db(S)
    axes[1].imshow(db, origin="lower", aspect="auto",
                   extent=(0, len(audio) / sr, 0, sr / 2 / 1000),
                   cmap="magma")
    axes[1].set(title="linear spectrogram (dB)", xlabel="s", ylabel="kHz")

    M = power_to_db(melspectrogram(audio, sr, n_fft, hop_length, n_mels))
    axes[2].imshow(M, origin="lower", aspect="auto",
                   extent=(0, len(audio) / sr, 0, n_mels), cmap="magma")
    axes[2].set(title=f"mel spectrogram ({n_mels} mels, dB)", xlabel="s",
                ylabel="mel bin")

    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_comparison(named_audios, sr: int, out_path: str | Path,
                    n_fft: int = 2048, hop_length: int = 512) -> Path:
    """Stacked spectrograms of e.g. (generated, GT, LR input) for A/B
    inspection."""
    plt = _pyplot()

    n = len(named_audios)
    fig, axes = plt.subplots(n, 1, figsize=(12, 3.2 * n))
    if n == 1:
        axes = [axes]
    for ax, (name, audio) in zip(axes, named_audios):
        S = stft_magnitude(np.asarray(audio, np.float32), n_fft,
                           hop_length) ** 2
        ax.imshow(power_to_db(S), origin="lower", aspect="auto",
                  extent=(0, len(audio) / sr, 0, sr / 2 / 1000), cmap="magma")
        ax.set(title=name, ylabel="kHz")
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
