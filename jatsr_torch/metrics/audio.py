"""Audio quality metrics: LSD and Mel-L1/L2, librosa-parity formulas.

The port's copy of the JAX package's ``metrics/audio.py``, the same float64
numpy on the host: an offline evaluation path whose numbers equal the JAX
package's.  The reference evaluates with librosa (calculate_metrics.py:
23-130); the formulas are written out here:

- STFT: centred, reflect-padded, periodic Hann window, as ``librosa.stft``
  by default.
- Mel filterbank: Slaney scale and Slaney area normalisation, as
  ``librosa.filters.mel(htk=False, norm='slaney')``.
- ``power_to_db`` with ``ref=np.max``, ``amin=1e-10``, ``top_db=80``.
- LSD: ``20 * mean_t( sqrt( mean_f( (log10|S_p| - log10|S_g|)^2 ) ) )``
  (calculate_metrics.py:23-62).
- Mel L1 = mean |dB diff|; Mel L2 = RMS dB diff (calculate_metrics.py:
  64-101), and the multi-scale variant over {512, 1024, 2048} FFTs
  (calculate_metrics.py:103-130).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def stft_magnitude(y: np.ndarray, n_fft: int = 2048,
                   hop_length: int = 512) -> np.ndarray:
    """|STFT| of a 1-D signal, librosa-default geometry.

    Returns [1 + n_fft//2, n_frames].
    """
    y = np.asarray(y, np.float64)
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = y[idx] * _hann_periodic(n_fft)[None, :]
    return np.abs(np.fft.rfft(frames, axis=-1)).T


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    f = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised triangular mel filters [n_mels, 1 + n_fft//2]."""
    fmax = fmax or sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2
    )
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalisation.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


def melspectrogram(y: np.ndarray, sr: int, n_fft: int, hop_length: int,
                   n_mels: int) -> np.ndarray:
    S = stft_magnitude(y, n_fft, hop_length) ** 2
    return mel_filterbank(sr, n_fft, n_mels) @ S


def power_to_db(S: np.ndarray, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db with ref=np.max."""
    ref = np.maximum(amin, S.max())
    log_spec = 10.0 * np.log10(np.maximum(amin, S)) - 10.0 * np.log10(ref)
    return np.maximum(log_spec, log_spec.max() - top_db)


def calculate_lsd(pred: np.ndarray, gt: np.ndarray, n_fft: int = 2048,
                  hop_length: int = 512) -> Tuple[float, np.ndarray]:
    """Log-spectral distance in dB (calculate_metrics.py:23-62)."""
    n = min(len(pred), len(gt))
    ps = np.maximum(stft_magnitude(pred[:n], n_fft, hop_length), 1e-8)
    gs = np.maximum(stft_magnitude(gt[:n], n_fft, hop_length), 1e-8)
    diff = np.log10(ps) - np.log10(gs)
    lsd_frames = np.sqrt(np.mean(diff**2, axis=0))
    return float(20.0 * np.mean(lsd_frames)), lsd_frames


def calculate_mel_loss(pred: np.ndarray, gt: np.ndarray, sr: int = 44100,
                       n_mels: int = 80, n_fft: int = 2048,
                       hop_length: int = 512):
    """Mel L1 / L2 in dB (calculate_metrics.py:64-101)."""
    n = min(len(pred), len(gt))
    p_db = power_to_db(melspectrogram(pred[:n], sr, n_fft, hop_length, n_mels))
    g_db = power_to_db(melspectrogram(gt[:n], sr, n_fft, hop_length, n_mels))
    l1 = float(np.mean(np.abs(p_db - g_db)))
    l2 = float(np.sqrt(np.mean((p_db - g_db) ** 2)))
    return l1, l2, p_db, g_db


def calculate_multi_scale_mel_loss(pred: np.ndarray, gt: np.ndarray,
                                   sr: int = 44100):
    """Multi-resolution Mel losses (calculate_metrics.py:103-130)."""
    fft_sizes, hops, mels = [512, 1024, 2048], [128, 256, 512], [40, 64, 80]
    results: Dict[str, Dict[str, float]] = {}
    tot1 = tot2 = 0.0
    for nf, hp, nm in zip(fft_sizes, hops, mels):
        l1, l2, _, _ = calculate_mel_loss(pred, gt, sr, nm, nf, hp)
        tot1, tot2 = tot1 + l1, tot2 + l2
        results[f"fft{nf}"] = {"l1": l1, "l2": l2}
    return tot1 / 3, tot2 / 3, results


def grade_quality(lsd_db: float, mel_l1: float) -> str:
    """Quality grading thresholds (calculate_metrics.py:227-254)."""
    if lsd_db < 1.0:
        lsd_grade = "excellent"
    elif lsd_db < 1.5:
        lsd_grade = "good"
    elif lsd_db < 2.5:
        lsd_grade = "fair"
    else:
        lsd_grade = "poor"
    if mel_l1 < 1.0:
        mel_grade = "excellent"
    elif mel_l1 < 2.0:
        mel_grade = "good"
    elif mel_l1 < 4.0:
        mel_grade = "fair"
    else:
        mel_grade = "poor"
    return f"LSD: {lsd_grade}, Mel: {mel_grade}"
