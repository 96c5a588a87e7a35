"""WAV audio I/O on scipy.

The port's copy of the JAX package's ``utils/audio_io.py``: PCM 8/16/32-bit
and float32/float64 WAV through ``scipy.io.wavfile``.  Output is float32
in [-1, 1], shape [T] (mono) or [T, C].
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
from scipy.io import wavfile

SUPPORTED_EXTENSIONS = {".wav"}


def load_wav(path: str | Path, mono: bool = False) -> Tuple[np.ndarray, int]:
    """Load a WAV file as float32 in [-1, 1].

    Returns (audio [T] or [T, C], sample_rate).
    """
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32 / float64
        audio = data.astype(np.float32)
    if mono and audio.ndim == 2:
        audio = audio.mean(axis=1)
    return audio, int(sr)


def save_wav(path: str | Path, audio: np.ndarray, sr: int,
             subtype: str = "float32") -> None:
    """Save [T] or [T, C] float audio."""
    audio = np.asarray(audio)
    if subtype == "int16":
        data = np.clip(audio, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    else:
        data = audio.astype(np.float32)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), sr, data)
