"""Audio quality metrics and spectrum plots (host numpy)."""

from .audio import (
    calculate_lsd,
    calculate_mel_loss,
    calculate_multi_scale_mel_loss,
    grade_quality,
    mel_filterbank,
    melspectrogram,
    power_to_db,
    stft_magnitude,
)

__all__ = [
    "stft_magnitude",
    "mel_filterbank",
    "melspectrogram",
    "power_to_db",
    "calculate_lsd",
    "calculate_mel_loss",
    "calculate_multi_scale_mel_loss",
    "grade_quality",
]
