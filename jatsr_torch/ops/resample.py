"""Polyphase windowed-sinc resampling as one strided convolution.

Port of the JAX package's ``ops/resample.py``: a bank of ``new`` polyphase
filters (after the gcd fold) built from a Hann-windowed sinc
(lowpass_filter_width 6, rolloff 0.99, torchaudio's defaults) in float64
numpy, cast to fp32 and cached per (orig, new) pair, then applied as one
``F.conv1d`` with stride ``orig``.  The JAX package leaves this conv to XLA,
so it is a plain convolution here too (fp32; TF32 off on the card).

48000 -> 16000 folds to a 3:1 decimator, 16000 -> 44100 to 160:441 and
44100 <-> 48000 to 147:160.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _sinc_kernel(orig: int, new: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99):
    """``(kernel [new, 1, K] fp32 numpy, width)``: one filter of the bank
    per output phase, K = 2 * width + orig input samples each."""
    assert orig > 0 and new > 0
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale  # [new, K]
    return np.ascontiguousarray(kernel[:, None, :], np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample ``[B, T, C]`` or ``[B, T]`` along time, on x's device.

    The output has ``ceil(T * new / orig)`` samples (torchaudio's length).
    """
    if orig_freq == new_freq:
        return x
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    B, T, C = x.shape
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    kernel, width = _sinc_kernel(orig, new, lowpass_filter_width, rolloff)
    w = torch.from_numpy(kernel).to(x.device)
    # Channels fold into the batch; the padding is asymmetric, so it comes
    # first and the conv runs unpadded.
    xc = F.pad(x.float().permute(0, 2, 1).reshape(B * C, 1, T),
               (width, width + orig))
    out = F.conv1d(xc, w, stride=orig)  # [B*C, new, T'], phase-major
    target = int(math.ceil(new * T / orig))
    out = out.transpose(1, 2).reshape(B * C, -1)[:, :target]
    out = out.reshape(B, C, target).transpose(1, 2)
    return out[..., 0] if squeeze else out


def simulate_lr(x: torch.Tensor, high_sr: int = 48000,
                low_sr: int = 16000) -> torch.Tensor:
    """Low-resolution simulation: down- then up-sample, cut or zero-padded
    to the input's length."""
    T = x.shape[1]
    lr = resample(resample(x, high_sr, low_sr), low_sr, high_sr)
    cur = lr.shape[1]
    if cur < T:
        pad = [0, 0] * (x.ndim - 2) + [0, T - cur]
        lr = F.pad(lr, pad)
    return lr[:, :T]
