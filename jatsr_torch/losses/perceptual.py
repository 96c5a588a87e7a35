"""The latent perceptual loss stack in fp32, on time-major ``[B, T, C]``.

Port of the JAX package's ``losses/perceptual.py``: the fixed frequency loss
(log-magnitude L1 plus a low-band complex L1), the ``buggy_v3mod1`` control,
multi-scale L1, the tri-band consistency loss against the LR condition,
Charbonnier, ``reconstruction_loss`` and ``total_training_loss``.  Every
spectral term takes an fp32 ``torch.fft.rfft`` over the time axis.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs import LossConfig
from ..sampling.flow import linspace_f32


def charbonnier_loss(pred, target, eps: float = 1e-6):
    """``mean(sqrt((pred - target)^2 + eps))``."""
    d = (pred.float() - target.float()) ** 2
    return torch.sqrt(d + eps).mean()


def _rfft_time(x):
    return torch.fft.rfft(x.float(), dim=1)


def _ramp(start: float, stop: float, n: int, like):
    """``jnp.linspace(start, stop, n)`` as ``[1, n, 1]`` fp32."""
    return torch.from_numpy(linspace_f32(start, stop, n)).to(
        like.device)[None, :, None]


def frequency_domain_loss(pred, target, low_freq_phase_ratio: float = 0.3):
    """Log-magnitude L1 + 0.1 x low-frequency complex L1."""
    pf, tf = _rfft_time(pred), _rfft_time(target)
    eps = 1e-7
    log_mag = torch.abs(torch.log(torch.abs(pf) + eps)
                        - torch.log(torch.abs(tf) + eps)).mean()
    low = int(pf.shape[1] * low_freq_phase_ratio)
    phase = torch.abs(pf[:, :low] - tf[:, :low]).mean()
    return 1.0 * log_mag + 0.1 * phase


def buggy_frequency_domain_loss(pred, target, high_freq_weight: float = 2.0):
    """The historical negative control: ``0.5 complex-L1 + 0.2 magnitude-L1
    + 0.5 ramp-weighted magnitude-L1`` (the ramp 1 -> ``high_freq_weight``
    over the bins)."""
    pf, tf = _rfft_time(pred), _rfft_time(target)
    complex_l1 = torch.abs(pf - tf).mean()
    d_mag = torch.abs(torch.abs(pf) - torch.abs(tf))
    w = _ramp(1.0, high_freq_weight, pf.shape[1], pf)
    return 0.5 * complex_l1 + 0.2 * d_mag.mean() + 0.5 * (w * d_mag).mean()


def _avg_pool_time(x, s: int):
    """AvgPool1d(kernel = stride = s) over time, remainder dropped."""
    if s == 1:
        return x
    B, T, C = x.shape
    n = T // s
    return x[:, :n * s].reshape(B, n, s, C).mean(dim=2)


def multi_scale_loss(pred, target, scales=(1, 2, 4)):
    """Mean over the time scales of the L1 of the average-pooled signals."""
    pred, target = pred.float(), target.float()
    total = 0.0
    for s in scales:
        total = total + torch.abs(_avg_pool_time(pred, s)
                                  - _avg_pool_time(target, s)).mean()
    return total / len(scales)


def consistency_loss(pred_hr, lr, strict_cutoff: float = 0.30,
                     soft_cutoff: float = 0.36):
    """Complex L1 against the LR condition below ``strict_cutoff`` of the
    bins, magnitude L1 under a 1 -> 0 ramp up to ``soft_cutoff``, free
    above."""
    pf, lf = _rfft_time(pred_hr), _rfft_time(lr)
    nbins = pf.shape[1]
    strict_bin = int(nbins * strict_cutoff)
    soft_bin = int(nbins * soft_cutoff)
    strict = torch.abs(pf[:, :strict_bin] - lf[:, :strict_bin]).mean()
    if soft_bin > strict_bin:
        p_mag = torch.abs(pf[:, strict_bin:soft_bin])
        l_mag = torch.abs(lf[:, strict_bin:soft_bin])
        decay = _ramp(1.0, 0.0, soft_bin - strict_bin, pf)
        transition = (torch.abs(p_mag - l_mag) * decay).mean()
    else:
        transition = torch.zeros((), dtype=torch.float32, device=pf.device)
    return 1.0 * strict + 1.0 * transition


def latent_perceptual_loss(pred, target, lr, cfg: LossConfig
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted frequency + multi-scale + consistency terms."""
    if cfg.freq_loss_variant == "buggy_v3mod1":
        freq = buggy_frequency_domain_loss(pred, target, cfg.high_freq_weight)
    else:
        freq = frequency_domain_loss(pred, target, cfg.low_freq_phase_ratio)
    ms = multi_scale_loss(pred, target, cfg.ms_scales)
    cons = consistency_loss(pred, lr, cfg.strict_cutoff, cfg.soft_cutoff)
    total = cfg.freq_weight * freq + cfg.ms_weight * ms \
        + cfg.consistency_weight * cons
    return total, {"freq_loss": freq, "ms_loss": ms,
                   "consistency_loss": cons, "total_latent_loss": total}


def reconstruction_loss(pred, target, cfg: LossConfig):
    """MSE or Charbonnier main loss."""
    if cfg.reconstruction == "charbonnier":
        return charbonnier_loss(pred, target, cfg.charbonnier_eps)
    d = pred.float() - target.float()
    return (d * d).mean()


def total_training_loss(pred, target, lr, cfg: LossConfig
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``reconstruction + latent_loss_weight * latent_perceptual``."""
    recon = reconstruction_loss(pred, target, cfg)
    metrics = {"recon_loss": recon}
    loss = cfg.reconstruction_weight * recon
    if cfg.use_latent_perceptual:
        perc, pm = latent_perceptual_loss(pred, target, lr, cfg)
        loss = loss + cfg.latent_loss_weight * perc
        metrics.update(pm)
    metrics["loss"] = loss
    return loss, metrics
