"""Latent normalization (the train step itself comes with the training
slice).  Port of ``Normalizer`` from the JAX package's ``train/step.py``."""

from __future__ import annotations

import torch

from ..utils.device import resolve_device


class Normalizer:
    """Per-channel latent normalization from global stats ``[C]``."""

    def __init__(self, hr_mean, hr_std, lr_mean, lr_std, device="cuda"):
        dev = resolve_device(device)

        def as_row(v):
            return torch.as_tensor(v, dtype=torch.float32).to(dev) \
                .reshape(1, 1, -1)

        self.hr_mean, self.hr_std = as_row(hr_mean), as_row(hr_std)
        self.lr_mean, self.lr_std = as_row(lr_mean), as_row(lr_std)

    def norm_hr(self, x):
        return (x - self.hr_mean) / self.hr_std

    def norm_lr(self, x):
        return (x - self.lr_mean) / self.lr_std

    def denorm_hr(self, x):
        return x * self.hr_std + self.hr_mean
