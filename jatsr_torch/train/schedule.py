"""LR schedule: linear warmup, then cosine decay to zero.

Port of ``warmup_cosine`` (JAX package, ``train/schedule.py``), evaluated on
the host in fp32 with the JAX function's order of operations, so the
optimizer never waits on the device for its learning rate.
"""

from __future__ import annotations

import numpy as np


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int):
    """``schedule(step) -> np.float32``: ``base_lr * step / warmup`` while
    ``step < warmup``, then ``base_lr/2 (1 + cos(pi progress))``."""
    f32 = np.float32

    def schedule(step: int) -> np.float32:
        s = f32(step)
        warm = f32(base_lr) * s / f32(max(1.0, warmup_steps))
        progress = (s - f32(warmup_steps)) / f32(max(1.0, total_steps
                                                      - warmup_steps))
        progress = np.clip(progress, f32(0.0), f32(1.0))
        cos = f32(base_lr * 0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress))
        return f32(warm if s < warmup_steps else cos)

    return schedule
