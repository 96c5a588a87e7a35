"""Latent statistics for the dataset.

The port's copy of ``load_stats`` from the JAX package's
``data/dataset.py``; the rest of that file (the latent dataset and its
loaders) comes with training.
"""

from __future__ import annotations

import json

import numpy as np


def load_stats(path: str):
    """Normalization stats JSON -> ``(hr_mean, hr_std, lr_mean, lr_std)``,
    each float32 ``[C]``."""
    with open(path) as f:
        d = json.load(f)
    return tuple(np.asarray(d[k], np.float32)
                 for k in ("hr_mean", "hr_std", "lr_mean", "lr_std"))
