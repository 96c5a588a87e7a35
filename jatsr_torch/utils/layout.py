"""Layout helpers between the reference's ``[B, C, T]`` and the port's
time-major ``[B, T, C]``.

The port's copy of the JAX package's ``utils/layout.py``.  Each takes a
numpy array or a tensor and swaps its last two axes (a view for both).
"""

import numpy as np


def bct_to_btc(x):
    """``[B, C, T]`` (reference layout) -> ``[B, T, C]`` (the port's)."""
    return np.swapaxes(x, -1, -2) if isinstance(x, np.ndarray) \
        else x.swapaxes(-1, -2)


def btc_to_bct(x):
    """``[B, T, C]`` -> ``[B, C, T]``."""
    return np.swapaxes(x, -1, -2) if isinstance(x, np.ndarray) \
        else x.swapaxes(-1, -2)
