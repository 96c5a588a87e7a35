"""DAC primitives, channels-last ``[B, T, C]``: torch-semantics convs + Snake.

Port of the JAX package's ``models/dac/layers.py``.  Activations keep the
JAX layout; weights are in PyTorch's layouts (``models/from_jax.py``
permutes the JAX ``[K, Cin, Cout]`` kernels once): ``[Cout, Cin, K]`` for
:func:`conv1d`, ``[Cin, Cout, K]`` for :func:`conv1d_transpose`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bias_apart(x, b):
    """``(bias for the conv, bias added after it)``: in fp32 the conv adds
    it; in a narrower dtype it is added to the rounded product, as XLA adds
    it in the JAX package."""
    return (b, None) if x.dtype == torch.float32 else (None, b)


def conv1d(x, w, b=None, stride: int = 1, padding: int = 0,
           dilation: int = 1):
    """``F.conv1d`` on ``x [B, T, Cin]`` -> ``[B, T_out, Cout]``."""
    inner, after = _bias_apart(x, b)
    y = F.conv1d(x.transpose(1, 2), w, inner, stride=stride,
                 padding=padding, dilation=dilation).transpose(1, 2)
    return y if after is None else y + after


def conv1d_transpose(x, w, b=None, stride: int = 1, padding: int = 0,
                     output_padding: int = 0):
    """``F.conv_transpose1d`` on ``x [B, T, Cin]`` -> ``[B, T_out, Cout]``,
    ``T_out = (T-1)*stride - 2*padding + K + output_padding``."""
    inner, after = _bias_apart(x, b)
    y = F.conv_transpose1d(x.transpose(1, 2), w, inner, stride=stride,
                           padding=padding,
                           output_padding=output_padding).transpose(1, 2)
    return y if after is None else y + after


def snake(x, alpha):
    """Snake ``x + (1/(alpha + 1e-9)) * sin^2(alpha * x)``, fp32 inside."""
    xf = x.float()
    a = alpha.float()
    return (xf + (1.0 / (a + 1e-9)) * torch.sin(a * xf).square()).to(x.dtype)
