"""Descript Audio Codec (44.1 kHz) decoder in PyTorch.

Port of the decode side of the JAX package's ``models/dac/model.py``:
``decoder_forward`` on the unfused conv path, fp32 throughout, and a
decode-only :class:`DAC`.  The fused residual-unit and conv-transpose
kernels come with the DAC kernels slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from ..from_jax import dac_decoder_from_jax
from .layers import conv1d, conv1d_transpose, snake


@dataclass(frozen=True)
class DACConfig:
    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))


def init_decoder_params(cfg: DACConfig, seed: int = 0) -> Dict:
    """Random decoder weights in the JAX layout (``{"w": [K, Cin, Cout],
    "b", "alpha"}``), numpy fp32: uniform(+-1/sqrt(fan_in)) kernels, zero
    biases, unit alphas, as the JAX initializer draws them."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        lim = 1.0 / math.sqrt(cin * k)
        return {"w": rng.uniform(-lim, lim, (k, cin, cout)).astype(np.float32),
                "b": np.zeros((cout,), np.float32)}

    def ones(c):
        return np.ones((c,), np.float32)

    dec = {"conv_in": conv(7, cfg.latent_dim, cfg.decoder_dim)}
    ch = cfg.decoder_dim
    for i, stride in enumerate(cfg.decoder_rates):
        cin, cout = ch // (2 ** i), ch // (2 ** (i + 1))
        blk = {"alpha": ones(cin), "up": conv(2 * stride, cin, cout)}
        for j in range(3):
            blk[f"res_{j}"] = {"alpha1": ones(cout), "conv1": conv(7, cout, cout),
                               "alpha2": ones(cout), "conv2": conv(1, cout, cout)}
        dec[f"block_{i}"] = blk
    last = ch // (2 ** len(cfg.decoder_rates))
    dec["alpha_out"] = ones(last)
    dec["conv_out"] = conv(7, last, 1)
    return dec


def _res_unit(p, x, dilation):
    """Snake -> dilated 7-conv -> Snake -> 1x1 conv, residual add."""
    y = snake(x, p["alpha1"])
    y = conv1d(y, p["conv1"]["w"], p["conv1"]["b"], padding=3 * dilation,
               dilation=dilation)
    y = snake(y, p["alpha2"])
    y = conv1d(y, p["conv2"]["w"], p["conv2"]["b"])
    return x + y


def decoder_forward(dec: Dict, z: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """``z [B, T, latent_dim]`` -> waveform ``[B, T*hop, 1]`` in [-1, 1].

    ``dec`` holds PyTorch conv layouts (``from_jax.dac_decoder_from_jax``).
    """
    x = conv1d(z, dec["conv_in"]["w"], dec["conv_in"]["b"], padding=3)
    for i, stride in enumerate(cfg.decoder_rates):
        blk = dec[f"block_{i}"]
        x = snake(x, blk["alpha"])
        x = conv1d_transpose(x, blk["up"]["w"], blk["up"]["b"], stride=stride,
                             padding=math.ceil(stride / 2),
                             output_padding=stride % 2)
        for j, dil in enumerate((1, 3, 9)):
            x = _res_unit(blk[f"res_{j}"], x, dil)
    x = snake(x, dec["alpha_out"])
    x = conv1d(x, dec["conv_out"]["w"], dec["conv_out"]["b"], padding=3)
    return torch.tanh(x)


class DAC:
    """Frozen decode-only codec.

    Args:
        decoder_params: the JAX-layout decoder dict (numpy or tensors).
        cfg: the codec geometry.
        fused_res_units: the fused decode kernels; a later slice.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.
    """

    def __init__(self, decoder_params: Dict, cfg: DACConfig | None = None,
                 fused_res_units: bool = False, device="cuda"):
        if fused_res_units:
            raise NotImplementedError(
                "fused_res_units: the fused DAC decode kernels (B6-B9) come "
                "with the DAC kernels slice")
        self.cfg = cfg or DACConfig()
        self.device = resolve_device(device)
        self.decoder = dac_decoder_from_jax(decoder_params, self.device)

    @classmethod
    def random_init(cls, seed: int = 0, cfg: DACConfig | None = None,
                    device="cuda") -> "DAC":
        cfg = cfg or DACConfig()
        return cls(init_decoder_params(cfg, seed), cfg, device=device)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, T, latent]`` -> ``[B, T*hop, 1]`` fp32."""
        return decoder_forward(self.decoder, z.float(), self.cfg)
