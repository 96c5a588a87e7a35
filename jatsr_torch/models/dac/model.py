"""Descript Audio Codec (44.1 kHz) decoder in PyTorch.

Port of the decode side of the JAX package's ``models/dac/model.py``:
``decoder_forward`` on the unfused fp32 conv path or, with
``fused_res_units``, through the fused decode kernels (``ops/dac_kernels``:
B8/B7 for the upsamples, B6 for a stage's residual units, B9 for a single
unit), and a decode-only :class:`DAC`.  The fused branches are taken
exactly where the JAX function takes them on a TPU, by the copied
eligibility gates; the C = 768 units of stage 0, ``conv_in`` and
``conv_out`` stay fp32 convolutions, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ...ops import dac_kernels as dk
from ...utils.device import resolve_device
from ..from_jax import dac_decoder_from_jax, dac_fused_pack
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


def _res_unit(p, x, dilation, packed=None, j=0):
    """Snake -> dilated 7-conv -> Snake -> 1x1 conv, residual add.

    ``packed`` (the block's fused weights, unit ``j``) routes an eligible
    shape through B9."""
    if packed is not None and "w7s" in packed:
        b, t, c = x.shape
        if dk.res_unit_supported(c, t, dilation):
            return dk.res_unit_fused(
                x, packed["w7s"][j], packed["b7s"][j], packed["w1s"][j],
                packed["b1s"][j], packed["a1s"][j], packed["a2s"][j],
                dilation=dilation)
    y = snake(x, p["alpha1"])
    y = conv1d(y, p["conv1"]["w"], p["conv1"]["b"], padding=3 * dilation,
               dilation=dilation)
    y = snake(y, p["alpha2"])
    y = conv1d(y, p["conv2"]["w"], p["conv2"]["b"])
    return x + y


def _snake_upsample(blk, packed, x, stride):
    """snake -> conv_transpose through B7 (or B8) where the stage is
    eligible; None otherwise."""
    b, t, c = x.shape
    w = packed["up_w"]
    if not dk.conv_transpose_supported(c, w.shape[2], stride, w.shape[0], t):
        return None
    return dk.snake_conv_transpose_fused(
        x, w, blk["up"]["b"], blk["alpha"], stride=stride,
        padding=math.ceil(stride / 2), output_padding=stride % 2)


def _res_stage(packed, x):
    """The three residual units of a block through B6; None where the
    shape is not eligible."""
    b, t, c = x.shape
    if "w7s" not in packed or not dk.res_stage_supported(c, t):
        return None
    return dk.res_stage_fused(x, packed["w7s"], packed["b7s"],
                              packed["w1s"], packed["b1s"], packed["a1s"],
                              packed["a2s"])


def decoder_forward(dec: Dict, z: torch.Tensor, cfg: DACConfig,
                    fused_res_units: bool = False) -> torch.Tensor:
    """``z [B, T, latent_dim]`` -> waveform ``[B, T*hop, 1]`` in [-1, 1].

    ``dec`` holds PyTorch conv layouts (``from_jax.dac_decoder_from_jax``);
    ``fused_res_units`` needs each block's ``"fused"`` weights
    (``from_jax.dac_fused_pack``, as :class:`DAC` packs them).
    """
    fused = fused_res_units and z.dtype == torch.float32
    x = conv1d(z, dec["conv_in"]["w"], dec["conv_in"]["b"], padding=3)
    for i, stride in enumerate(cfg.decoder_rates):
        blk = dec[f"block_{i}"]
        packed = None
        if fused:
            if "fused" not in blk:
                raise ValueError("fused_res_units needs the packed weights "
                                 "of from_jax.dac_fused_pack (DAC packs them)")
            packed = blk["fused"]
        up = _snake_upsample(blk, packed, x, stride) if fused else None
        if up is not None:
            x = up
        else:
            x = snake(x, blk["alpha"])
            x = conv1d_transpose(x, blk["up"]["w"], blk["up"]["b"],
                                 stride=stride, padding=math.ceil(stride / 2),
                                 output_padding=stride % 2)
        y = _res_stage(packed, x) if fused else None
        if y is not None:
            x = y
        else:
            for j, dil in enumerate((1, 3, 9)):
                x = _res_unit(blk[f"res_{j}"], x, dil, packed, j)
    x = snake(x, dec["alpha_out"])
    x = conv1d(x, dec["conv_out"]["w"], dec["conv_out"]["b"], padding=3)
    return torch.tanh(x)


class DAC:
    """Frozen decode-only codec.

    Args:
        decoder_params: the JAX-layout decoder dict (numpy or tensors).
        cfg: the codec geometry.
        fused_res_units: decode through the fused kernels (B6-B9, as
            ``bench.py --fused-decode``); their bf16 weights are packed
            once, here.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.
    """

    def __init__(self, decoder_params: Dict, cfg: DACConfig | None = None,
                 fused_res_units: bool = False, device="cuda"):
        self.cfg = cfg or DACConfig()
        self.device = resolve_device(device)
        self.fused_res_units = fused_res_units
        self.decoder = dac_decoder_from_jax(decoder_params, self.device)
        if fused_res_units:
            for name, packed in dac_fused_pack(decoder_params,
                                               self.device).items():
                self.decoder[name]["fused"] = packed

    @classmethod
    def random_init(cls, seed: int = 0, cfg: DACConfig | None = None,
                    fused_res_units: bool = False, device="cuda") -> "DAC":
        cfg = cfg or DACConfig()
        return cls(init_decoder_params(cfg, seed), cfg,
                   fused_res_units=fused_res_units, device=device)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, T, latent]`` -> ``[B, T*hop, 1]`` fp32."""
        return decoder_forward(self.decoder, z.float(), self.cfg,
                               fused_res_units=self.fused_res_units)
