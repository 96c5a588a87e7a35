"""Descript Audio Codec (44.1 kHz) in PyTorch: encoder, residual VQ, decoder.

Port of the JAX package's ``models/dac/model.py``:

- ``encoder_forward``: fp32 convolutions and Snake; its residual units are
  never fused (the JAX encoder calls them without ``fused``);
- ``quantize``: the residual VQ, a cosine-similarity argmax per codebook
  (each vector divided by its norm + 1e-12, fp32 products, ties to the
  first index, int32 codes), and ``decode_codes``;
- ``decoder_forward`` on the unfused conv path or, with
  ``fused_res_units``, through the fused decode kernels
  (``ops/dac_kernels``: B8/B7 for the upsamples, B6 for a stage's residual
  units, B9 for a single unit).  The fused branches are taken exactly
  where the JAX function takes them on a TPU, by the copied eligibility
  gates; the C = 768 units of stage 0, ``conv_in`` and ``conv_out`` stay
  fp32 convolutions, as in the JAX package.  A bf16 decode
  (``compute_dtype``) runs every conv unfused, in bf16.

These are plain convolutions and products that the JAX package leaves to
XLA, so they stay ``F.conv1d`` and ``torch.matmul`` here.
"""

from __future__ import annotations

import copy
import math
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops import dac_kernels as dk
from ...utils.device import resolve_device
from ..from_jax import dac_fused_pack, dac_tree_from_jax
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


def _conv(rng, k, cin, cout):
    """A random conv in the JAX layout: uniform(+-1/sqrt(fan_in)) kernel
    ``[K, Cin, Cout]``, zero bias."""
    lim = 1.0 / math.sqrt(cin * k)
    return {"w": rng.uniform(-lim, lim, (k, cin, cout)).astype(np.float32),
            "b": np.zeros((cout,), np.float32)}


def _ones(c):
    return np.ones((c,), np.float32)


def _res_unit_params(rng, c):
    return {"alpha1": _ones(c), "conv1": _conv(rng, 7, c, c),
            "alpha2": _ones(c), "conv2": _conv(rng, 1, c, c)}


def init_decoder_params(cfg: DACConfig, seed: int = 0) -> Dict:
    """Random decoder weights in the JAX layout (``{"w": [K, Cin, Cout],
    "b", "alpha"}``), numpy fp32: uniform(+-1/sqrt(fan_in)) kernels, zero
    biases, unit alphas, as the JAX initializer draws them."""
    rng = np.random.default_rng(seed)
    dec = {"conv_in": _conv(rng, 7, cfg.latent_dim, cfg.decoder_dim)}
    ch = cfg.decoder_dim
    for i, stride in enumerate(cfg.decoder_rates):
        cin, cout = ch // (2 ** i), ch // (2 ** (i + 1))
        blk = {"alpha": _ones(cin), "up": _conv(rng, 2 * stride, cin, cout)}
        for j in range(3):
            blk[f"res_{j}"] = _res_unit_params(rng, cout)
        dec[f"block_{i}"] = blk
    last = ch // (2 ** len(cfg.decoder_rates))
    dec["alpha_out"] = _ones(last)
    dec["conv_out"] = _conv(rng, 7, last, 1)
    return dec


def init_params(cfg: DACConfig, seed: int = 0) -> Dict:
    """Random weights of the whole codec in the JAX layout,
    ``{"encoder", "quantizer", "decoder"}``, numpy fp32, drawn as the JAX
    initializer draws them (codebooks standard normal).  The decoder is
    :func:`init_decoder_params` of the same seed; the encoder and the
    quantizer come from a second stream of it."""
    rng = np.random.default_rng([seed, 1])
    d = cfg.encoder_dim
    enc = {"conv_in": _conv(rng, 7, 1, d)}
    for i, stride in enumerate(cfg.encoder_rates):
        d *= 2
        blk = {f"res_{j}": _res_unit_params(rng, d // 2) for j in range(3)}
        blk["alpha"] = _ones(d // 2)
        blk["down"] = _conv(rng, 2 * stride, d // 2, d)
        enc[f"block_{i}"] = blk
    enc["alpha_out"] = _ones(d)
    enc["conv_out"] = _conv(rng, 3, d, cfg.latent_dim)
    quantizer = {f"vq_{q}": {
        "in_proj": _conv(rng, 1, cfg.latent_dim, cfg.codebook_dim),
        "out_proj": _conv(rng, 1, cfg.codebook_dim, cfg.latent_dim),
        "codebook": rng.standard_normal(
            (cfg.codebook_size, cfg.codebook_dim)).astype(np.float32)}
        for q in range(cfg.n_codebooks)}
    return {"encoder": enc, "quantizer": quantizer,
            "decoder": init_decoder_params(cfg, seed)}


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


def encoder_forward(enc: Dict, audio: torch.Tensor,
                    cfg: DACConfig) -> torch.Tensor:
    """``audio [B, T, 1]`` (T a multiple of the hop) -> ``z_e [B, T/hop,
    latent_dim]``.  ``enc`` holds PyTorch conv layouts
    (``from_jax.dac_tree_from_jax``).  The residual units take the conv
    path at every width: the JAX encoder never fuses them."""
    x = conv1d(audio, enc["conv_in"]["w"], enc["conv_in"]["b"], padding=3)
    for i, stride in enumerate(cfg.encoder_rates):
        blk = enc[f"block_{i}"]
        for j, dil in enumerate((1, 3, 9)):
            x = _res_unit(blk[f"res_{j}"], x, dil)
        x = snake(x, blk["alpha"])
        x = conv1d(x, blk["down"]["w"], blk["down"]["b"], stride=stride,
                   padding=math.ceil(stride / 2))
    x = snake(x, enc["alpha_out"])
    return conv1d(x, enc["conv_out"]["w"], enc["conv_out"]["b"], padding=1)


def _unit_norm(x: torch.Tensor) -> torch.Tensor:
    """``x / (|x| + 1e-12)`` over the last axis (the JAX form; not
    ``F.normalize``, which clamps the norm instead)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def quantize(quantizer: Dict, z_e: torch.Tensor, cfg: DACConfig,
             n_quantizers: Optional[int] = None):
    """Residual VQ of ``z_e [B, T, latent_dim]``.

    Each codebook's code is the argmax of the cosine similarity between the
    projected residual and the codebook rows (an fp32 product; ties go to
    the first index); its unnormalised row, projected back, is added to
    ``z_q`` and taken from the residual.  Returns ``(z_q [B, T,
    latent_dim], codes int32 [B, T, n])``."""
    n = n_quantizers or cfg.n_codebooks
    z_q = torch.zeros_like(z_e)
    residual = z_e
    codes = []
    for qi in range(n):
        p = quantizer[f"vq_{qi}"]
        latents = conv1d(residual, p["in_proj"]["w"], p["in_proj"]["b"])
        cb = p["codebook"]
        idx = (_unit_norm(latents) @ _unit_norm(cb).t()).argmax(dim=-1)
        z_q_i = conv1d(cb[idx], p["out_proj"]["w"], p["out_proj"]["b"])
        z_q = z_q + z_q_i
        residual = residual - z_q_i
        codes.append(idx)
    return z_q, torch.stack(codes, dim=-1).to(torch.int32)


def decode_codes(quantizer: Dict, codes: torch.Tensor,
                 cfg: DACConfig) -> torch.Tensor:
    """``codes [B, T, n]`` -> the quantised ``z [B, T, latent_dim]``."""
    z_q = None
    for qi in range(codes.shape[-1]):
        p = quantizer[f"vq_{qi}"]
        z_q_i = conv1d(p["codebook"][codes[..., qi].long()],
                       p["out_proj"]["w"], p["out_proj"]["b"])
        z_q = z_q_i if z_q is None else z_q + z_q_i
    return z_q


def decoder_forward(dec: Dict, z: torch.Tensor, cfg: DACConfig,
                    fused_res_units: bool = False) -> torch.Tensor:
    """``z [B, T, latent_dim]`` -> waveform ``[B, T*hop, 1]`` in [-1, 1].

    ``dec`` holds PyTorch conv layouts (``from_jax.dac_tree_from_jax``);
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


def _tree_to(tree: Dict, device) -> Dict:
    """A nested dict of tensors with every tensor copied to ``device``."""
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class DAC:
    """Frozen codec: encode, quantize and decode on the codec's device.

    Args:
        params: the JAX-layout weights (numpy or tensors): the whole codec
            ``{"encoder", "quantizer", "decoder"}``, or the decoder dict
            alone for a decode-only codec.
        cfg: the codec geometry.
        fused_res_units: decode through the fused kernels (B6-B9, as
            ``bench.py --fused-decode``); their bf16 weights are packed
            once, here.  fp32 only: with a bf16 ``compute_dtype`` the
            decoder takes the conv path, with a warning, as in the JAX
            package.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.
        compute_dtype: ``torch.bfloat16`` runs the decoder's convs in bf16
            (weights cast once here; Snake in fp32 inside; fp32 out).  The
            encoder and the quantizer stay fp32.
    """

    def __init__(self, params: Dict, cfg: DACConfig | None = None,
                 fused_res_units: bool = False, device="cuda",
                 compute_dtype: Optional[torch.dtype] = None):
        self.cfg = cfg or DACConfig()
        self.device = resolve_device(device)
        self.dtype = compute_dtype or torch.float32
        self.fused_res_units = fused_res_units
        if fused_res_units and self.dtype != torch.float32:
            warnings.warn(
                "fused_res_units requires fp32 decode; the compute_dtype="
                f"{self.dtype} decoder will use the unfused conv path (drop "
                "compute_dtype to enable the fused kernels)", stacklevel=2)
        whole = "decoder" in params
        dec = params["decoder"] if whole else params
        self.encoder = (dac_tree_from_jax(params["encoder"], self.device)
                        if whole else None)
        self.quantizer = (dac_tree_from_jax(params["quantizer"], self.device)
                          if whole else None)
        self.decoder = dac_tree_from_jax(dec, self.device, self.dtype)
        if fused_res_units and self.dtype == torch.float32:
            for name, packed in dac_fused_pack(dec, self.device).items():
                self.decoder[name]["fused"] = packed

    def decoder_copy(self, device) -> "DAC":
        """A decode-only copy of this codec on ``device``: its decoder
        weights (the fused kernels' packs too) copied there."""
        out = copy.copy(self)
        out.device = resolve_device(device)
        out.encoder = out.quantizer = None
        out.decoder = _tree_to(self.decoder, out.device)
        return out

    @classmethod
    def random_init(cls, seed: int = 0, cfg: DACConfig | None = None,
                    fused_res_units: bool = False, device="cuda",
                    compute_dtype: Optional[torch.dtype] = None) -> "DAC":
        cfg = cfg or DACConfig()
        return cls(init_params(cfg, seed), cfg,
                   fused_res_units=fused_res_units, device=device,
                   compute_dtype=compute_dtype)

    def _need_encoder(self):
        if self.encoder is None:
            raise ValueError("this codec was built from decoder weights "
                             "only; encoding needs the whole codec's")

    def pad_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """``[B, T, 1]`` zero-padded at the end to a multiple of the hop."""
        return F.pad(audio, (0, 0, 0, (-audio.shape[1]) % self.cfg.hop_length))

    def _audio(self, audio) -> torch.Tensor:
        a = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        return self.pad_audio(a)

    @torch.no_grad()
    def encode(self, audio):
        """``[B, T, 1]`` -> ``(z [B, ceil(T/hop), latent], codes int32 [B,
        ceil(T/hop), n_codebooks])``: the quantised latent and its codes."""
        self._need_encoder()
        z_e = encoder_forward(self.encoder, self._audio(audio), self.cfg)
        return quantize(self.quantizer, z_e, self.cfg)

    @torch.no_grad()
    def encode_continuous(self, audio) -> torch.Tensor:
        """``[B, T, 1]`` -> the encoder's output ``z_e``, unquantised."""
        self._need_encoder()
        return encoder_forward(self.encoder, self._audio(audio), self.cfg)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, T, latent]`` -> ``[B, T*hop, 1]`` fp32."""
        return decoder_forward(self.decoder, z.to(self.dtype), self.cfg,
                               fused_res_units=self.fused_res_units).float()

    @torch.no_grad()
    def decode_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, T, n_codebooks]`` codes -> ``[B, T*hop, 1]`` fp32."""
        self._need_encoder()
        codes = torch.as_tensor(codes).to(self.device)
        return self.decode(decode_codes(self.quantizer, codes, self.cfg))
