"""The DiT's int8 serving forward in PyTorch.

Port of the JAX package's ``models/dit.py`` on one serving branch: the
``int8_static`` DiT with fused QKV, the flash-QKV attention kernel, the
"half" fused MLP and the fused patch embed, without the fused prologue
(``bench.py --no-fused-prologue``).  Inputs are time-major ``[B, T, C]``;
the residual stream is bf16; the output is fp32.  Module names mirror the
JAX modules (``patch_in``, ``blocks[i].attn.qkv_proj``, ``final_proj``...).

Any serving knob that would send the JAX model down another branch raises
``NotImplementedError`` (:func:`check_serving_config`): the port never takes
a different branch silently.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ModelConfig
from ..ops.attention import flash_supported, gqa_attention_flash_qkv
from ..ops.int8_matmul import int8_dense_gelu_quant, int8_mm
from ..ops.quant import QuantDense
from ..utils.device import resolve_device
from .from_jax import tree_to_torch

# ModelConfig fields that select a branch, with the value this slice ports
# and the later slice that brings the other values.
_SERVING_BRANCH = {
    "matmul_precision": ("int8_static", "the bf16 and dynamic-int8 paths"),
    "dtype": ("bfloat16", "other compute dtypes"),
    "pos_embed": ("rope", "learned positions (v1legacy)"),
    "fused_qkv": (True, "the split q/k/v projections"),
    "attention_impl": ("flash", "the einsum and pallas attention paths"),
    "flash_qkv": (True, "the split-input flash kernel (B11)"),
    "flash_fused_out": (False, "the fused out-projection kernel (B12)"),
    "flash_int8_qk": (False, "the int8 value product of the flash kernel"),
    "fused_mlp": (True, "the unfused QuantDense MLP"),
    "fused_mlp_impl": ("half", "the whole-MLP kernel (B13)"),
    "fused_prologue": (False, "the prologue kernels (B1, B3, B4)"),
    "align_n": (False, "the prologue slice's aligned patch count"),
    "int8_impl": ("xla", "the pallas and fused W8A8 kernels (B4, B14)"),
    "quantize_head": (False, "the int8 output head"),
}


def check_serving_config(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside this slice."""
    for name, (want, later) in _SERVING_BRANCH.items():
        have = getattr(cfg, name)
        if have != want:
            raise NotImplementedError(
                f"ModelConfig.{name}={have!r} selects {later}, which a later "
                f"slice of the port brings; this slice serves {name}={want!r}")
    if cfg.gelu_impl not in ("tanh", "erf", "sigmoid"):
        raise ValueError(f"unknown gelu_impl {cfg.gelu_impl!r}")


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``[sin | cos]`` of ``t [B]`` against ``exp(-log(1e4) i / (dim/2 - 1))``,
    fp32."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32,
                                            device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope_cos_sin(seq_len: int, dim: int, base: float = 10000.0,
                 device=None):
    """RoPE tables ``[N, dim]`` fp32, half-rotation layout."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Affine-free LayerNorm / RMSNorm, eps 1e-6: statistics in fp32
    (``var = E[x^2] - E[x]^2``, clipped at 0), output in x's dtype."""
    xf = x.float()
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    if kind == "rms":
        y = xf * torch.rsqrt(mu2 + 1e-6)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return y.to(x.dtype)


class Dense(nn.Module):
    """``x @ kernel + bias`` in ``dtype``, kernel in the JAX ``[in, out]``
    layout (cast once here, as flax casts before the product)."""

    def __init__(self, kernel, bias, dtype):
        super().__init__()
        self.register_buffer("kernel", kernel.to(dtype))
        self.register_buffer("bias", None if bias is None else bias.to(dtype))
        self.dtype = dtype

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel
        return y if self.bias is None else y + self.bias


def _int8_dense_gelu_dense(x2d, first: QuantDense, second: QuantDense,
                           gelu_impl="tanh", fast_epilogue=True):
    """The fused Dense-GELU-Dense of the patch embed and the block MLP:
    the int8 kernel for the first half, an exact s8 product and an fp32
    dequant for the second; bf16 out."""
    g_q, g_s = int8_dense_gelu_quant(
        x2d, first.kernel_q, first.kernel_scale, first.bias.float(),
        gelu_impl=gelu_impl, fast_epilogue=fast_epilogue)
    acc = int8_mm(g_q, second.kernel_q).float()
    return (acc * g_s * second.kernel_scale + second.bias.float()
            ).to(torch.bfloat16)


def _quant_dense(p: dict, i=None) -> QuantDense:
    """The int8_static leaf ``p`` (layer ``i`` of a stacked one) as a
    QuantDense."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    b = p.get("bias")
    return QuantDense(pick(p["kernel_q"]), pick(p["kernel_scale"]),
                      None if b is None else pick(b))


class GQAttention(nn.Module):
    """Fused qkv projection, flash-QKV attention (RoPE inside the kernel),
    out projection."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int):
        super().__init__()
        self.cfg = cfg
        self.qkv_proj = _quant_dense(p["qkv_proj"], i)
        self.out_proj = _quant_dense(p["out_proj"], i)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        qkv = self.qkv_proj(x)
        out = gqa_attention_flash_qkv(qkv, cos, sin, cfg.num_q_heads,
                                      cfg.num_kv_heads,
                                      n_valid=cfg.attn_valid_len)
        return self.out_proj(out)


class DiTBlock(nn.Module):
    """AdaLN-Zero block: norm, modulate, attention, gate; norm, modulate,
    half-fused MLP, gate.  ``mod`` is the block's ``[B or 1, 6H]`` AdaLN
    row (the hoisted table, or computed here from ``t_emb``)."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, adaln: Dense):
        super().__init__()
        self.cfg = cfg
        self.attn = GQAttention(cfg, p["attn"], i)
        self.mlp_in = _quant_dense(p["mlp_in"], i)
        self.mlp_out = _quant_dense(p["mlp_out"], i)
        self.adaln = adaln

    def forward(self, x, t_emb, cos, sin, mod=None):
        cfg = self.cfg
        if mod is None:
            mod = self.adaln(F.silu(t_emb))
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = (m[:, None, :]
                                            for m in mod.chunk(6, dim=-1))
        h = _norm(x, cfg.norm) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn(h, cos, sin)
        h = _norm(x, cfg.norm) * (1 + scale_mlp) + shift_mlp
        B, N, H = h.shape
        h = _int8_dense_gelu_dense(h.reshape(B * N, H), self.mlp_in,
                                   self.mlp_out, cfg.gelu_impl,
                                   cfg.fast_epilogue).reshape(B, N, H)
        return x + gate_mlp * h


class DiT(nn.Module):
    """x0-prediction DiT over DAC latents, int8 serving forward.

    Args:
        cfg: the model config; must be on this slice's serving branch.
        params: the JAX int8_static param tree (``blocks`` stacked
            ``[depth, ...]``) as nested dicts of numpy arrays or tensors;
            see ``models/from_jax.py``.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.
    """

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda"):
        super().__init__()
        check_serving_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        P, C = cfg.patch_len, cfg.input_channels
        if (P * 2 * C) % 128 or cfg.bottleneck_dim % 128:
            raise NotImplementedError(
                "the unfused patch embed (patch width or bottleneck not a "
                "multiple of 128) comes with the bf16 path, a later slice")
        p = tree_to_torch(params, self.device)
        bf16, f32 = torch.bfloat16, torch.float32
        self.patch_in = _quant_dense(p["patch_in"])
        self.patch_out = _quant_dense(p["patch_out"])
        self.t_mlp1 = Dense(p["t_mlp1"]["kernel"], p["t_mlp1"]["bias"], f32)
        self.t_mlp2 = Dense(p["t_mlp2"]["kernel"], p["t_mlp2"]["bias"], f32)
        blocks = p["blocks"]
        self.register_buffer("adaln_kernel", blocks["adaln"]["kernel"].to(bf16))
        self.register_buffer("adaln_bias", blocks["adaln"]["bias"].to(bf16))
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, blocks, i,
                     Dense(self.adaln_kernel[i], self.adaln_bias[i], bf16))
            for i in range(cfg.depth))
        self.final_proj = Dense(p["final_proj"]["kernel"],
                                p["final_proj"]["bias"], bf16)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """fp32 t-MLP over the sinusoid; bf16 out."""
        te = self.t_mlp1(sinusoidal_time_embedding(t, self.cfg.hidden_size))
        return self.t_mlp2(F.silu(te)).to(torch.bfloat16)

    @torch.no_grad()
    def forward(self, x_t, t, x_cond, adaln_mod=None):
        """``x_t``, ``x_cond``: [B, T, C]; ``t``: [B]; ``adaln_mod``:
        optional hoisted tables ``[depth, B or 1, 6H]``.  Returns the
        predicted clean latent [B, T, C] fp32."""
        cfg = self.cfg
        B, T_orig, C = x_t.shape
        if C != cfg.input_channels:
            raise ValueError(f"expected {cfg.input_channels} channels, got {C}")
        P = cfg.patch_len
        x_t = x_t.to(torch.bfloat16)
        x_cond = x_cond.to(torch.bfloat16)
        pad = (-T_orig) % P
        if pad:
            x_t = F.pad(x_t, (0, 0, 0, pad))
            x_cond = F.pad(x_cond, (0, 0, 0, pad))
        T = T_orig + pad
        N = T // P
        if N > cfg.max_len:
            raise ValueError(f"sequence length {N} exceeds max_len {cfg.max_len}")
        if not flash_supported(N, cfg.num_q_heads, cfg.num_kv_heads,
                               cfg.head_dim):
            raise NotImplementedError(
                f"N={N} patches exceed the flash kernels' budget; the JAX "
                f"model takes its einsum attention there, a later slice")

        x_in = torch.cat([x_t, x_cond], dim=-1).reshape(B * N, P * 2 * C)
        # The JAX model passes no gelu knobs to the patch embed: tanh, fp32.
        h = _int8_dense_gelu_dense(x_in, self.patch_in, self.patch_out)
        h = h.reshape(B, N, cfg.hidden_size)

        t_emb = None if adaln_mod is not None else self.time_embedding(t)
        cos, sin = rope_cos_sin(N, cfg.head_dim, cfg.rope_base, h.device)
        for i, blk in enumerate(self.blocks):
            h = blk(h, t_emb, cos, sin,
                    None if adaln_mod is None else adaln_mod[i])

        h = self.final_proj(_norm(h, cfg.norm))
        return h.reshape(B, T, C)[:, :T_orig].float()


@torch.no_grad()
def adaln_tables(model: DiT, t: torch.Tensor) -> torch.Tensor:
    """Every layer's AdaLN modulation for flow times ``t [B]``:
    ``[depth, B, 6H]`` bf16, the rows each block's adaln Dense would give."""
    a = F.silu(model.time_embedding(t))
    return (torch.einsum("bh,dhm->dbm", a, model.adaln_kernel)
            + model.adaln_bias[:, None, :])
