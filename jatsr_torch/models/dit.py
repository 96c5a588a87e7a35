"""The DiT in PyTorch: the int8 serving forward and the trainable bf16 model.

Port of the JAX package's ``models/dit.py``.  :class:`DenseDiT` is the
branch the JAX model trains with (``matmul_precision="bf16"``, split q/k/v):
fp32 parameters cast to bf16 at each product, dropout and drop-path, the
training attention kernel (B10) or the einsum attention, remat per block;
its deterministic (eval) forward takes the serving attention the JAX model
takes there.

:class:`DiT` is the int8 serving branch:
the ``int8_static`` DiT with fused QKV, the "half" fused MLP and the fused
patch embed, with or without the fused prologue (``fused_prologue``, with
``align_n``: ``bench.py``'s default DiT; ``bench.py --no-fused-prologue``
without it); the opt-in knobs ``flash_fused_out`` (attention with the int8
out projection inside), ``fused_mlp_impl="full"`` (the whole MLP in one
kernel) and ``int8_impl="pallas"`` (the s8 kernel on a pre-quantised A).
Its attention is the flash-QKV kernel on the fused projection, or, on the
split q/k/v (``flash_qkv=False``, ``attention_impl`` "pallas", "pallas2" or
"xla", or past the flash budget), the split flash kernel, the per-q-head or
per-kv-head kernel, or the einsum.  Inputs are time-major
``[B, T, C]``; the residual stream is bf16; the output is fp32.  Module
names mirror the JAX modules (``patch_in``, ``blocks[i].attn.qkv_proj``,
``final_proj``...).

Any serving knob that would send the JAX model down another branch raises
``NotImplementedError`` (:func:`check_serving_config`): the port never takes
a different branch silently.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..configs import ModelConfig
from ..ops.attention import (_rope, flash_out_weight_t, flash_supported,
                             gqa_attention, gqa_attention_flash,
                             gqa_attention_flash_out, gqa_attention_flash_qkv,
                             gqa_attention_grouped, padded_head_dim)
from ..ops.attention_train import gqa_attention_train, train_flash_supported
from ..ops.int8_matmul import (int8_dense_gelu_quant, int8_matmul_fused,
                               int8_mlp, int8_mm)
from ..ops.prologue import (int8_norm_mod_dense_gelu_quant,
                            int8_norm_mod_dot, norm_mod_dot_supported)
from ..ops.quant import QuantDense
from ..sampling.flow import linspace_f32
from ..utils.device import resolve_device
from .from_jax import init_dense_params, tree_to_torch

# ModelConfig fields that select a branch, with the values the port serves
# and the later slice that brings the others.
_SERVING_BRANCH = {
    "matmul_precision": (("int8_static",), "the bf16 and dynamic-int8 paths"),
    "dtype": (("bfloat16",), "other compute dtypes"),
    "pos_embed": (("rope",), "learned positions (v1legacy)"),
    "fused_qkv": ((True,), "the split q/k/v projections"),
    "attention_impl": (("flash", "pallas", "pallas2", "xla"),
                       "other attention"),
    "flash_int8_qk": ((False,), "the int8 value product of the flash kernel"),
    "fused_mlp": ((True,), "the unfused QuantDense MLP"),
    "quantize_head": ((False,), "the int8 output head"),
}


def check_serving_config(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported
    branches."""
    for name, (served, later) in _SERVING_BRANCH.items():
        have = getattr(cfg, name)
        if have not in served:
            raise NotImplementedError(
                f"ModelConfig.{name}={have!r} selects {later}, which a later "
                f"slice of the port brings; the port serves {name} in "
                f"{served!r}")
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


def _dequant_dense(g_q, g_s, second: QuantDense):
    """The fused MLP's second half: an exact s8 product of the codes
    ``g_q [..., K]`` with row scales ``g_s [..., 1]``, then
    ``((acc * g_s) * ws + b) -> bf16``."""
    lead = g_q.shape[:-1]
    acc = int8_mm(g_q.reshape(-1, g_q.shape[-1]), second.kernel_q).float()
    acc = acc.reshape(*lead, -1)
    return (acc * g_s * second.kernel_scale + second.bias.float()
            ).to(torch.bfloat16)


def _int8_dense_gelu_dense(x2d, first: QuantDense, second: QuantDense,
                           first_t, gelu_impl="tanh", fast_epilogue=True):
    """The fused Dense-GELU-Dense of the patch embed and the block MLP:
    the int8 kernel for the first half (on ``first_t``, the first kernel
    K-major, as the card's kernel reads it), an exact s8 product and an
    fp32 dequant for the second; bf16 out."""
    g_q, g_s = int8_dense_gelu_quant(
        x2d, first.kernel_q, first.kernel_scale, first.bias.float(),
        gelu_impl=gelu_impl, fast_epilogue=fast_epilogue, w_t=first_t)
    return _dequant_dense(g_q, g_s, second)


def _quant_dense(p: dict, i=None, int8_impl="xla") -> QuantDense:
    """The int8_static leaf ``p`` (layer ``i`` of a stacked one) as a
    QuantDense."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    b = p.get("bias")
    return QuantDense(pick(p["kernel_q"]), pick(p["kernel_scale"]),
                      None if b is None else pick(b), int8_impl)


def fused_prologue_taken(cfg: ModelConfig, n: int) -> bool:
    """Whether the JAX block takes its fused-prologue branch at ``n``
    patches on the deterministic path: the JAX conjunction of knobs, then
    the kernels' eligibility gate for the qkv and mlp_in widths."""
    H = cfg.hidden_size
    qkv_out = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return (cfg.fused_prologue and cfg.matmul_precision == "int8_static"
            and cfg.fused_qkv and cfg.fused_mlp
            and cfg.fused_mlp_impl == "half"
            and cfg.attention_impl == "flash" and cfg.flash_qkv
            and not cfg.flash_fused_out and cfg.pos_embed == "rope"
            and norm_mod_dot_supported(n, H, qkv_out)
            and norm_mod_dot_supported(n, H, int(H * cfg.mlp_ratio)))


def align_n_taken(cfg: ModelConfig) -> bool:
    """Whether the JAX model pads the patch count to a multiple of 8 (and
    masks the padded keys): the JAX conjunction of knobs, on the
    deterministic path.  Only the flash-QKV kernels mask keys."""
    return (cfg.attention_impl == "flash" and cfg.pos_embed == "rope"
            and cfg.fused_qkv and cfg.matmul_precision == "int8_static"
            and cfg.align_n and cfg.flash_qkv)


def split_attention(cfg: ModelConfig, q, k, v):
    """The deterministic path's attention on split, RoPE'd ``q [B, N, Hq,
    D]`` and ``k/v [B, N, Hkv, D]``, in the JAX model's order: the
    per-q-head (``"pallas"``) or per-kv-head (``"pallas2"``) kernel, the
    split flash kernel (``"flash"``) where ``flash_supported``, else the
    einsum.  Returns ``[B, N, Hq*D]``."""
    B, N, hq, D = q.shape
    hkv = k.shape[2]
    if cfg.attention_impl in ("pallas", "pallas2"):
        fn = (gqa_attention_grouped if cfg.attention_impl == "pallas2"
              else gqa_attention)
        return fn(q, k, v).reshape(B, N, hq * D)
    if cfg.attention_impl == "flash" and flash_supported(N, hq, hkv, D):
        return gqa_attention_flash(q.reshape(B, N, hq * D),
                                   k.reshape(B, N, hkv * D),
                                   v.reshape(B, N, hkv * D), hq, hkv)
    return einsum_attention(q, k, v, cfg.scores_dtype)


def einsum_attention(q, k, v, scores_dtype="float32", rate=0.0, gen=None):
    """The JAX model's einsum attention (XLA there; plain PyTorch here, no
    kernel): fp32 scores times ``1/sqrt(D)``; the softmax in fp32, or with
    ``scores_dtype="bfloat16"`` the max-shifted scores stored in bf16 and
    ``e / sum(e)``; dropout on the fp32 weights (training: ``gen``); bf16
    weights @ v in fp32, out in q's dtype.  ``[B, N, Hq, D]`` and ``[B, N,
    Hkv, D]`` -> ``[B, N, Hq*D]``."""
    B, N, hq, D = q.shape
    hkv = k.shape[2]
    qg = q.reshape(B, N, hkv, hq // hkv, D).float()
    s = torch.einsum("bnkgd,bmkd->bkgnm", qg, k.float()) * (1.0 / math.sqrt(D))
    if scores_dtype == "bfloat16":
        e = torch.exp((s - s.amax(dim=-1, keepdim=True)).bfloat16().float())
        w = e / e.sum(dim=-1, keepdim=True)
    else:
        w = torch.softmax(s, dim=-1)
    w = _dropout(w, rate, gen).to(q.dtype)
    out = torch.einsum("bkgnm,bmkd->bnkgd", w.float(), v.float())
    return out.to(q.dtype).reshape(B, N, hq * D)


class GQAttention(nn.Module):
    """Fused qkv projection, then as the JAX model branches: the flash-QKV
    kernel (RoPE inside; with ``flash_fused_out`` the out projection too),
    or the split q/k/v with bf16 RoPE and :func:`split_attention`; then the
    out projection."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int):
        super().__init__()
        self.cfg = cfg
        self.qkv_proj = _quant_dense(p["qkv_proj"], i, cfg.int8_impl)
        self.out_proj = _quant_dense(p["out_proj"], i, cfg.int8_impl)
        # The fused-prologue qkv kernel and the fused out-projection kernel
        # always add an fp32 bias: zeros where the projection has none.
        for name, proj in (("qkv_bias", self.qkv_proj),
                           ("out_bias", self.out_proj)):
            b = proj.bias
            self.register_buffer(name, torch.zeros_like(
                proj.kernel_scale[0]) if b is None else b.float())
        # The s8 wgmma GEMMs read their weights K-major: each copy is made
        # once here, not on every call, and no weight is held K-major twice
        # (a QuantDense's own kernel_t is reused).  qkv: the fused-prologue
        # kernel.  out: B12 where flash_fused_out can take it (the heads
        # padded to its kernel's head dim), else the fused out projection
        # the fused prologue runs behind the attention.
        def kmajor(proj):
            t = proj.kernel_t
            return proj.kernel_q.t().contiguous() if t is None else t

        self.register_buffer("qkv_kernel_t", kmajor(self.qkv_proj),
                             persistent=False)
        hq, D = cfg.num_q_heads, cfg.head_dim
        out_t = None
        if (cfg.flash_fused_out and cfg.attention_impl == "flash"
                and cfg.flash_qkv):
            out_t = (kmajor(self.out_proj) if padded_head_dim(D) == D else
                     flash_out_weight_t(self.out_proj.kernel_q, hq, D))
        elif cfg.fused_prologue and not cfg.attention_bias:
            out_t = kmajor(self.out_proj)
        self.register_buffer("out_kernel_t", out_t, persistent=False)

    def forward(self, x, cos, sin, n_valid=0, prenorm=None):
        """``prenorm=(scale, shift)``, fp32 ``[B or 1, H]`` AdaLN rows,
        selects the fused-prologue path: ``x`` is then the raw residual
        stream, normed, modulated and quantised inside the qkv kernel, and
        the bias-free out_proj quantises inside its kernel too."""
        cfg = self.cfg
        if prenorm is not None:
            p = self.qkv_proj
            qkv = int8_norm_mod_dot(x, prenorm[0], prenorm[1], p.kernel_q,
                                    p.kernel_scale, self.qkv_bias,
                                    norm=cfg.norm, w_t=self.qkv_kernel_t)
        else:
            qkv = self.qkv_proj(x)
        B, N, _ = qkv.shape
        hq, hkv, D = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
        if (cfg.attention_impl == "flash" and cfg.flash_qkv
                and flash_supported(N, hq, hkv, D)):
            if cfg.flash_fused_out:
                o = self.out_proj
                return gqa_attention_flash_out(qkv, cos, sin, o.kernel_q,
                                               o.kernel_scale, self.out_bias,
                                               hq, hkv, n_valid=n_valid,
                                               wo_t=self.out_kernel_t)
            out = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv,
                                          n_valid=n_valid)
            if prenorm is not None and not cfg.attention_bias:
                o = self.out_proj
                return int8_matmul_fused(
                    out.reshape(B * N, hq * D), o.kernel_q, o.kernel_scale,
                    w_t=self.out_kernel_t).reshape(B, N, -1)
            return self.out_proj(out)
        # The split q/k/v: the JAX model's apply_rope in the compute dtype
        # (the tables cast first), then the attention of its branch.
        c, s = cos[:, None].to(qkv.dtype), sin[:, None].to(qkv.dtype)
        q = _rope(qkv[..., :hq * D].reshape(B, N, hq, D), c, s)
        k = _rope(qkv[..., hq * D:(hq + hkv) * D].reshape(B, N, hkv, D), c, s)
        v = qkv[..., (hq + hkv) * D:].reshape(B, N, hkv, D)
        return self.out_proj(split_attention(cfg, q, k, v))


class DiTBlock(nn.Module):
    """AdaLN-Zero block: norm, modulate, attention, gate; norm, modulate,
    fused MLP ("half": one kernel and an s8 product; "full": one kernel),
    gate.  ``mod`` is the block's ``[B or 1, 6H]`` AdaLN
    row (the hoisted table, or computed here from ``t_emb``).  With
    ``fused`` the norm and modulate of both branches happen inside the
    qkv and mlp_in kernels."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, adaln: Dense):
        super().__init__()
        self.cfg = cfg
        self.attn = GQAttention(cfg, p["attn"], i)
        self.mlp_in = _quant_dense(p["mlp_in"], i)
        self.mlp_out = _quant_dense(p["mlp_out"], i)
        # mlp_in's K-major copy for the s8 wgmma kernels (the fused
        # prologue's, the dense+GELU and the whole MLP's first product), and
        # mlp_out's for the whole MLP's second product where it runs.
        self.register_buffer("mlp_in_kernel_t",
                             self.mlp_in.kernel_q.t().contiguous(),
                             persistent=False)
        self.register_buffer(
            "mlp_out_kernel_t", self.mlp_out.kernel_q.t().contiguous()
            if cfg.fused_mlp_impl == "full" else None, persistent=False)
        self.adaln = adaln

    def forward(self, x, t_emb, cos, sin, mod=None, n_valid=0, fused=False):
        cfg = self.cfg
        if mod is None:
            mod = self.adaln(F.silu(t_emb))
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        if fused:
            h = self.attn(x, cos, sin, n_valid,
                          prenorm=(scale_msa.float(), shift_msa.float()))
        else:
            h = (_norm(x, cfg.norm) * (1 + scale_msa[:, None])
                 + shift_msa[:, None])
            h = self.attn(h, cos, sin, n_valid)
        x = x + gate_msa[:, None] * h
        if fused:
            g_q, g_s = int8_norm_mod_dense_gelu_quant(
                x, scale_mlp.float(), shift_mlp.float(), self.mlp_in.kernel_q,
                self.mlp_in.kernel_scale, self.mlp_in.bias.float(),
                norm=cfg.norm, gelu_impl=cfg.gelu_impl,
                w_t=self.mlp_in_kernel_t)
            h = _dequant_dense(g_q, g_s, self.mlp_out)
        else:
            h = (_norm(x, cfg.norm) * (1 + scale_mlp[:, None])
                 + shift_mlp[:, None])
            B, N, H = h.shape
            h = h.reshape(B * N, H)
            if cfg.fused_mlp_impl == "full":
                w1, w2 = self.mlp_in, self.mlp_out
                h = int8_mlp(h, w1.kernel_q, w1.kernel_scale, w1.bias.float(),
                             w2.kernel_q, w2.kernel_scale, w2.bias.float(),
                             gelu_impl=cfg.gelu_impl,
                             w1_t=self.mlp_in_kernel_t,
                             w2_t=self.mlp_out_kernel_t)
            else:
                h = _int8_dense_gelu_dense(h, self.mlp_in, self.mlp_out,
                                           self.mlp_in_kernel_t,
                                           cfg.gelu_impl, cfg.fast_epilogue)
            h = h.reshape(B, N, H)
        return x + gate_mlp[:, None] * h


class DiT(nn.Module):
    """x0-prediction DiT over DAC latents, int8 serving forward.

    Args:
        cfg: the model config; must be on a ported serving branch.
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
        # patch_in's K-major copy, which the dense+GELU kernel reads.
        self.register_buffer("patch_in_kernel_t",
                             self.patch_in.kernel_q.t().contiguous(),
                             persistent=False)
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
        # align_n: pad the patch count to a multiple of 8 with zero frames,
        # masked as attention keys and trimmed from the output, where the
        # JAX model does.
        n_valid = cfg.attn_valid_len
        if align_n_taken(cfg):
            n0 = (T_orig + pad) // P
            extra = ((-n0) % 8) * P
            if extra:
                pad += extra
                n_valid = n0
        if pad:
            x_t = F.pad(x_t, (0, 0, 0, pad))
            x_cond = F.pad(x_cond, (0, 0, 0, pad))
        T = T_orig + pad
        N = T // P
        if N > cfg.max_len:
            raise ValueError(f"sequence length {N} exceeds max_len {cfg.max_len}")

        x_in = torch.cat([x_t, x_cond], dim=-1).reshape(B * N, P * 2 * C)
        # The JAX model passes no gelu knobs to the patch embed: tanh, fp32.
        h = _int8_dense_gelu_dense(x_in, self.patch_in, self.patch_out,
                                   self.patch_in_kernel_t)
        h = h.reshape(B, N, cfg.hidden_size)

        t_emb = None if adaln_mod is not None else self.time_embedding(t)
        cos, sin = rope_cos_sin(N, cfg.head_dim, cfg.rope_base, h.device)
        fused = fused_prologue_taken(cfg, N)
        for i, blk in enumerate(self.blocks):
            h = blk(h, t_emb, cos, sin,
                    None if adaln_mod is None else adaln_mod[i], n_valid,
                    fused)

        h = self.final_proj(_norm(h, cfg.norm))
        return h.reshape(B, T, C)[:, :T_orig].float()


@torch.no_grad()
def adaln_tables(model, t: torch.Tensor) -> torch.Tensor:
    """Every layer's AdaLN modulation for flow times ``t [B]``:
    ``[depth, B, 6H]`` bf16, the rows each block's adaln Dense would give.
    ``model`` is a :class:`DiT` or a :class:`DenseDiT`."""
    a = F.silu(model.time_embedding(t))
    if isinstance(model, DenseDiT):
        return torch.stack([blk.adaln(a) for blk in model.blocks])
    return (torch.einsum("bh,dhm->dbm", a, model.adaln_kernel)
            + model.adaln_bias[:, None, :])


# ---- the trainable bf16 model -----------------------------------------------

# ModelConfig fields that select a branch of the JAX model's bf16 path, with
# the values the port has and the later slice that brings the others: those
# both paths read (checked where the model is built), then those only the
# training path reads (checked where it trains, so that serving the model
# never raises for them).
_DENSE_BRANCH = {
    "matmul_precision": (("bf16",), "the dynamic-int8 path"),
    "dtype": (("bfloat16",), "other compute dtypes"),
    "param_dtype": (("float32",), "other parameter dtypes"),
    "pos_embed": (("rope",), "learned positions (v1legacy)"),
    "fused_qkv": ((False,), "the fused qkv projection"),
    "attention_impl": (("flash", "pallas", "pallas2", "xla"),
                       "other attention"),
}
_TRAINING_BRANCH = {
    "train_attention_impl": (("flash", "xla"), "other training attention"),
    "scores_dtype": (("float32",), "bf16 score storage in training"),
    "remat_policy": (("full", "none"), "the selective remat policies dots, "
                                       "attn_out and mlp"),
}


def _check_branch(cfg: ModelConfig, branch: dict, what: str) -> None:
    for name, (have_ported, later) in branch.items():
        have = getattr(cfg, name)
        if have not in have_ported:
            raise NotImplementedError(
                f"ModelConfig.{name}={have!r} selects {later}, which a later "
                f"slice of the port brings; the port {what} {name} in "
                f"{have_ported!r}")


def check_dense_config(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose bf16 model (served
    or trained) takes a branch the port does not have."""
    _check_branch(cfg, _DENSE_BRANCH, "has")


def check_training_config(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the trainable
    branch the port has."""
    check_dense_config(cfg)
    _check_branch(cfg, _TRAINING_BRANCH, "trains")


class TrainDense(nn.Module):
    """flax ``nn.Dense(dtype, param_dtype=float32)``: an fp32 kernel
    ``[in, out]`` and bias, both cast to ``dtype`` at each product."""

    def __init__(self, kernel, bias, dtype, device):
        super().__init__()

        def param(t):
            return nn.Parameter(torch.as_tensor(t).to(
                device=device, dtype=torch.float32, copy=True))

        self.kernel = param(kernel)
        self.bias = None if bias is None else param(bias)
        self.dtype = dtype

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def _dense(p: dict, dtype, device, i=None) -> TrainDense:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    b = p.get("bias")
    return TrainDense(pick(p["kernel"]), None if b is None else pick(b),
                      dtype, device)


def _block_generator(seed: int, device) -> torch.Generator:
    """The generator of a block's dropout and drop-path masks.  It is made
    from the block's (step, layer) seed inside the block, so the forward
    that remat replays in backward draws the same masks."""
    return torch.Generator(device=device).manual_seed(seed & 0xFFFFFFFF)


def _dropout(x, rate: float, gen):
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, kept values
    divided by ``keep_prob`` in x's dtype."""
    if rate == 0.0 or gen is None:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    kp = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / kp, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def _drop_path(x, rate: np.float32, gen):
    """Per-sample stochastic depth: ``x / keep * floor(keep + u)``, the
    divide and the product in x's dtype, keep = 1 - rate in fp32."""
    if rate == 0.0 or gen is None:
        return x  # keep = 1, mask = 1: the identity
    keep = np.float32(1.0) - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=gen,
                   device=x.device)
    mask = torch.floor(float(keep) + u).to(x.dtype)
    return (x / torch.tensor(float(keep), dtype=x.dtype,
                             device=x.device)) * mask


class TrainAttention(nn.Module):
    """Split q/k/v projections, bf16 RoPE, then the training kernel (B10)
    or the einsum attention on the training path, the JAX model's serving
    attention (:func:`split_attention`) on the deterministic one, and the
    out projection."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, device):
        super().__init__()
        self.cfg = cfg
        bf16 = torch.bfloat16
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _dense(p[name], bf16, device, i))

    def forward(self, x, cos, sin, seed, gen):
        """``cos``/``sin``: ``[N, 1, D]`` in bf16; ``gen`` None on the
        deterministic path."""
        cfg = self.cfg
        B, N, _ = x.shape
        hq, hkv, D = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
        q = _rope(self.q_proj(x).reshape(B, N, hq, D), cos, sin)
        k = _rope(self.k_proj(x).reshape(B, N, hkv, D), cos, sin)
        v = self.v_proj(x).reshape(B, N, hkv, D)
        if gen is None:
            return self.out_proj(split_attention(cfg, q, k, v))
        if (cfg.train_attention_impl == "flash"
                and train_flash_supported(N, hq, hkv, D)):
            out = gqa_attention_train(
                q.reshape(B, N, hq * D), k.reshape(B, N, hkv * D),
                v.reshape(B, N, hkv * D), seed if cfg.dropout > 0.0 else 0,
                hq, hkv, cfg.dropout)
            return self.out_proj(out)
        return self.out_proj(einsum_attention(q, k, v, rate=cfg.dropout,
                                              gen=gen))


class TrainBlock(nn.Module):
    """AdaLN-Zero block: norm, modulate, attention, gate, drop-path; norm,
    modulate, Dense, exact GELU, dropout, Dense, dropout, gate, drop-path."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, dp_rate, device):
        super().__init__()
        self.cfg = cfg
        bf16 = torch.bfloat16
        self.adaln = _dense(p["adaln"], bf16, device, i)
        self.attn = TrainAttention(cfg, p["attn"], i, device)
        self.mlp_in = _dense(p["mlp_in"], bf16, device, i)
        self.mlp_out = _dense(p["mlp_out"], bf16, device, i)
        self.dp_rate = dp_rate

    def forward(self, x, t_emb, cos, sin, seed=None, mod=None):
        """``seed``: the block's (step, layer) seed on the training path,
        None on the deterministic one.  ``mod``: the block's hoisted AdaLN
        row ``[B or 1, 6H]``, else computed here from ``t_emb``."""
        cfg = self.cfg
        gen = None if seed is None else _block_generator(seed, x.device)
        if mod is None:
            mod = self.adaln(F.silu(t_emb))
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        h = _norm(x, cfg.norm) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        h = gate_msa[:, None] * self.attn(h, cos, sin, seed, gen)
        x = x + _drop_path(h, self.dp_rate, gen)
        h = _norm(x, cfg.norm) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        h = F.gelu(self.mlp_in(h), approximate="none")
        h = self.mlp_out(_dropout(h, cfg.dropout, gen))
        h = gate_mlp[:, None] * _dropout(h, cfg.dropout, gen)
        return x + _drop_path(h, self.dp_rate, gen)


class DenseDiT(nn.Module):
    """The trainable DiT: the JAX model at ``matmul_precision="bf16"``.

    Args:
        cfg: the model config; must be on the ported bf16 branch
            (:func:`check_dense_config`; the training path also checks
            :func:`check_training_config`).
        params: the JAX float param tree (``blocks`` stacked ``[depth,
            ...]``) as nested dicts of numpy arrays or tensors (see
            ``models/from_jax.py``); None draws it as flax initialises it
            (``init_dense_params``) from ``generator``.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.

    Parameters are fp32 ``nn.Parameter`` s named after the JAX tree
    (``patch_in.kernel``, ``blocks.3.attn.q_proj.kernel``...).
    """

    def __init__(self, cfg: ModelConfig, params: dict = None, device="cuda",
                 generator: torch.Generator = None):
        super().__init__()
        check_dense_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_dense_params(
                cfg, generator or torch.Generator().manual_seed(0))
        bf16, f32, dev = torch.bfloat16, torch.float32, self.device
        self.patch_in = _dense(params["patch_in"], bf16, dev)
        self.patch_out = _dense(params["patch_out"], bf16, dev)
        self.t_mlp1 = _dense(params["t_mlp1"], f32, dev)
        self.t_mlp2 = _dense(params["t_mlp2"], f32, dev)
        dpr = linspace_f32(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            TrainBlock(cfg, params["blocks"], i, dpr[i], dev)
            for i in range(cfg.depth))
        self.final_proj = _dense(params["final_proj"], bf16, dev)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """fp32 t-MLP over the sinusoid; bf16 out."""
        te = self.t_mlp1(sinusoidal_time_embedding(t, self.cfg.hidden_size))
        return self.t_mlp2(F.silu(te)).to(torch.bfloat16)

    def forward(self, x_t, t, x_cond, deterministic: bool = True,
                layer_seeds=None, adaln_mod=None):
        """``x_t``, ``x_cond``: [B, T, C]; ``t``: [B].  The training path
        (``deterministic=False``) needs ``layer_seeds``: one int32 seed per
        block for this step, drawn on the host before the forward.
        ``adaln_mod``: optional hoisted tables ``[depth, B or 1, 6H]``
        (:func:`adaln_tables`), as the sampler passes them.  Returns the
        predicted clean latent [B, T, C] fp32."""
        cfg = self.cfg
        if not deterministic:
            check_training_config(cfg)
        B, T_orig, C = x_t.shape
        if C != cfg.input_channels:
            raise ValueError(f"expected {cfg.input_channels} channels, got {C}")
        if not deterministic and (layer_seeds is None
                                  or len(layer_seeds) != cfg.depth):
            raise ValueError(f"the training path needs {cfg.depth} layer "
                             f"seeds")
        P = cfg.patch_len
        pad = (-T_orig) % P
        x_t = F.pad(x_t.to(torch.bfloat16), (0, 0, 0, pad))
        x_cond = F.pad(x_cond.to(torch.bfloat16), (0, 0, 0, pad))
        T = T_orig + pad
        N = T // P
        if N > cfg.max_len:
            raise ValueError(f"sequence length {N} exceeds max_len {cfg.max_len}")
        x_in = torch.cat([x_t, x_cond], dim=-1).reshape(B, N, P * 2 * C)
        h = self.patch_out(F.gelu(self.patch_in(x_in), approximate="none"))

        t_emb = None if adaln_mod is not None else self.time_embedding(t)
        cos, sin = rope_cos_sin(N, cfg.head_dim, cfg.rope_base, h.device)
        cos = cos[:, None].to(torch.bfloat16)
        sin = sin[:, None].to(torch.bfloat16)
        remat = cfg.remat_policy == "full" and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            seed = None if deterministic else int(layer_seeds[i])
            mod = None if adaln_mod is None else adaln_mod[i]
            if remat:
                h = torch.utils.checkpoint.checkpoint(
                    blk, h, t_emb, cos, sin, seed, mod, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                h = blk(h, t_emb, cos, sin, seed, mod)
        h = self.final_proj(_norm(h, cfg.norm))
        return h.reshape(B, T, C)[:, :T_orig].float()
