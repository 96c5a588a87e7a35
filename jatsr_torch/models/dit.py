"""The DiT in PyTorch: the int8 serving forward and the trainable model.

Port of the JAX package's ``models/dit.py``.  :class:`DenseDiT` is the
model at ``matmul_precision="bf16"`` (the branch the JAX model trains with,
split q/k/v): parameters in ``param_dtype`` (fp32, or bf16 as ``bench.py``
serves them) cast to the compute dtype at each product, dropout and
drop-path, the training attention kernel (B10) or the einsum attention,
remat per block; its deterministic (eval) forward takes the serving
attention the JAX model takes there.  Under ``matmul_precision="int8"`` it
serves the dynamic W8A8 model: every projection but the t-MLP, the AdaLN
and (without ``quantize_head``) ``final_proj`` is ``int8_dot_general``,
through ``w8a8_dot(int8_impl)``, which also trains: autograd takes JAX's
cotangents through the two quantisation scales (``ops/quant.py``).

:class:`DiT` is the ``int8_static`` serving model on every branch the JAX
model has there: fused QKV (with the flash-QKV kernel, RoPE inside, with
``flash_int8_qk`` its int8 value product, with ``flash_fused_out`` the out
projection inside) or split q/k/v projections; the "half" or "full" fused
MLP or the unfused QuantDense MLP; the fused or unfused patch embed; the
fused prologue (``fused_prologue`` with ``align_n``: ``bench.py``'s
default DiT); an int8 ``final_proj`` (``quantize_head``); RoPE or learned
positions with attention biases (``v1legacy``); ``int8_impl`` "xla",
"pallas" or "fused".  The compute dtype is bf16 or fp32 (``dtype``): at fp32
the activations the JAX model casts to its compute dtype are fp32, and
every kernel they reach takes its fp32 mode (the whole-MLP kernel writes
bf16 in both, as the JAX kernel does).  On the split q/k/v (``fused_qkv=False``,
``flash_qkv=False``, learned positions, ``attention_impl`` "pallas",
"pallas2" or "xla", or past the flash budget) the attention is the split
flash kernel, the per-q-head or per-kv-head kernel, or the einsum.  Inputs
are time-major ``[B, T, C]``; the residual stream is in the compute dtype;
the output is fp32.  Module names mirror the JAX modules (``patch_in``,
``blocks[i].attn.qkv_proj``, ``final_proj``...).

A knob whose branch the port does not have (a compute dtype other than
bf16 and fp32; on :class:`DiT` a precision other than ``int8_static``)
raises ``NotImplementedError``
where the model is built (:func:`check_serving_config`,
:func:`check_dense_config`), naming ROADMAP.md, where it is queued: the
port never takes a different branch silently.
"""

from __future__ import annotations

import functools
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
from ..ops.int8_matmul import (group_sum, int8_dense_gelu_quant,
                               int8_matmul_fused, int8_mlp, int8_mm)
from ..ops.prologue import (int8_norm_mod_dense_gelu_quant,
                            int8_norm_mod_dot, norm_mod_dot_supported)
from ..ops.quant import QuantDense, int8_dot_general
from ..ops.split import (int8_dense_gelu_quant_split, int8_matmul_fused_split,
                         int8_norm_mod_dense_gelu_quant_split)
from ..parallel.distributed import ModelGroup
from ..parallel.mesh import check_model_axis, local_params
from ..sampling.flow import linspace_f32
from ..utils.device import resolve_device
from .from_jax import as_tensor, init_dense_params, tree_to_torch

# ModelConfig fields that select a branch, with the values the port serves
# and the later slice that brings the others.
_SERVING_BRANCH = {
    "dtype": (("bfloat16", "float32"), "other compute dtypes"),
    "attention_impl": (("flash", "pallas", "pallas2", "xla"),
                       "other attention"),
}


def check_serving_config(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the int8 DiT's
    ported branches: a precision other than ``int8_static`` (the bf16 and
    dynamic-int8 models are :class:`DenseDiT`'s) or a compute dtype other
    than bf16 and fp32.  At fp32 every branch serves: each kernel it
    reaches has an fp32 mode."""
    if cfg.matmul_precision != "int8_static":
        raise NotImplementedError(
            f"ModelConfig.matmul_precision={cfg.matmul_precision!r}: the "
            f"int8 DiT serves 'int8_static'; DenseDiT serves 'bf16' and "
            f"'int8'")
    _check_branch(cfg, _SERVING_BRANCH, "serves")
    if cfg.gelu_impl not in ("tanh", "erf", "sigmoid"):
        raise ValueError(f"unknown gelu_impl {cfg.gelu_impl!r}")


# What the int8 DiT serves on a model axis past 1: bench.py's default path
# (the fused prologue) and --no-fused-prologue, both on the fused q/k/v with
# the flash-QKV kernel and the "half" fused MLP, at bf16.
_TENSOR_PARALLEL_BRANCH = {
    "fused_qkv": True, "fused_mlp": True, "fused_mlp_impl": "half",
    "attention_impl": "flash", "flash_qkv": True, "flash_fused_out": False,
    "flash_int8_qk": False, "pos_embed": "rope", "attention_bias": False,
    "quantize_head": False, "dtype": "bfloat16"}
TENSOR_PARALLEL_NEXT = ("the next slice of the port brings it (ROADMAP "
                        "section A item 8(b))")


def check_tensor_parallel(cfg: ModelConfig, model: int) -> None:
    """Raise ``NotImplementedError`` for a branch the int8 DiT does not
    serve on a model axis of ``model`` > 1 (every branch but bench.py's
    default and its --no-fused-prologue path; ``int8_impl="pallas"``, B14,
    is not split), and ``ValueError`` where the axis does not divide the
    heads or the MLP, or where a rank's columns fail a kernel's gate (the
    fused prologue's qkv and mlp_in widths, multiples of 128): the port
    never changes branch silently."""
    for name, want in _TENSOR_PARALLEL_BRANCH.items():
        if getattr(cfg, name) != want:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(cfg, name)!r} on a model axis "
                f"of {model}: the int8 DiT serves tensor-parallel with "
                f"{name}={want!r}; {TENSOR_PARALLEL_NEXT}")
    if cfg.int8_impl not in ("xla", "fused"):
        raise NotImplementedError(
            f"ModelConfig.int8_impl={cfg.int8_impl!r} on a model axis of "
            f"{model}: B14 is not split; {TENSOR_PARALLEL_NEXT}")
    check_model_axis(cfg, model)
    D = cfg.head_dim
    qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * D // model
    mlp = int(cfg.hidden_size * cfg.mlp_ratio) // model
    if cfg.fused_prologue and (qkv % 128 or mlp % 128):
        raise ValueError(f"a model axis of {model} leaves a rank {qkv} qkv "
                         f"and {mlp} mlp_in columns: the fused prologue's "
                         f"kernels take multiples of 128")


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
    layout (cast once here, as flax casts before the product: a bf16
    parameter is promoted exactly to an fp32 ``dtype``)."""

    def __init__(self, kernel, bias, dtype):
        super().__init__()
        self.register_buffer("kernel", kernel.to(dtype))
        self.register_buffer("bias", None if bias is None else bias.to(dtype))
        self.dtype = dtype

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel
        return y if self.bias is None else y + self.bias


def _dequant_dense(g_q, g_s, second: QuantDense, group=None):
    """The fused MLP's second half: an exact s8 product of the codes
    ``g_q [..., K]`` with row scales ``g_s [..., 1]``, then
    ``((acc * g_s) * ws + b)`` in the compute dtype (``second.dtype``).
    ``group``: the model group where ``second`` holds a rank's rows (the
    int32 partial products added before the dequant)."""
    lead = g_q.shape[:-1]
    acc = group_sum(group, int8_mm(g_q.reshape(-1, g_q.shape[-1]),
                                   second.kernel_q))
    acc = acc.float().reshape(*lead, -1)
    return (acc * g_s * second.kernel_scale + second.bias.float()
            ).to(second.dtype)


def _int8_dense_gelu_dense(x2d, first: QuantDense, second: QuantDense,
                           first_t, gelu_impl="tanh", fast_epilogue=True,
                           group=None):
    """The fused Dense-GELU-Dense of the patch embed and the block MLP:
    the int8 kernel for the first half (on ``first_t``, the first kernel
    K-major, as the card's kernel reads it; its fp32 mode on an fp32
    ``x2d``), an exact s8 product and an fp32 dequant for the second; out
    in the compute dtype.  ``group``: the model group where the two hold a
    rank's columns and rows (B5's split, then the split dequant)."""
    gelu = (int8_dense_gelu_quant if group is None else functools.partial(
        int8_dense_gelu_quant_split, group=group))
    g_q, g_s = gelu(
        x2d, first.kernel_q, first.kernel_scale, first.bias.float(),
        gelu_impl=gelu_impl, fast_epilogue=fast_epilogue, w_t=first_t)
    return _dequant_dense(g_q, g_s, second, group)


def _quant_dense(p: dict, i=None, int8_impl="xla",
                 dtype=torch.bfloat16) -> QuantDense:
    """The int8_static leaf ``p`` (layer ``i`` of a stacked one) as a
    QuantDense computing in ``dtype``."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    b = p.get("bias")
    return QuantDense(pick(p["kernel_q"]), pick(p["kernel_scale"]),
                      None if b is None else pick(b), int8_impl, dtype)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The config's compute dtype (``dtype``) as a torch dtype."""
    return getattr(torch, cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The config's parameter dtype (``param_dtype``) as a torch dtype."""
    return getattr(torch, cfg.param_dtype)


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
    ``e / sum(e)``; dropout on the fp32 weights (training: ``gen``, the
    block's :class:`BlockDraws`); the
    weights in q's dtype (bf16, or fp32) @ v in fp32, out in q's dtype.
    ``[B, N, Hq, D]`` and ``[B, N, Hkv, D]`` -> ``[B, N, Hq*D]``."""
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
    """The qkv projection (fused, or q/k/v apart with ``fused_qkv=False``),
    then as the JAX model branches: the flash-QKV kernel (RoPE inside; with
    ``flash_int8_qk`` its int8 value product; with ``flash_fused_out`` the
    out projection too), or the split q/k/v with bf16 RoPE (none under
    learned positions) and :func:`split_attention`; then the out
    projection."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, tp=None):
        super().__init__()
        self.cfg = cfg
        # tp: the model group; the module then holds the rank's heads (its
        # qkv columns, its rows of out_proj).
        self.tp = tp
        m = 1 if tp is None else tp.size
        self.hq, self.hkv = cfg.num_q_heads // m, cfg.num_kv_heads // m
        impl, dt = cfg.int8_impl, compute_dtype(cfg)
        names = ("qkv_proj",) if cfg.fused_qkv else ("q_proj", "k_proj",
                                                    "v_proj")
        for name in names + ("out_proj",):
            setattr(self, name, _quant_dense(p[name], i, impl, dt))
        self.out_proj.group = tp
        # The fused-prologue qkv kernel and the fused out-projection kernel
        # always add an fp32 bias: zeros where the projection has none.
        for name, proj in (("qkv_bias", getattr(self, "qkv_proj", None)),
                           ("out_bias", self.out_proj)):
            b = None if proj is None else proj.bias
            self.register_buffer(name, None if proj is None else
                                 torch.zeros_like(proj.kernel_scale[0])
                                 if b is None else b.float())
        # The s8 wgmma GEMMs read their weights K-major: each copy is made
        # once here, not on every call, and no weight is held K-major twice
        # (a QuantDense's own kernel_t is reused).  qkv: the fused-prologue
        # kernel.  out: B12 where flash_fused_out can take it (the heads
        # padded to its kernel's head dim), else the fused out projection
        # the fused prologue runs behind the attention.
        def kmajor(proj):
            t = proj.kernel_t
            return proj.kernel_q.t().contiguous() if t is None else t

        self.register_buffer("qkv_kernel_t", kmajor(self.qkv_proj)
                             if cfg.fused_qkv else None, persistent=False)
        hq, D = cfg.num_q_heads, cfg.head_dim
        out_t = None
        if (cfg.flash_fused_out and cfg.attention_impl == "flash"
                and cfg.flash_qkv and cfg.fused_qkv
                and cfg.pos_embed == "rope"):
            out_t = (kmajor(self.out_proj) if padded_head_dim(D) == D else
                     flash_out_weight_t(self.out_proj.kernel_q, hq, D))
        elif cfg.fused_prologue and not cfg.attention_bias:
            out_t = kmajor(self.out_proj)
        self.register_buffer("out_kernel_t", out_t, persistent=False)

    def forward(self, x, cos, sin, n_valid=0, prenorm=None):
        """``prenorm=(scale, shift)``, fp32 ``[B or 1, H]`` AdaLN rows,
        selects the fused-prologue path: ``x`` is then the raw residual
        stream, normed, modulated and quantised inside the qkv kernel, and
        the bias-free out_proj quantises inside its kernel too.  ``cos``
        and ``sin`` are None under learned positions."""
        cfg = self.cfg
        B, N, _ = x.shape
        hq, hkv, D = self.hq, self.hkv, cfg.head_dim
        if not cfg.fused_qkv:
            q = self.q_proj(x).reshape(B, N, hq, D)
            k = self.k_proj(x).reshape(B, N, hkv, D)
            v = self.v_proj(x).reshape(B, N, hkv, D)
            return self._split(q, k, v, cos, sin)
        if prenorm is not None:
            p = self.qkv_proj
            qkv = int8_norm_mod_dot(x, prenorm[0], prenorm[1], p.kernel_q,
                                    p.kernel_scale, self.qkv_bias,
                                    norm=cfg.norm, out_dtype=p.dtype,
                                    w_t=self.qkv_kernel_t)
        else:
            qkv = self.qkv_proj(x)
        flash = (cfg.attention_impl == "flash" and cfg.flash_qkv
                 and cfg.pos_embed == "rope"
                 and flash_supported(N, hq, hkv, D))
        if self.tp is not None and not flash:
            raise NotImplementedError(
                f"{N} patches with {hq}/{hkv} heads a rank: the flash-QKV "
                f"kernel does not take them, and the split q/k/v does not "
                f"serve on a model axis; {TENSOR_PARALLEL_NEXT}")
        if flash:
            if cfg.flash_fused_out:
                o = self.out_proj
                return gqa_attention_flash_out(qkv, cos, sin, o.kernel_q,
                                               o.kernel_scale, self.out_bias,
                                               hq, hkv, n_valid=n_valid,
                                               wo_t=self.out_kernel_t)
            out = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv,
                                          n_valid=n_valid,
                                          int8_qk=cfg.flash_int8_qk)
            if prenorm is not None and not cfg.attention_bias:
                o = self.out_proj
                fused = (int8_matmul_fused if self.tp is None else
                         functools.partial(int8_matmul_fused_split,
                                           group=self.tp))
                out = fused(out.reshape(B * N, hq * D), o.kernel_q,
                            o.kernel_scale, out_dtype=o.dtype,
                            w_t=self.out_kernel_t)
                return out.reshape(B, N, -1)
            return self.out_proj(out)
        q = qkv[..., :hq * D].reshape(B, N, hq, D)
        k = qkv[..., hq * D:(hq + hkv) * D].reshape(B, N, hkv, D)
        v = qkv[..., (hq + hkv) * D:].reshape(B, N, hkv, D)
        return self._split(q, k, v, cos, sin)

    def _split(self, q, k, v, cos, sin):
        """The split q/k/v: the JAX model's apply_rope in the compute dtype
        (the tables cast first) unless the positions are learned, then the
        attention of its branch and the out projection."""
        if cos is not None:
            c, s = cos[:, None].to(q.dtype), sin[:, None].to(q.dtype)
            q, k = _rope(q, c, s), _rope(k, c, s)
        return self.out_proj(split_attention(self.cfg, q, k, v))


class DiTBlock(nn.Module):
    """AdaLN-Zero block: norm, modulate, attention, gate; norm, modulate,
    MLP, gate.  The MLP is fused ("half": one kernel and an s8 product;
    "full": one kernel) or, with ``fused_mlp=False``, the QuantDense
    mlp_in, exact GELU on its bf16 output and the QuantDense mlp_out.
    ``mod`` is the block's ``[B or 1, 6H]`` AdaLN row (the hoisted table,
    or computed here from ``t_emb``).  With ``fused`` the norm and modulate
    of both branches happen inside the qkv and mlp_in kernels."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, adaln: Dense,
                 tp=None):
        super().__init__()
        self.cfg = cfg
        # tp: the model group; the block then holds the rank's heads, its
        # columns of mlp_in and adaln and its rows of mlp_out.
        self.tp = tp
        self.attn = GQAttention(cfg, p["attn"], i, tp)
        # The fused MLP kernels read the raw int8 weights; only the unfused
        # QuantDense MLP runs w8a8_dot(int8_impl).
        impl, dt = ("xla" if cfg.fused_mlp else cfg.int8_impl,
                    compute_dtype(cfg))
        self.mlp_in = _quant_dense(p["mlp_in"], i, impl, dt)
        self.mlp_out = _quant_dense(p["mlp_out"], i, impl, dt)
        # mlp_in's K-major copy for the s8 wgmma kernels (the fused
        # prologue's, the dense+GELU and the whole MLP's first product), and
        # mlp_out's for the whole MLP's second product where it runs.
        fused = cfg.fused_mlp
        self.register_buffer("mlp_in_kernel_t",
                             self.mlp_in.kernel_q.t().contiguous()
                             if fused else None, persistent=False)
        self.register_buffer(
            "mlp_out_kernel_t", self.mlp_out.kernel_q.t().contiguous()
            if fused and cfg.fused_mlp_impl == "full" else None,
            persistent=False)
        self.adaln = adaln

    def forward(self, x, t_emb, cos, sin, mod=None, n_valid=0, fused=False):
        cfg = self.cfg
        if mod is None:
            mod = self.adaln(F.silu(t_emb))
            if self.tp is not None:
                mod = self.tp.gather_cols(mod)
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
            gelu = (int8_norm_mod_dense_gelu_quant if self.tp is None else
                    functools.partial(int8_norm_mod_dense_gelu_quant_split,
                                      group=self.tp))
            g_q, g_s = gelu(
                x, scale_mlp.float(), shift_mlp.float(), self.mlp_in.kernel_q,
                self.mlp_in.kernel_scale, self.mlp_in.bias.float(),
                norm=cfg.norm, gelu_impl=cfg.gelu_impl,
                w_t=self.mlp_in_kernel_t)
            h = _dequant_dense(g_q, g_s, self.mlp_out, self.tp)
        else:
            h = (_norm(x, cfg.norm) * (1 + scale_mlp[:, None])
                 + shift_mlp[:, None])
            if not cfg.fused_mlp:
                h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="none"))
                return x + gate_mlp[:, None] * h
            B, N, H = h.shape
            h = h.reshape(B * N, H)
            if cfg.fused_mlp_impl == "full":
                # bf16 out in both modes, back in the compute dtype here.
                w1, w2 = self.mlp_in, self.mlp_out
                h = int8_mlp(h, w1.kernel_q, w1.kernel_scale, w1.bias.float(),
                             w2.kernel_q, w2.kernel_scale, w2.bias.float(),
                             gelu_impl=cfg.gelu_impl,
                             w1_t=self.mlp_in_kernel_t,
                             w2_t=self.mlp_out_kernel_t).to(h.dtype)
            else:
                h = _int8_dense_gelu_dense(h, self.mlp_in, self.mlp_out,
                                           self.mlp_in_kernel_t,
                                           cfg.gelu_impl, cfg.fast_epilogue,
                                           self.tp)
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
        mesh: None, or a ``(D, M)`` mesh (``parallel.make_mesh``): at M > 1
            the model is tensor-parallel over its model dim (bench.py's
            default path and --no-fused-prologue; :func:`check_tensor_
            parallel`).  The rank keeps its leaves of ``params``
            (``parallel.mesh.local_params``: its heads of qkv and
            out_proj, its columns of mlp_in and adaln, its rows of
            mlp_out), cut before they reach the device; the ranks of a
            model group meet in ``ModelGroup``'s collectives and every one
            ends each forward with the one-card output.
    """

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda",
                 mesh=None):
        super().__init__()
        check_serving_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tp = ModelGroup.of(mesh)
        if self.tp is not None:
            check_tensor_parallel(cfg, self.tp.size)
            params = local_params(params, cfg, self.tp.size, self.tp.rank)
        P, C = cfg.patch_len, cfg.input_channels
        # The fused patch embed (the dense+GELU kernel, an s8 product) where
        # the JAX model takes it; else QuantDense, exact GELU, QuantDense.
        self.fused_patch = (cfg.fused_mlp and (P * 2 * C) % 128 == 0
                            and cfg.bottleneck_dim % 128 == 0)
        p = tree_to_torch(params, self.device)
        dt, f32 = compute_dtype(cfg), torch.float32
        impl = "xla" if self.fused_patch else cfg.int8_impl
        self.patch_in = _quant_dense(p["patch_in"], None, impl, dt)
        self.patch_out = _quant_dense(p["patch_out"], None, impl, dt)
        # patch_in's K-major copy, which the dense+GELU kernel reads.
        self.register_buffer("patch_in_kernel_t",
                             self.patch_in.kernel_q.t().contiguous()
                             if self.fused_patch else None, persistent=False)
        # v1legacy: learned absolute positions, added after the patch embed.
        self.register_buffer("pos_embed", p["pos_embed"].float()
                             if cfg.pos_embed == "learned" else None)
        self.t_mlp1 = Dense(p["t_mlp1"]["kernel"], p["t_mlp1"]["bias"], f32)
        self.t_mlp2 = Dense(p["t_mlp2"]["kernel"], p["t_mlp2"]["bias"], f32)
        blocks = p["blocks"]
        self.register_buffer("adaln_kernel", blocks["adaln"]["kernel"].to(dt))
        self.register_buffer("adaln_bias", blocks["adaln"]["bias"].to(dt))
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, blocks, i,
                     Dense(self.adaln_kernel[i], self.adaln_bias[i], dt),
                     self.tp)
            for i in range(cfg.depth))
        self.final_proj = (
            _quant_dense(p["final_proj"], None, cfg.int8_impl, dt)
            if cfg.quantize_head else
            Dense(p["final_proj"]["kernel"], p["final_proj"]["bias"], dt))

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """fp32 t-MLP over the sinusoid; out in the compute dtype."""
        te = self.t_mlp1(sinusoidal_time_embedding(t, self.cfg.hidden_size))
        return self.t_mlp2(F.silu(te)).to(compute_dtype(self.cfg))

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
        x_t = x_t.to(compute_dtype(cfg))
        x_cond = x_cond.to(compute_dtype(cfg))
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
        if self.fused_patch:
            # The JAX model passes no gelu knobs to the patch embed: tanh,
            # fp32.
            h = _int8_dense_gelu_dense(x_in, self.patch_in, self.patch_out,
                                       self.patch_in_kernel_t)
        else:
            h = self.patch_out(F.gelu(self.patch_in(x_in),
                                      approximate="none"))
        h = h.reshape(B, N, cfg.hidden_size)
        if self.pos_embed is not None:
            h = h + self.pos_embed[None, :N].to(h.dtype)

        t_emb = None if adaln_mod is not None else self.time_embedding(t)
        cos = sin = None
        if cfg.pos_embed == "rope":
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
    ``[depth, B, 6H]`` in the compute dtype, the rows each block's adaln
    Dense would give.
    ``model`` is a :class:`DiT` or a :class:`DenseDiT`."""
    a = F.silu(model.time_embedding(t))
    if isinstance(model, DenseDiT):
        return torch.stack([blk.adaln(a) for blk in model.blocks])
    out = (torch.einsum("bh,dhm->dbm", a, model.adaln_kernel)
           + model.adaln_bias[:, None, :])
    # A tensor-parallel DiT holds its columns of the tables: one gather.
    return out if model.tp is None else model.tp.gather_cols(out)


# ---- the trainable model, and the dynamic-int8 one -------------------------

# ModelConfig fields that select a branch of the JAX model's bf16 and
# dynamic-int8 paths, with the values the port has and the later slice that
# brings the others: those both paths read (checked where the model is
# built), then those only the training path reads (checked where it trains,
# so that serving the model never raises for them).  The knobs of the
# int8_static branches (fused_qkv, fused_mlp, fused_prologue,
# flash_int8_qk...) select nothing here, as in the JAX model.
_DENSE_BRANCH = {
    "matmul_precision": (("bf16", "int8"), "the int8_static model (DiT)"),
    "dtype": (("bfloat16", "float32"), "other compute dtypes"),
    "param_dtype": (("float32", "bfloat16"), "other parameter dtypes"),
    "attention_impl": (("flash", "pallas", "pallas2", "xla"),
                       "other attention"),
}
_TRAINING_BRANCH = {
    "train_attention_impl": (("flash", "xla"), "other training attention"),
    "remat_policy": (("full", "dots", "attn_out", "mlp", "none"),
                     "other remat policies"),
}


def _check_branch(cfg: ModelConfig, branch: dict, what: str) -> None:
    for name, (have_ported, later) in branch.items():
        have = getattr(cfg, name)
        if have not in have_ported:
            raise NotImplementedError(
                f"ModelConfig.{name}={have!r} selects {later}, which a later "
                f"slice of the port brings (queued in ROADMAP.md); the port "
                f"{what} {name} in {have_ported!r}")


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
    """flax ``nn.Dense(dtype, param_dtype)``: a kernel ``[in, out]`` and
    bias held in ``param_dtype`` (fp32, or bf16), both cast to ``dtype`` at
    each product.  With ``int8_impl`` (``matmul_precision="int8"``) the
    product is :func:`int8_dot_general` through ``w8a8_dot(int8_impl)``,
    the kernel quantised at each call; the bias is added after it."""

    def __init__(self, kernel, bias, dtype, device, int8_impl=None,
                 param_dtype=torch.float32):
        super().__init__()

        def param(t):
            return nn.Parameter(as_tensor(t).to(
                device=device, dtype=param_dtype, copy=True))

        self.kernel = param(kernel)
        self.bias = None if bias is None else param(bias)
        self.dtype = dtype
        self.int8_impl = int8_impl

    def forward(self, x):
        if self.int8_impl is None:
            y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        else:
            y = int8_dot_general(x.to(self.dtype), self.kernel.to(self.dtype),
                                 self.int8_impl)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def _dense(p: dict, dtype, device, i=None, int8_impl=None,
           param_dtype=torch.float32) -> TrainDense:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    b = p.get("bias")
    return TrainDense(pick(p["kernel"]), None if b is None else pick(b),
                      dtype, device, int8_impl, param_dtype)


def _int8_impl(cfg: ModelConfig):
    """The ``int8_impl`` of the projections ``mk`` makes: the config's
    under dynamic int8, else None (a product in the compute dtype)."""
    return cfg.int8_impl if cfg.matmul_precision == "int8" else None


class BlockDraws:
    """A block's dropout and drop-path draws: a generator made from the
    block's (step, layer) seed inside the block, so the forward that remat
    replays in backward draws the same masks.

    ``rows``: None, or ``(b0, total)`` where the block sees rows ``b0 ..``
    of a batch of ``total`` rows (a data-parallel rank's span of its
    micro-batch): each draw is then one over the whole batch, of which the
    block keeps its rows, so that every rank's masks are those one process
    draws for the whole batch."""

    def __init__(self, seed: int, device, rows=None):
        self.gen = torch.Generator(device=device).manual_seed(
            seed & 0xFFFFFFFF)
        self.rows = rows

    @property
    def b0(self) -> int:
        """The first row's row in the whole batch (B10's hash offset)."""
        return 0 if self.rows is None else self.rows[0]

    def rand(self, shape, device) -> torch.Tensor:
        """Uniforms of ``shape`` for this block's rows."""
        if self.rows is None:
            return torch.rand(shape, generator=self.gen, device=device)
        b0, total = self.rows
        u = torch.rand((total,) + tuple(shape[1:]), generator=self.gen,
                       device=device)
        return u[b0:b0 + shape[0]]


def _dropout(x, rate: float, gen):
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, kept values
    divided by ``keep_prob`` in x's dtype.  ``gen``: the block's
    :class:`BlockDraws`."""
    if rate == 0.0 or gen is None:
        return x
    keep_prob = 1.0 - rate
    keep = gen.rand(x.shape, x.device) < keep_prob
    kp = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / kp, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def _drop_path(x, rate: np.float32, gen):
    """Per-sample stochastic depth: ``x / keep * floor(keep + u)``, the
    divide and the product in x's dtype, keep = 1 - rate in fp32."""
    if rate == 0.0 or gen is None:
        return x  # keep = 1, mask = 1: the identity
    keep = np.float32(1.0) - rate
    u = gen.rand((x.shape[0],) + (1,) * (x.ndim - 1), x.device)
    mask = torch.floor(float(keep) + u).to(x.dtype)
    return (x / torch.tensor(float(keep), dtype=x.dtype,
                             device=x.device)) * mask


class TrainAttention(nn.Module):
    """Split q/k/v projections, RoPE in the compute dtype (none under
    learned positions), then the training kernel (B10) or the einsum
    attention on the training path, the JAX model's serving attention
    (:func:`split_attention`) on the deterministic one, and the out
    projection."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, device):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _dense(p[name], compute_dtype(cfg), device, i,
                                       _int8_impl(cfg), param_dtype(cfg)))

    def forward(self, x, cos, sin, seed, gen):
        """``cos``/``sin``: ``[N, 1, D]`` in the compute dtype, None under
        learned positions; ``gen`` None on the deterministic path."""
        cfg = self.cfg
        B, N, _ = x.shape
        hq, hkv, D = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, N, hq, D)
        k = self.k_proj(x).reshape(B, N, hkv, D)
        v = self.v_proj(x).reshape(B, N, hkv, D)
        if cos is not None:
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        if gen is None:
            return self.out_proj(split_attention(cfg, q, k, v))
        if (cfg.train_attention_impl == "flash" and cos is not None
                and train_flash_supported(N, hq, hkv, D)):
            out = gqa_attention_train(
                q.reshape(B, N, hq * D), k.reshape(B, N, hkv * D),
                v.reshape(B, N, hkv * D), seed if cfg.dropout > 0.0 else 0,
                hq, hkv, cfg.dropout, b0=gen.b0)
            return self.out_proj(out)
        return self.out_proj(einsum_attention(q, k, v, cfg.scores_dtype,
                                              rate=cfg.dropout, gen=gen))


class TrainBlock(nn.Module):
    """AdaLN-Zero block: norm, modulate, attention, gate, drop-path; norm,
    modulate, Dense, exact GELU, dropout, Dense, dropout, gate, drop-path.

    Under the selective remat policies the block runs as checkpointed
    segments whose outputs are kept for backward, each segment replayed
    from its inputs: the JAX model's ``checkpoint_name`` s are their
    boundaries.  Under "attn_out" the first segment ends at the attention
    module's output after ``out_proj``, the second runs the rest of the
    block.  Under "mlp" ``mlp_in`` runs between two segments, so that its
    output, the pre-GELU hidden, is kept and its product never replayed;
    its backward keeps its input (the modulated norm), and the residual
    stream after attention is kept as the segments' boundary: two ``[B, N,
    H]`` tensors a block that the JAX model recomputes."""

    def __init__(self, cfg: ModelConfig, p: dict, i: int, dp_rate, device):
        super().__init__()
        self.cfg = cfg
        dt, pdt, mk = compute_dtype(cfg), param_dtype(cfg), _int8_impl(cfg)
        self.adaln = _dense(p["adaln"], dt, device, i, None, pdt)
        self.attn = TrainAttention(cfg, p["attn"], i, device)
        self.mlp_in = _dense(p["mlp_in"], dt, device, i, mk, pdt)
        self.mlp_out = _dense(p["mlp_out"], dt, device, i, mk, pdt)
        self.dp_rate = dp_rate

    def forward(self, x, t_emb, cos, sin, seed=None, mod=None,
                segments: bool = False, rows=None):
        """``seed``: the block's (step, layer) seed on the training path,
        None on the deterministic one.  ``mod``: the block's hoisted AdaLN
        row ``[B or 1, 6H]``, else computed here from ``t_emb``.
        ``segments``: run the segments of ``cfg.remat_policy`` ("attn_out"
        or "mlp") under checkpoints.  ``rows``: as :class:`BlockDraws`
        takes it."""
        gen = None if seed is None else BlockDraws(seed, x.device, rows)
        if mod is None:
            mod = self.adaln(F.silu(t_emb))
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        run = _Segments(gen) if segments else _direct(gen)
        a = run(self._attention, x, shift_msa, scale_msa, cos, sin, seed)
        if segments and self.cfg.remat_policy == "mlp":
            x, h = run(self._mlp_norm, x, a, gate_msa, shift_mlp, scale_mlp)
            return run(self._mlp_post, x, self.mlp_in(h), gate_mlp)
        return run(self._mlp, x, a, gate_msa, shift_mlp, scale_mlp, gate_mlp)

    def _attention(self, x, shift, scale, cos, sin, seed, gen):
        h = _norm(x, self.cfg.norm) * (1 + scale[:, None]) + shift[:, None]
        return self.attn(h, cos, sin, seed, gen)

    def _mlp_norm(self, x, a, gate_msa, shift, scale, gen):
        """The attention's gated residual, then norm and modulate: ``(x,
        the mlp_in input)``."""
        x = x + _drop_path(gate_msa[:, None] * a, self.dp_rate, gen)
        return x, _norm(x, self.cfg.norm) * (1 + scale[:, None]) \
            + shift[:, None]

    def _mlp_post(self, x, pre, gate_mlp, gen):
        """Exact GELU of the pre-GELU hidden, dropout, ``mlp_out``,
        dropout, gate, drop-path, residual."""
        rate = self.cfg.dropout
        h = self.mlp_out(_dropout(F.gelu(pre, approximate="none"), rate, gen))
        h = gate_mlp[:, None] * _dropout(h, rate, gen)
        return x + _drop_path(h, self.dp_rate, gen)

    def _mlp(self, x, a, gate_msa, shift_mlp, scale_mlp, gate_mlp, gen):
        x, h = self._mlp_norm(x, a, gate_msa, shift_mlp, scale_mlp, gen)
        return self._mlp_post(x, self.mlp_in(h), gate_mlp, gen)


def _direct(gen):
    """Run a block stage as it is, drawing from ``gen``."""
    return lambda fn, *args: fn(*args, gen)


class _Segments:
    """Run each block stage under ``torch.utils.checkpoint``, its inputs
    and outputs kept, its insides replayed in backward.  The replay draws
    the stage's dropout and drop-path masks again: each stage starts from
    the block generator's state as the stage found it."""

    def __init__(self, gen):
        self.gen = gen

    def __call__(self, fn, *args):
        state = None if self.gen is None else self.gen.gen.get_state()
        return torch.utils.checkpoint.checkpoint(
            self._replay, fn, state, *args, use_reentrant=False,
            preserve_rng_state=False)

    def _replay(self, fn, state, *args):
        if state is not None:
            self.gen.gen.set_state(state)
        return fn(*args, self.gen)


# aten's products without batch dimensions: the outputs the "dots" policy
# keeps (JAX's dots_with_no_batch_dims_saveable: every projection; the
# attention's batched products are replayed).  Under dynamic int8 that is
# the int32 product of the plain path (``torch._int_mm``), as JAX keeps its
# s8 dot_general's; the card's W8A8 kernels (B4, B14) never write it, so
# there the policy keeps nothing of them and the replay runs them again.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


class DenseDiT(nn.Module):
    """The trainable DiT: the JAX model at ``matmul_precision="bf16"``;
    at ``"int8"`` the dynamic W8A8 serving model on the same tree.

    Args:
        cfg: the model config; must be on a ported bf16 or dynamic-int8
            branch (:func:`check_dense_config`; the training path also
            checks :func:`check_training_config`).
        params: the JAX float param tree (``blocks`` stacked ``[depth,
            ...]``) as nested dicts of numpy arrays or tensors (see
            ``models/from_jax.py``); None draws it as flax initialises it
            (``init_dense_params``) from ``generator``.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.

    Parameters are ``nn.Parameter`` s in ``param_dtype`` (fp32, or bf16
    where the JAX model stores bf16 leaves: every Dense, ``adaln``, the
    t-MLP and ``pos_embed``; their gradients are in the same dtype), named
    after the JAX tree (``patch_in.kernel``, ``blocks.3.attn.q_proj.kernel``,
    ``pos_embed`` under learned positions...).  The compute dtype is bf16
    or fp32 (``dtype``; at fp32 B10 runs its fp32 mode), served and
    trained; the t-MLP is fp32 either way.
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
        dt, pdt, dev = compute_dtype(cfg), param_dtype(cfg), self.device
        f32, mk = torch.float32, _int8_impl(cfg)
        self.patch_in = _dense(params["patch_in"], dt, dev, None, mk, pdt)
        self.patch_out = _dense(params["patch_out"], dt, dev, None, mk, pdt)
        self.pos_embed = (nn.Parameter(as_tensor(params["pos_embed"]).to(
            device=dev, dtype=pdt, copy=True))
            if cfg.pos_embed == "learned" else None)
        # The fp32 island: bf16 parameters promoted at each product.
        self.t_mlp1 = _dense(params["t_mlp1"], f32, dev, None, None, pdt)
        self.t_mlp2 = _dense(params["t_mlp2"], f32, dev, None, None, pdt)
        dpr = linspace_f32(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            TrainBlock(cfg, params["blocks"], i, dpr[i], dev)
            for i in range(cfg.depth))
        self.final_proj = _dense(params["final_proj"], dt, dev, None,
                                 mk if cfg.quantize_head else None, pdt)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """fp32 t-MLP over the sinusoid; out in the compute dtype."""
        te = self.t_mlp1(sinusoidal_time_embedding(t, self.cfg.hidden_size))
        return self.t_mlp2(F.silu(te)).to(compute_dtype(self.cfg))

    def forward(self, x_t, t, x_cond, deterministic: bool = True,
                layer_seeds=None, adaln_mod=None, rows=None):
        """``x_t``, ``x_cond``: [B, T, C]; ``t``: [B].  The training path
        (``deterministic=False``) needs ``layer_seeds``: one int32 seed per
        block for this step, drawn on the host before the forward.
        ``rows``: None, or ``(b0, total)``: the batch is rows ``b0 ..`` of
        a (micro-)batch of ``total`` rows whose dropout and drop-path masks
        are drawn whole (a data-parallel rank's span).
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
        P, dt = cfg.patch_len, compute_dtype(cfg)
        pad = (-T_orig) % P
        x_t = F.pad(x_t.to(dt), (0, 0, 0, pad))
        x_cond = F.pad(x_cond.to(dt), (0, 0, 0, pad))
        T = T_orig + pad
        N = T // P
        if N > cfg.max_len:
            raise ValueError(f"sequence length {N} exceeds max_len {cfg.max_len}")
        x_in = torch.cat([x_t, x_cond], dim=-1).reshape(B, N, P * 2 * C)
        h = self.patch_out(F.gelu(self.patch_in(x_in), approximate="none"))
        if self.pos_embed is not None:
            h = h + self.pos_embed[None, :N].to(h.dtype)

        t_emb = None if adaln_mod is not None else self.time_embedding(t)
        cos = sin = None
        if cfg.pos_embed == "rope":
            cos, sin = rope_cos_sin(N, cfg.head_dim, cfg.rope_base, h.device)
            cos, sin = cos[:, None].to(dt), sin[:, None].to(dt)
        # Remat (only where autograd records): "full" and "dots" replay
        # the whole block in backward, "dots" keeping its projections'
        # outputs; "attn_out" and "mlp" run it as checkpointed segments.
        policy = cfg.remat_policy if torch.is_grad_enabled() else "none"
        for i, blk in enumerate(self.blocks):
            seed = None if deterministic else int(layer_seeds[i])
            mod = None if adaln_mod is None else adaln_mod[i]
            if policy in ("full", "dots"):
                h = torch.utils.checkpoint.checkpoint(
                    blk, h, t_emb, cos, sin, seed, mod, rows=rows,
                    use_reentrant=False, preserve_rng_state=False,
                    **({"context_fn": _dots_context} if policy == "dots"
                       else {}))
            else:
                h = blk(h, t_emb, cos, sin, seed, mod,
                        segments=policy in ("attn_out", "mlp"), rows=rows)
        h = self.final_proj(_norm(h, cfg.norm))
        return h.reshape(B, T, C)[:, :T_orig].float()
