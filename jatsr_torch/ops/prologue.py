"""Fused norm + AdaLN modulate + row quantisation in front of the s8 GEMM.

Ports of ``int8_norm_mod_dot`` (the qkv projection) and
``int8_norm_mod_dense_gelu_quant`` (mlp_in) from the JAX package's
``ops/int8_matmul.py``, with their eligibility gate.  Both read the raw
residual stream ``x [B, Np, H]`` and one AdaLN ``(scale, shift)`` row per
sample, ``[B, H]`` or ``[1, H]`` (the sampler's hoisted table, shared over
the batch).  Each wrapper dispatches on the tensor's device: a CPU tensor
takes the plain PyTorch version below, a CUDA tensor launches the
hand-written kernel in ``csrc/norm_mod.cu`` or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .int8_matmul import (_INV127, GELU_IMPLS, _gelu, check_weights,
                          int8_mm)

NORMS = ("rms", "layer")


def _pick_bn_rows(n_rows: int, target: int) -> int:
    """Largest 8-aligned divisor of ``n_rows`` <= target (0 if none)."""
    best = 0
    for bn in range(8, min(n_rows, target) + 1, 8):
        if n_rows % bn == 0:
            best = bn
    return best


def norm_mod_dot_supported(n_rows: int, h: int, n_out: int) -> bool:
    """The JAX package's eligibility gate for the prologue kernels (a copy,
    so the port takes the branch the JAX model takes)."""
    return (_pick_bn_rows(n_rows, 256) > 0 and h % 128 == 0
            and n_out % 128 == 0)


def _b16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def norm_mod(x, scale, shift, norm: str, eps: float = 1e-6):
    """Affine-free RMS/Layer norm and AdaLN modulate, fp32 out (bf16 values).

    Statistics in fp32 with true divides by H (not the clamped ``_norm`` of
    ``models/dit.py``); ``1 / sqrt`` as two correctly rounded operations;
    then ``b16(b16(b16(xn) * b16(1 + scale)) + shift)``.  ``x [B, Np, H]``;
    ``scale``, ``shift`` ``[B or 1, H]``.
    """
    xf = x.float()
    H = xf.shape[-1]
    ms = (xf * xf).sum(-1, keepdim=True) / H
    if norm == "rms":
        xn = xf * (1.0 / torch.sqrt(ms + eps))
    else:
        mu = xf.sum(-1, keepdim=True) / H
        xn = (xf - mu) * (1.0 / torch.sqrt(ms - mu * mu + eps))
    sc = scale.float()[:, None, :]
    sh = shift.float()[:, None, :]
    y = _b16(_b16(xn) * _b16(1.0 + sc))
    return _b16(y + sh)


def _prologue_plain(x, scale, shift, norm):
    """``(codes int8 [B*Np, H], floored row scales fp32 [B*Np, 1])``."""
    y = norm_mod(x, scale, shift, norm).reshape(-1, x.shape[-1])
    s = (y.abs().amax(dim=-1, keepdim=True) * _INV127).clamp_min(1e-12)
    return torch.round(y / s).to(torch.int8), s


def norm_mod_dot_plain(x, scale, shift, w_q, w_scale, bias, norm="rms"):
    """Plain PyTorch version of the qkv kernel: ``bf16(((acc * s) * ws)
    + b)``, ``[B, Np, N]``."""
    B, Np, _ = x.shape
    a_q, s = _prologue_plain(x, scale, shift, norm)
    acc = int8_mm(a_q, w_q).float()
    y = acc * s * w_scale.reshape(1, -1) + bias.reshape(1, -1).float()
    return y.to(torch.bfloat16).reshape(B, Np, -1)


def norm_mod_dense_gelu_quant_plain(x, scale, shift, w_q, w_scale, bias,
                                    norm="rms", gelu_impl="tanh"):
    """Plain PyTorch version of the mlp_in kernel: fp32 GELU epilogue and
    whole-row requant; ``(int8 [B, Np, N], fp32 [B, Np, 1])``."""
    B, Np, _ = x.shape
    a_q, s = _prologue_plain(x, scale, shift, norm)
    acc = int8_mm(a_q, w_q).float()
    g = _gelu(acc * s * w_scale.reshape(1, -1) + bias.reshape(1, -1).float(),
              gelu_impl)
    gs = (g.abs().amax(dim=1, keepdim=True) * _INV127).clamp_min(1e-12)
    g_q = torch.round(g / gs).to(torch.int8)
    return g_q.reshape(B, Np, -1), gs.reshape(B, Np, 1)


def _check(what, x, scale, shift, w_q, w_scale, bias, norm):
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be [B, Np, H], got {tuple(x.shape)}")
    B, Np, H = x.shape
    if norm not in NORMS:
        raise ValueError(f"{what}: norm {norm!r} not in {NORMS}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dim() != 2 or t.shape[1] != H or t.shape[0] not in (1, B):
            raise ValueError(f"{what}: {name} must be [1, {H}] or [{B}, {H}], "
                             f"got {tuple(t.shape)}")
    return (B, Np) + check_weights(what, H, w_q, w_scale, bias)


def int8_norm_mod_dot(x, scale, shift, w_q, w_scale, bias, *, norm="rms"):
    """``bf16(dequant(quant(norm_mod(x)) @ w_q) + bias)`` -> [B, Np, N].

    Args:
        x: [B, Np, H] bf16 raw residual stream.
        scale, shift: [B or 1, H] AdaLN rows (the "1 +" is inside).
        w_q: [H, N] int8; w_scale: [1, N] fp32; bias: [1, N] fp32 (zeros
            when the projection has none).
    """
    B, Np, H, N = _check("norm_mod_dot", x, scale, shift, w_q, w_scale, bias,
                         norm)
    if x.device.type == "cpu":
        return norm_mod_dot_plain(x, scale, shift, w_q, w_scale, bias, norm)
    from . import _build

    lib, head, _ = _shared_args("norm_mod_dot", x, scale, shift, w_q, w_scale,
                                bias)
    out = torch.empty((B, Np, N), dtype=torch.bfloat16, device=x.device)
    fn = lib.norm_mod_dot
    fn.restype = ctypes.c_int
    fn.argtypes = _HEAD_TYPES + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = fn(*head, out.data_ptr(), B * Np, Np, H, N, int(norm == "rms"),
             _build.stream_ptr(x.device))
    _build.check(lib, err, "norm_mod_dot")
    int8_norm_mod_dot.launches += 1
    return out


int8_norm_mod_dot.launches = 0


def int8_norm_mod_dense_gelu_quant(x, scale, shift, w_q, w_scale, bias, *,
                                   norm="rms", gelu_impl="tanh"):
    """``quantize(gelu(dequant(quant(norm_mod(x)) @ w_q) + b))`` with an
    fp32 epilogue -> (int8 [B, Np, N], fp32 row scales [B, Np, 1]).

    Arguments as :func:`int8_norm_mod_dot`.
    """
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl {gelu_impl!r} not in {GELU_IMPLS}")
    B, Np, H, N = _check("norm_mod_dense_gelu_quant", x, scale, shift, w_q,
                         w_scale, bias, norm)
    if x.device.type == "cpu":
        return norm_mod_dense_gelu_quant_plain(x, scale, shift, w_q, w_scale,
                                               bias, norm, gelu_impl)
    from . import _build

    lib, head, _ = _shared_args("norm_mod_dense_gelu_quant", x, scale, shift,
                                w_q, w_scale, bias)
    M, dev = B * Np, x.device
    g = torch.empty((M, N), dtype=torch.float32, device=dev)
    rowmax = torch.empty((M,), dtype=torch.int32, device=dev)
    g_q = torch.empty((B, Np, N), dtype=torch.int8, device=dev)
    g_s = torch.empty((B, Np, 1), dtype=torch.float32, device=dev)
    fn = lib.norm_mod_dense_gelu_quant
    fn.restype = ctypes.c_int
    fn.argtypes = _HEAD_TYPES + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    err = fn(*head, g.data_ptr(), rowmax.data_ptr(), g_q.data_ptr(),
             g_s.data_ptr(), M, Np, H, N, int(norm == "rms"),
             GELU_IMPLS.index(gelu_impl), _build.stream_ptr(dev))
    _build.check(lib, err, "norm_mod_dense_gelu_quant")
    int8_norm_mod_dense_gelu_quant.launches += 1
    return g_q, g_s


int8_norm_mod_dense_gelu_quant.launches = 0

# C types of the leading arguments both entry points take:
# x, scale, shift, mod_stride, wq, ws, bias, aq, s.
_HEAD_TYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5


def _shared_args(what, x, scale, shift, w_q, w_scale, bias):
    """Load the kernels' library and lay out the leading C arguments (see
    ``_HEAD_TYPES``), with the scratch they need.  Returns the library, the
    arguments and the tensors behind the pointers, which the caller holds
    until the launch is enqueued."""
    from . import _build

    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {x.dtype}")
    B, Np, H = x.shape
    N = w_q.shape[1]
    lib = _build.load("norm_mod")
    x = _build.aligned(x)
    sc = _build.aligned(scale.float())
    sh = _build.aligned(shift.float())
    w_q = _build.aligned(w_q)
    ws = w_scale.reshape(N).float().contiguous()
    b = bias.reshape(N).float().contiguous()
    a_q = torch.empty((B * Np, H), dtype=torch.int8, device=x.device)
    s = torch.empty((B * Np,), dtype=torch.float32, device=x.device)
    mod_stride = 0 if sc.shape[0] == 1 else H
    tensors = (x, sc, sh, w_q, ws, b, a_q, s)
    ptrs = [t.data_ptr() for t in tensors]
    return lib, ptrs[:3] + [mod_stride] + ptrs[3:], tensors
