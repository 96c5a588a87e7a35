"""Fused norm + AdaLN modulate + row quantisation in front of the s8 GEMM.

Ports of ``int8_norm_mod_dot`` (the qkv projection) and
``int8_norm_mod_dense_gelu_quant`` (mlp_in) from the JAX package's
``ops/int8_matmul.py``, with their eligibility gate.  Both read the raw
residual stream ``x [B, Np, H]`` and one AdaLN ``(scale, shift)`` row per
sample, ``[B, H]`` or ``[1, H]`` (the sampler's hoisted table, shared over
the batch), bf16 or fp32 (the JAX model at ``dtype="float32"``: the same
statistics, roundings and codes from fp32 loads; the qkv kernel then
writes fp32, its ``out_dtype``).  Each wrapper dispatches on the tensor's device: a CPU tensor
takes the plain PyTorch version below, a CUDA tensor launches the
hand-written kernel in ``csrc/norm_mod.cu`` (the prologue, then the s8
``wgmma`` GEMM of ``csrc/s8_wgmma.cuh``) or raises.  Nothing falls back.

``wgmma`` reads 8-bit operands K-major only, so on the card the GEMM takes
the weight a second time as ``w_t [N, H]``, ``w_q`` transposed and
contiguous: the serving DiT makes that copy once, beside ``w_q``
(``models/dit.py``).  The plain versions read ``w_q [H, N]``; they check
``w_t``'s shape where it is given and do not read it.
"""

from __future__ import annotations

import ctypes

import torch

from .int8_matmul import (_INV127, GELU_IMPLS, KERNEL_DTYPES, _gelu,
                          check_t, check_weights, group_max, int8_mm)

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


def s8_dot_plain(a_q, s, w_q, w_scale, bias, out_dtype=torch.bfloat16):
    """Plain PyTorch version of the qkv kernel's GEMM and epilogue on a
    prologue's codes ``a_q [M, H]`` and scales ``s [M, 1]``: ``out_dtype(((acc
    * s) * ws) + b)``, ``[M, N]``."""
    acc = int8_mm(a_q, w_q).float()
    y = acc * s.reshape(-1, 1) * w_scale.reshape(1, -1) \
        + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def s8_gelu_quant_plain(a_q, s, w_q, w_scale, bias, gelu_impl="tanh",
                        group=None):
    """Plain PyTorch version of the mlp_in kernel's GEMM and epilogue on a
    prologue's ``a_q`` and ``s``: the fp32 GELU and the whole-row requant;
    ``(int8 [M, N], fp32 [M, 1])``.  ``group``: the model group whose
    ranks hold the other columns (the requant over the whole row)."""
    acc = int8_mm(a_q, w_q).float()
    g = _gelu(acc * s.reshape(-1, 1) * w_scale.reshape(1, -1)
              + bias.reshape(1, -1).float(), gelu_impl)
    gs = (group_max(group, g.abs().amax(dim=1, keepdim=True)) * _INV127
          ).clamp_min(1e-12)
    return torch.round(g / gs).to(torch.int8), gs


def norm_mod_dot_plain(x, scale, shift, w_q, w_scale, bias, norm="rms",
                       out_dtype=torch.bfloat16):
    """Plain PyTorch version of the qkv kernel: ``out_dtype(((acc * s) *
    ws) + b)``, ``[B, Np, N]``."""
    B, Np, _ = x.shape
    a_q, s = _prologue_plain(x, scale, shift, norm)
    return s8_dot_plain(a_q, s, w_q, w_scale, bias, out_dtype).reshape(
        B, Np, -1)


def norm_mod_dense_gelu_quant_plain(x, scale, shift, w_q, w_scale, bias,
                                    norm="rms", gelu_impl="tanh", group=None):
    """Plain PyTorch version of the mlp_in kernel: fp32 GELU epilogue and
    whole-row requant; ``(int8 [B, Np, N], fp32 [B, Np, 1])``.  ``group``:
    as :func:`s8_gelu_quant_plain`'s."""
    B, Np, _ = x.shape
    a_q, s = _prologue_plain(x, scale, shift, norm)
    g_q, gs = s8_gelu_quant_plain(a_q, s, w_q, w_scale, bias, gelu_impl,
                                  group)
    return g_q.reshape(B, Np, -1), gs.reshape(B, Np, 1)


def _check(what, x, scale, shift, w_q, w_scale, bias, norm, w_t=None):
    check_t(what, w_q, w_t)
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


def int8_norm_mod_dot(x, scale, shift, w_q, w_scale, bias, *, norm="rms",
                      out_dtype=torch.bfloat16, w_t=None):
    """``out_dtype(dequant(quant(norm_mod(x)) @ w_q) + bias)`` -> [B, Np, N].

    Args:
        x: [B, Np, H] bf16 or fp32 raw residual stream.
        scale, shift: [B or 1, H] AdaLN rows (the "1 +" is inside).
        w_q: [H, N] int8; w_scale: [1, N] fp32; bias: [1, N] fp32 (zeros
            when the projection has none).
        out_dtype: bf16 or fp32 (the JAX kernel's ``out_dtype``, which the
            JAX model sets to its compute dtype).
        w_t: [N, H] int8, ``w_q.t()`` contiguous: the K-major copy the
            kernel reads; needed on the card.

    ``launches`` counts every launch; ``f32_launches`` those of the fp32
    mode (an fp32 ``x``).
    """
    B, Np, H, N = _check("norm_mod_dot", x, scale, shift, w_q, w_scale, bias,
                         norm, w_t)
    if x.device.type == "cpu":
        return norm_mod_dot_plain(x, scale, shift, w_q, w_scale, bias, norm,
                                  out_dtype)
    from . import _build

    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"norm_mod_dot kernel writes bf16 or fp32, not "
                        f"{out_dtype}")
    lib, head, _ = _shared_args("norm_mod_dot", x, scale, shift, w_t, w_scale,
                                bias)
    out = torch.empty((B, Np, N), dtype=out_dtype, device=x.device)
    fn = lib.norm_mod_dot_dt
    fn.restype = ctypes.c_int
    fn.argtypes = _HEAD_TYPES + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    f32 = x.dtype == torch.float32
    err = fn(*head, out.data_ptr(), B * Np, Np, H, N, int(norm == "rms"),
             int(f32), int(out_dtype == torch.float32),
             _build.stream_ptr(x.device))
    _build.check(lib, err, "norm_mod_dot")
    int8_norm_mod_dot.launches += 1
    int8_norm_mod_dot.f32_launches += f32
    return out


int8_norm_mod_dot.launches = 0
int8_norm_mod_dot.f32_launches = 0


def int8_norm_mod_dense_gelu_quant(x, scale, shift, w_q, w_scale, bias, *,
                                   norm="rms", gelu_impl="tanh", w_t=None):
    """``quantize(gelu(dequant(quant(norm_mod(x)) @ w_q) + b))`` with an
    fp32 epilogue -> (int8 [B, Np, N], fp32 row scales [B, Np, 1]).

    Arguments as :func:`int8_norm_mod_dot` (bf16 or fp32 ``x``); the
    launches are counted as there.
    """
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl {gelu_impl!r} not in {GELU_IMPLS}")
    B, Np, H, N = _check("norm_mod_dense_gelu_quant", x, scale, shift, w_q,
                         w_scale, bias, norm, w_t)
    if x.device.type == "cpu":
        return norm_mod_dense_gelu_quant_plain(x, scale, shift, w_q, w_scale,
                                               bias, norm, gelu_impl)
    from . import _build

    lib, head, _ = _shared_args("norm_mod_dense_gelu_quant", x, scale, shift,
                                w_t, w_scale, bias)
    M, dev = B * Np, x.device
    part = torch.empty((M, -(-N // _TILE_N)), dtype=torch.float32, device=dev)
    g_q = torch.empty((B, Np, N), dtype=torch.int8, device=dev)
    g_s = torch.empty((B, Np, 1), dtype=torch.float32, device=dev)
    fn = lib.norm_mod_dense_gelu_quant_dt
    fn.restype = ctypes.c_int
    fn.argtypes = _HEAD_TYPES + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    f32 = x.dtype == torch.float32
    err = fn(*head, part.data_ptr(), g_q.data_ptr(), g_s.data_ptr(), M, Np, H,
             N, int(norm == "rms"), GELU_IMPLS.index(gelu_impl), int(f32),
             _build.stream_ptr(dev))
    _build.check(lib, err, "norm_mod_dense_gelu_quant")
    int8_norm_mod_dense_gelu_quant.launches += 1
    int8_norm_mod_dense_gelu_quant.f32_launches += f32
    return g_q, g_s


int8_norm_mod_dense_gelu_quant.launches = 0
int8_norm_mod_dense_gelu_quant.f32_launches = 0

# C types of the leading arguments both entry points take:
# x, scale, shift, mod_stride, wt, ws, bias, aq, s.
_HEAD_TYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
_TILE_N = 128  # output columns of an s8_wgmma.cuh tile: B1's row-max partials


def _weights_t(what, w_t, w_scale, bias):
    """The K-major weight as the kernels read it (16-byte aligned; K a
    multiple of the GEMM's 128-deep stages) and the fp32 scale and bias
    vectors."""
    from . import _build

    if w_t is None:
        raise ValueError(f"{what}: the card's kernel reads the weight K-major: "
                         f"pass w_t = w_q.t().contiguous(), made once")
    N, K = w_t.shape
    if K % 128 or N % 128:
        raise ValueError(f"{what}: the s8 wgmma GEMM needs H % 128 == 0 and "
                         f"N % 128 == 0, got {K}, {N}")
    return (_build.aligned(w_t), w_scale.reshape(N).float().contiguous(),
            bias.reshape(N).float().contiguous())


def _shared_args(what, x, scale, shift, w_t, w_scale, bias):
    """Load the kernels' library and lay out the leading C arguments (see
    ``_HEAD_TYPES``), with the scratch they need.  Returns the library, the
    arguments and the tensors behind the pointers, which the caller holds
    until the launch is enqueued."""
    from . import _build

    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or fp32, got {x.dtype}")
    B, Np, H = x.shape
    w_t, ws, b = _weights_t(what, w_t, w_scale, bias)
    lib = _build.load("norm_mod")
    x = _build.aligned(x)
    sc = _build.aligned(scale.float())
    sh = _build.aligned(shift.float())
    a_q = torch.empty((B * Np, H), dtype=torch.int8, device=x.device)
    s = torch.empty((B * Np,), dtype=torch.float32, device=x.device)
    mod_stride = 0 if sc.shape[0] == 1 else H
    tensors = (x, sc, sh, w_t, ws, b, a_q, s)
    ptrs = [t.data_ptr() for t in tensors]
    return lib, ptrs[:3] + [mod_stride] + ptrs[3:], tensors


def _gemm_args(what, a_q, s, w_t, w_scale, bias):
    """The card's GEMM entries' inputs: ``a_q [M, K]`` int8 codes and ``s``
    their ``M`` fp32 row scales, as a prologue writes them."""
    from . import _build

    M, K = a_q.shape
    if a_q.dtype != torch.int8 or s.numel() != M or w_t.shape[1] != K:
        raise ValueError(f"{what}: a_q int8 [M, K], s [M], w_t [N, K]; got "
                         f"{tuple(a_q.shape)} {a_q.dtype}, {s.numel()}, "
                         f"{tuple(w_t.shape)}")
    w_t, ws, b = _weights_t(what, w_t, w_scale, bias)
    return (_build.aligned(a_q), s.reshape(M).float().contiguous(), w_t, ws,
            b)


def s8_dot(a_q, s, w_t, w_scale, bias):
    """B3's GEMM and epilogue alone on the card, on a prologue's ``a_q``
    and ``s`` (``csrc/norm_mod.cu:s8_dot``; the card tests hold it against
    :func:`s8_dot_plain`): ``[M, N]`` bf16.  Not counted as a launch of
    :func:`int8_norm_mod_dot`."""
    from . import _build

    a_q, s, w_t, ws, b = _gemm_args("s8_dot", a_q, s, w_t, w_scale, bias)
    (M, K), N = a_q.shape, w_t.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a_q.device)
    lib = _build.load("norm_mod")
    lib.s8_dot.restype = ctypes.c_int
    lib.s8_dot.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = lib.s8_dot(a_q.data_ptr(), s.data_ptr(), w_t.data_ptr(),
                     ws.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                     _build.stream_ptr(a_q.device))
    _build.check(lib, err, "s8_dot")
    return out


def s8_gelu_quant(a_q, s, w_t, w_scale, bias, gelu_impl="tanh"):
    """B1's two GEMM passes alone on the card, on a prologue's ``a_q`` and
    ``s`` (``csrc/norm_mod.cu:s8_gelu_quant``; held against
    :func:`s8_gelu_quant_plain`): ``(int8 [M, N], fp32 [M, 1])``.  Not
    counted as a launch of :func:`int8_norm_mod_dense_gelu_quant`."""
    from . import _build

    a_q, s, w_t, ws, b = _gemm_args("s8_gelu_quant", a_q, s, w_t, w_scale,
                                    bias)
    (M, K), N = a_q.shape, w_t.shape[0]
    dev = a_q.device
    part = torch.empty((M, -(-N // _TILE_N)), dtype=torch.float32, device=dev)
    g_q = torch.empty((M, N), dtype=torch.int8, device=dev)
    g_s = torch.empty((M, 1), dtype=torch.float32, device=dev)
    lib = _build.load("norm_mod")
    lib.s8_gelu_quant.restype = ctypes.c_int
    lib.s8_gelu_quant.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = lib.s8_gelu_quant(
        a_q.data_ptr(), s.data_ptr(), w_t.data_ptr(), ws.data_ptr(),
        b.data_ptr(), part.data_ptr(), g_q.data_ptr(), g_s.data_ptr(), M, K,
        N, GELU_IMPLS.index(gelu_impl), 3, _build.stream_ptr(dev))
    _build.check(lib, err, "s8_gelu_quant")
    return g_q, g_s
