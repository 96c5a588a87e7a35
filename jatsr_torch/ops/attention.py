"""The serving attention kernels: flash GQA from the unsplit fused-QKV
projection, alone or with the int8 out projection fused in, and GQA on
split, RoPE'd q/k/v (the flash kernel and the per-q-head and per-kv-head
kernels).

Ports of ``gqa_attention_flash_qkv``, ``gqa_attention_flash_out``,
``gqa_attention_flash``, ``gqa_attention`` and ``gqa_attention_grouped``
(JAX package, ``ops/attention.py``).  Each wrapper dispatches on the
tensor's device: a CPU tensor takes the plain PyTorch version below, a CUDA
tensor launches the hand-written kernel in ``csrc/attention_deferred.cu``
(the two base-2 flash kernels, from the unsplit projection, with or without
its int8 value product, and on split q/k/v), ``csrc/flash_qkv.cu`` (the
flash kernel with the out projection) or ``csrc/attention_natural.cu`` (the per-q-head and per-kv-head kernels),
at head dims past 128 ``csrc/attention_wide.cu`` (all five), or raises.  On
fp32 inputs (the JAX model's at ``dtype="float32"``) each of the five, and
the int8 value product, takes its fp32 mode, ``csrc/attention_f32.cu``
(fp32 products on the CUDA cores); its launches count in ``launches`` (or
``int8_qk_launches``) and apart in ``f32_launches`` (or
``int8_qk_f32_launches``).  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .int8_matmul import _INV127, check_weights, group_max, group_sum, int8_mm

# The TPU kernels' per-program VMEM budget: beyond it the JAX model takes
# its XLA einsum path, and so does the port.
_FLASH_VMEM_BUDGET = 12 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def flash_supported(n: int, num_q_heads: int, num_kv_heads: int,
                    d: int) -> bool:
    """The JAX package's eligibility gate for the flash kernels (a copy, so
    the port picks the same branch the JAX model picks)."""
    np_ = _round_up(n, 8)
    td = (num_q_heads + 2 * num_kv_heads) * d
    est = (np_ * td * 2
           + np_ * num_q_heads * d * 2
           + np_ * 2 * num_kv_heads * d * 2
           + 3 * np_ * np_ * 4)
    return est <= _FLASH_VMEM_BUDGET


def _rope(x, cos, sin):
    """Half-rotation RoPE of ``x [.., N, D]`` in x's dtype (each op rounds)."""
    d = x.shape[-1]
    xr = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + xr * sin


def _scores_plain(qkv, cos, sin, hq, hkv, n_valid, scale_dim=None):
    """The flash kernels' masked base-2 scores ``[B, Hq, N, N]`` fp32 and
    the ``[B, Hq, N, D]`` values (kv heads repeated); ``scale_dim`` (D by
    default) is the head dim whose ``1/sqrt`` scales q (the true one where
    the heads are zero-padded, :func:`pad_heads`)."""
    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    g = hq // hkv
    dt = qkv.dtype
    scale2 = (1.0 / math.sqrt(scale_dim or D)) * math.log2(math.e)
    cos = cos.to(dt)
    sin = sin.to(dt)
    heads = qkv.reshape(B, N, hq + 2 * hkv, D).permute(0, 2, 1, 3)
    q = _rope(heads[:, :hq], cos, sin) * torch.tensor(scale2, dtype=dt)
    k = _rope(heads[:, hq:hq + hkv], cos, sin)
    v = heads[:, hq + hkv:]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = q.float() @ k.float().transpose(-1, -2)
    col = torch.arange(N, device=qkv.device)
    s = s.masked_fill(col >= (n_valid or N), float("-inf"))
    return s, v


def flash_qkv_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid=0,
                    scale_dim=None, int8_qk=False):
    """Plain PyTorch version of the kernel, with its rounding points
    (``scale_dim``: see :func:`_scores_plain`).

    ``int8_qk``: the value product in s8 x s8 -> s32.  e (fp32, unrounded,
    row max exactly 1) becomes ``round(e * 127)``; v is quantised per
    (batch, kv-head, column) over all N rows, the rows past ``n_valid``
    too (masked only as keys): ``sv = max(absmax * _INV127, 1e-12)``,
    ``round(v / sv)``; ``o = (acc * (r * _INV127)) * sv``, ``r = 1 /
    sum(e)``.  Every product and sum of the codes is an integer below
    2^24, so the float64 product here is exact."""
    B, N, _ = qkv.shape
    dt = qkv.dtype
    s, v = _scores_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid,
                         scale_dim)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    if int8_qk:
        vf = v.float()
        sv = (vf.abs().amax(dim=2, keepdim=True) * _INV127).clamp_min(1e-12)
        acc = torch.round(e * 127.0).double() @ torch.round(vf / sv).double()
        o = (acc.float() * (r * _INV127)) * sv
    else:
        o = (e.to(dt).float() @ v.float()) * r
    return o.to(dt).permute(0, 2, 1, 3).reshape(B, N, -1)


def gqa_attention_flash_qkv(qkv, cos, sin, num_q_heads: int,
                            num_kv_heads: int, n_valid: int = 0,
                            int8_qk: bool = False):
    """Flash GQA from the raw fused-QKV projection output.

    Args:
        qkv: [B, N, (Hq + 2*Hkv) * D]: q heads, then k heads, then v heads,
            before RoPE (the rotation happens inside).
        cos/sin: [N, D] fp32 RoPE tables.
        n_valid: keys at positions >= n_valid are masked; 0 means N.
        int8_qk: the value product in s8 x s8 -> s32 (see
            :func:`flash_qkv_plain`).  On the card v's codes and scales
            are made by a launch of their own before the attention's.
            Launches are counted apart: ``launches`` counts those with the
            bf16 value product, ``int8_qk_launches`` those with the s8 one.
    Returns:
        [B, N, Hq*D] in qkv's dtype.

    An fp32 qkv (the JAX model's at ``dtype="float32"``) takes the fp32
    mode on the card, ``csrc/attention_f32.cu``: every product in fp32, as
    the JAX kernel computes it on an fp32 input (:func:`flash_qkv_plain`
    is that too).  ``launches`` counts it as well; ``f32_launches`` counts
    it alone.  With ``int8_qk`` the fp32 mode takes the codes of the fp32 v
    (one launch of :func:`_v_codes`), then the s8 value product on fp32
    scores; ``int8_qk_launches`` counts it as well, ``int8_qk_f32_launches``
    alone.
    """
    B, N, TD = qkv.shape
    if TD % (num_q_heads + 2 * num_kv_heads) or num_q_heads % num_kv_heads:
        raise ValueError(f"qkv width {TD} does not split into "
                         f"{num_q_heads}+2x{num_kv_heads} heads")
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid {n_valid} outside [0, {N}]")
    if qkv.device.type == "cpu":
        return flash_qkv_plain(qkv, cos, sin, num_q_heads, num_kv_heads,
                               n_valid, int8_qk=int8_qk)
    hq, hkv = num_q_heads, num_kv_heads
    if qkv.dtype == torch.float32:
        out = _flash_f32(qkv, cos, sin, hq, hkv, n_valid or N, int8_qk)
        if int8_qk:
            gqa_attention_flash_qkv.int8_qk_launches += 1
            gqa_attention_flash_qkv.int8_qk_f32_launches += 1
        else:
            gqa_attention_flash_qkv.launches += 1
            gqa_attention_flash_qkv.f32_launches += 1
        return out
    q, k, v, cos, sin = _qkv_views(qkv, cos, sin, hq, hkv)
    out = _flash_deferred(q, k, v, hq, hkv, n_valid or N, cos, sin,
                          int8_v=int8_qk)
    if int8_qk:
        gqa_attention_flash_qkv.int8_qk_launches += 1
    else:
        gqa_attention_flash_qkv.launches += 1
    return out


gqa_attention_flash_qkv.launches = 0
gqa_attention_flash_qkv.int8_qk_launches = 0
gqa_attention_flash_qkv.f32_launches = 0
gqa_attention_flash_qkv.int8_qk_f32_launches = 0

# ---- the fp32 modes (csrc/attention_f32.cu) ---------------------------------

F32_MAX_D = 256  # csrc/attention_f32.cu's widest tile
# attention_f32's modes: B2, B11, B15/B16, B2 with int8_qk, B12's attention,
# B10's forward (ops/attention_train.py).
_F32_MODE = {"flash_qkv": 0, "flash": 1, "natural": 2, "int8_qk": 3,
             "flash_out": 4, "train": 5}


class _F32Args(ctypes.Structure):
    """``F32Args`` of csrc/attention_f32.cu, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "q", "k", "v", "cos", "sin", "codes", "sv", "out")]
        + [(f, ctypes.c_longlong) for f in ("q_row", "k_row", "v_row")]
        + [(f, ctypes.c_int) for f in (
            "N", "limit", "npad", "hq", "hkv", "D", "out_dp", "codes_d", "nk")]
        + [("scale", ctypes.c_float), ("stats", ctypes.c_void_p)]
        + [(f, ctypes.c_uint32) for f in ("seed", "thr")]
        + [(f, ctypes.c_int) for f in ("np", "dropout")]
        + [("coef", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in ("b0", "h0")])


@functools.cache
def _f32_lib():
    """csrc/attention_f32.cu's library, its entry points' C types set."""
    from . import _build

    lib = _build.load("attention_f32")
    lib.attention_f32.restype = ctypes.c_int
    lib.attention_f32.argtypes = [ctypes.POINTER(_F32Args), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.attention_f32_flash_out.restype = ctypes.c_int
    lib.attention_f32_flash_out.argtypes = (
        [ctypes.POINTER(_F32Args), ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _columns(qkv, hq, hkv, D):
    """The q, k and v column views of the unsplit projection ``[B, N, (hq
    + 2 hkv) D]``."""
    return (qkv[..., a * D:b * D]
            for a, b in ((0, hq), (hq, hq + hkv), (hq + hkv, hq + 2 * hkv)))


def _f32(x: float) -> float:
    """fp32(x), as a float: a scale as the JAX kernels multiply by it."""
    return float(torch.tensor(x, dtype=torch.float32))


def _f32_args(q, k, v, hq, hkv, D, out, limit, scale, npad=0, cos=None,
              sin=None, out_dp=None, codes=None, sv=None, nk=0):
    """The C struct of one launch of csrc/attention_f32.cu on fp32 views
    ``q [B, N, hq * D]``, ``k``/``v [B, N, hkv * D]`` (heads dense, each a
    row stride apart; ``[B, N, H, D]`` alike) into ``out [B, N, hq,
    out_dp]``, and the tensors it reads (kept alive by the caller until the
    launch is queued)."""
    N = q.shape[1]
    out_dp = out_dp or D
    if D > F32_MAX_D or out_dp > F32_MAX_D:
        raise ValueError(f"the fp32 attention kernels take head dims up to "
                         f"{F32_MAX_D}, got {D}")
    (q, q_row), (k, k_row), (v, v_row) = map(_row_view, (q, k, v))
    widest = max(q_row, k_row, v_row, hq * out_dp)
    if N * widest >= 2 ** 31:  # the kernel's in-batch offsets
        raise ValueError(f"fp32 attention: a batch's {N} rows of {widest} "
                         f"outgrow 32-bit offsets")
    keep = [q, k, v]
    if cos is not None:
        if cos.shape != (N, D) or sin.shape != (N, D):
            raise ValueError(f"cos/sin must be [{N}, {D}]")
        cos, sin = cos.float().contiguous(), sin.float().contiguous()
        keep += [cos, sin]
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = _F32Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(cos),
                    ptr(sin), ptr(codes), ptr(sv), out.data_ptr(), q_row,
                    k_row, v_row, N, limit, npad, hq, hkv, D, out_dp,
                    0 if codes is None else codes.shape[2], nk, scale)
    return args, keep


def _launch_f32(mode, args, B, device, what):
    from . import _build

    lib = _f32_lib()
    err = lib.attention_f32(ctypes.byref(args), _F32_MODE[mode], B,
                            _build.stream_ptr(device))
    _build.check(lib, err, what)


def _scale2_f32(d: int) -> float:
    """fp32(scale * log2 e), the base-2 kernels' q factor in fp32 mode."""
    return _f32((1.0 / math.sqrt(d)) * math.log2(math.e))


def _flash_f32(qkv, cos, sin, hq, hkv, n_valid, int8_qk=False):
    """B2's fp32 mode: one launch of ``csrc/attention_f32.cu`` on the
    unsplit fp32 qkv ``[B, N, (hq + 2 hkv) D]`` and the fp32 tables ``[N,
    D]``, keys at or past ``n_valid`` masked -> ``[B, N, hq D]`` fp32.
    ``int8_qk``: first the codes of the fp32 v (:func:`_v_codes`, each
    head widened by zero columns at its end to :func:`padded_head_dim`, a
    multiple of 16), then the s8 value product."""
    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    if D % 2:
        raise ValueError(f"the fp32 flash kernel takes an even head dim "
                         f"(RoPE pairs its halves), got {D}")
    q, k, v = _columns(qkv, hq, hkv, D)
    out = torch.empty((B, N, hq * D), dtype=torch.float32, device=qkv.device)
    codes = sv = None
    nk = 0
    if int8_qk:
        dc = padded_head_dim(D)
        vc, v_row = _row_view(F.pad(v.reshape(B, N, hkv, D), (0, dc - D))
                              .reshape(B, N, hkv * dc) if dc != D else v)
        nk = _round_up(N, _NATURAL_CHUNK)
        codes, sv = _v_codes(vc, v_row, hkv, dc, nk)
    args, keep = _f32_args(q, k, v, hq, hkv, D, out, n_valid, _scale2_f32(D),
                           cos=cos, sin=sin, codes=codes, sv=sv, nk=nk)
    _launch_f32("int8_qk" if int8_qk else "flash_qkv", args, B, qkv.device,
                "gqa_attention_flash_qkv(fp32" + (", int8_qk)" if int8_qk
                                                  else ")"))
    return out


def _flash_split_f32(q, k, v, hq, hkv):
    """B11's fp32 mode: one launch on fp32 ``q [B, N, hq D]``, ``k``/``v
    [B, N, hkv D]``, N padded to a multiple of 8 with zero keys that take
    part in the row max, their share taken off the row sum."""
    B, N = q.shape[:2]
    D = q.shape[2] // hq
    limit = _round_up(N, 8)
    out = torch.empty((B, N, hq * D), dtype=torch.float32, device=q.device)
    args, keep = _f32_args(q, k, v, hq, hkv, D, out, limit, _scale2_f32(D),
                           npad=limit - N)
    _launch_f32("flash", args, B, q.device, "gqa_attention_flash(fp32)")
    return out


def _natural_f32(q, k, v, what):
    """B15's and B16's fp32 mode: one launch on fp32 ``q [B, N, Hq, D]``,
    ``k``/``v [B, N, Hkv, D]``: the scale after the product, exp, w = e / l
    rounded, then w @ v.  Both run on B16's grid (a CTA per 64 of a kv
    head's stacked rows)."""
    B, N, hq, D = q.shape
    out = torch.empty((B, N, hq, D), dtype=torch.float32, device=q.device)
    args, keep = _f32_args(q, k, v, hq, k.shape[2], D, out, N,
                           _f32(1.0 / math.sqrt(D)))
    _launch_f32("natural", args, B, q.device, what)
    return out


def _flash_out_f32(qkv, cos, sin, wo_t, wo_scale, wo_bias, hq, hkv, n_valid,
                   H):
    """B12's fp32 mode: the attention (RoPE, base 2, natural weights) into
    an fp32 scratch ``[B N, hq Dp]`` (each head widened to the padded head
    dim of ``wo_t``'s rows as :func:`pad_heads` widens it), then the fp32
    row quant and the s8 GEMM with the bias: three launches -> ``[B, N,
    H]`` fp32."""
    from . import _build

    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    if D % 2:
        raise ValueError(f"the fp32 flash kernel takes an even head dim "
                         f"(RoPE pairs its halves), got {D}")
    Dp = padded_head_dim(D)
    dev = qkv.device
    q, k, v = _columns(qkv, hq, hkv, D)
    o = torch.empty((B * N, hq * Dp), dtype=torch.float32, device=dev)
    oq = torch.empty((B * N, hq * Dp), dtype=torch.int8, device=dev)
    so = torch.empty((B * N,), dtype=torch.float32, device=dev)
    out = torch.empty((B, N, H), dtype=torch.float32, device=dev)
    args, keep = _f32_args(q, k, v, hq, hkv, D, o, n_valid, _scale2_f32(D),
                           cos=cos, sin=sin, out_dp=Dp)
    wo_t = _build.aligned(wo_t)
    wos, bo = (t.reshape(H).float().contiguous() for t in (wo_scale, wo_bias))
    lib = _f32_lib()
    err = lib.attention_f32_flash_out(
        ctypes.byref(args), B, o.data_ptr(), oq.data_ptr(), so.data_ptr(),
        wo_t.data_ptr(), wos.data_ptr(), bo.data_ptr(), out.data_ptr(), H,
        _build.stream_ptr(dev))
    _build.check(lib, err, "gqa_attention_flash_out(fp32)")
    return out


def _qkv_views(qkv, cos, sin, hq, hkv):
    """The q, k and v column views of the unsplit projection and the fp32
    RoPE tables as the kernels of B2 and B12 read them, after their
    checks."""
    from . import _build

    N, TD = qkv.shape[1:]
    D = TD // (hq + 2 * hkv)
    if qkv.dtype != torch.bfloat16 or D % 2:
        raise TypeError(f"the flash kernels take bf16 with an even head dim "
                        f"(RoPE pairs its halves), got {qkv.dtype} with head "
                        f"dim {D}")
    padded_head_dim(D)
    if cos.shape != (N, D) or sin.shape != (N, D):
        raise ValueError(f"cos/sin must be [{N}, {D}]")
    qkv = _build.aligned(qkv)
    q, k, v = _columns(qkv, hq, hkv, D)
    return (q, k, v, _build.aligned(cos.float()),
            _build.aligned(sin.float()))


@functools.cache
def _scale2_bf16(d: int) -> float:
    """bf16(scale * log2 e), the flash kernels' q factor, as a float."""
    return float(torch.tensor((1.0 / math.sqrt(d)) * math.log2(math.e),
                              dtype=torch.bfloat16))


def flash_out_plain(qkv, cos, sin, wo_q, wo_scale, wo_bias, num_q_heads,
                    num_kv_heads, n_valid=0, scale_dim=None, group=None):
    """Plain PyTorch version of the fused out-projection kernel, with its
    rounding points: normalised weights rounded before the value product,
    each head's output rounded, the whole row quantised by a true divide by
    its floored scale, then ``((acc * so) * wos + bo)``.  ``group``: the
    model group whose ranks hold the other heads (qkv the rank's columns,
    ``wo_q`` its rows): the row scale over the whole row, the int32
    partial products summed before the rescale."""
    B, N, _ = qkv.shape
    dt = qkv.dtype
    s, v = _scores_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid,
                         scale_dim)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    w = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    o = (w.float() @ v.float()).to(dt)                   # [B, Hq, N, D]
    o = o.permute(0, 2, 1, 3).reshape(B * N, -1).float()
    so = (group_max(group, o.abs().amax(dim=1, keepdim=True)) * _INV127
          ).clamp_min(1e-12)
    o_q = torch.round(o / so).to(torch.int8)
    acc = group_sum(group, int8_mm(o_q, wo_q)).float()
    out = acc * so * wo_scale.reshape(1, -1) + wo_bias.reshape(1, -1).float()
    return out.to(dt).reshape(B, N, -1)


def flash_out_weight_t(wo_q, num_q_heads: int, head_dim: int):
    """The out projection's ``[Hq*D, H]`` int8 kernel as B12's card kernel
    reads it: K-major, ``[H, Hq*Dp]`` contiguous, each head's rows widened
    by zeros to the kernel's head dim ``Dp`` (:func:`padded_head_dim`,
    :func:`pad_heads`: a zero code times a zero row adds nothing).  Made
    once by the caller (the DiT), not on every call."""
    if wo_q.shape[0] != num_q_heads * head_dim:
        raise ValueError(f"wo_q rows {wo_q.shape[0]} != {num_q_heads} heads x "
                         f"{head_dim}")
    return pad_heads(wo_q.t(), head_dim, padded_head_dim(head_dim)
                     ).contiguous()


def gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_scale, wo_bias,
                            num_q_heads: int, num_kv_heads: int,
                            n_valid: int = 0, *, wo_t=None):
    """Flash GQA with the int8 output projection fused in.

    Args:
        qkv: [B, N, (Hq + 2*Hkv) * D] pre-RoPE fused projection output.
        cos/sin: [N, D] fp32 RoPE tables.
        wo_q: [Hq*D, H] int8 out-projection kernel; wo_scale: [1, H] fp32
            per-column scales; wo_bias: [1, H] fp32 (zeros where the
            projection has none).
        n_valid: keys at positions >= n_valid are masked; 0 means N.
        wo_t: [H, Hq*Dp] int8, :func:`flash_out_weight_t` of ``wo_q``: the
            K-major copy (heads padded to the kernel's head dim) that the
            card's s8 ``wgmma`` GEMM reads; needed on the card, made once
            by the caller.  The plain version checks its shape and reads
            ``wo_q``.
    Returns:
        [B, N, H] in qkv's dtype: the attention branch before the residual.

    An fp32 qkv takes the fp32 mode on the card (``csrc/attention_f32.cu``:
    the attention in fp32 into a scratch, then the fp32 row quant and the s8
    GEMM writing fp32); ``f32_launches`` counts it apart.
    """
    hq, hkv = num_q_heads, num_kv_heads
    H, K = flash_out_check(qkv, wo_q, wo_scale, wo_bias, hq, hkv, n_valid,
                           wo_t)
    if qkv.device.type == "cpu":
        return flash_out_plain(qkv, cos, sin, wo_q, wo_scale, wo_bias, hq, hkv,
                               n_valid)
    from . import _build

    B, N, _ = qkv.shape
    if qkv.dtype == torch.float32:
        out = _flash_out_f32(qkv, cos, sin, wo_t, wo_scale, wo_bias, hq, hkv,
                             n_valid or N, H)
        gqa_attention_flash_out.launches += 1
        gqa_attention_flash_out.f32_launches += 1
        return out
    att = FlashOutAttention(qkv, cos, sin, hq, hkv, n_valid)
    dev = qkv.device
    wo_t = _build.aligned(wo_t)
    wos, bo = (t.reshape(H).float().contiguous() for t in (wo_scale, wo_bias))
    o = torch.empty((B * N, K), dtype=torch.bfloat16, device=dev)
    oq = torch.empty((B * N, K), dtype=torch.int8, device=dev)
    so = torch.empty((B * N,), dtype=torch.float32, device=dev)
    out = torch.empty((B, N, H), dtype=torch.bfloat16, device=dev)
    st = _build.stream_ptr(dev)
    if att.wide:  # the rope pass, attention, quant, GEMM
        lib = _wide_lib()
        err = lib.flash_out_wide(
            *att.head(), wo_t.data_ptr(), wos.data_ptr(), bo.data_ptr(),
            o.data_ptr(), oq.data_ptr(), so.data_ptr(), out.data_ptr(), B, H,
            st)
        _build.check(lib, err, "flash_out_wide")
        gqa_attention_flash_out.launches += 1
        return out
    lib = _flash_out_lib()
    gx, gy, gz = att.grid
    err = lib.flash_out(
        *att.head(), wo_t.data_ptr(), wos.data_ptr(), bo.data_ptr(),
        o.data_ptr(), oq.data_ptr(), so.data_ptr(), out.data_ptr(), att.D, gz,
        gx, gy, att.plan.warps, att.plan.smem, H, st)
    _build.check(lib, err, "flash_out")
    gqa_attention_flash_out.launches += 1
    return out


def flash_out_check(qkv, wo_q, wo_scale, wo_bias, hq, hkv, n_valid, wo_t):
    """B12's argument checks (the whole kernel's and its split entry's, on
    the heads ``qkv`` holds): ``(H, K)``, the output width and the GEMM's
    contraction over the heads at their padded width."""
    B, N, TD = qkv.shape
    if TD % (hq + 2 * hkv) or hq % hkv:
        raise ValueError(f"qkv width {TD} does not split into "
                         f"{hq}+2x{hkv} heads")
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid {n_valid} outside [0, {N}]")
    D = TD // (hq + 2 * hkv)
    K = hq * padded_head_dim(D)
    _, H = check_weights("flash_out", hq * D, wo_q, wo_scale, wo_bias,
                         k_run=K, k_mult=16)
    if wo_t is not None and (wo_t.shape != (H, K) or wo_t.dtype != torch.int8
                             or not wo_t.is_contiguous()):
        raise ValueError(f"flash_out: wo_t must be flash_out_weight_t(wo_q), "
                         f"int8 [{H}, {K}] contiguous, got "
                         f"{tuple(wo_t.shape)} {wo_t.dtype}")
    if qkv.device.type != "cpu" and wo_t is None:
        raise ValueError("flash_out: the card's kernel reads the out "
                         "projection K-major: pass wo_t = "
                         "flash_out_weight_t(wo_q, hq, D), made once")
    return H, K


class FlashOutAttention:
    """B12's attention launch on the card, as its C entries take it: the
    views of a bf16 ``qkv``'s heads (zero-padded to the kernel's head dim
    ``D``), RoPE's fp32 tables, the launch plan on B2's grid (``wide``: a
    :class:`WidePlan`, head dims past 128, with its rope scratch).
    :meth:`head` is the entries' leading arguments."""

    def __init__(self, qkv, cos, sin, hq, hkv, n_valid):
        B, N, _ = qkv.shape
        q, k, v, cos, sin = _qkv_views(qkv, cos, sin, hq, hkv)
        D = q.shape[-1] // hq
        scale2 = _scale2_bf16(D)
        Dp = padded_head_dim(D)
        if Dp != D:  # zero head columns: the same scores, outputs and codes
            q, k, v, cos, sin = (pad_heads(t, D, Dp)
                                 for t in (q, k, v, cos, sin))
        dev = qkv.device
        self.D = Dp
        self.plan = _deferred_plan(N, hq, hkv, Dp, B, _sm_count(dev.index),
                                   n_valid or N, False)
        _check_smem(self.plan, dev, "flash_out")
        self.wide = isinstance(self.plan, WidePlan)
        row = (q.stride(1), k.stride(1), v.stride(1), scale2)
        if self.wide:
            self.args = _wide_args(self.plan, *row)
            self.scratch = _rope_scratch(q, k, B, N, hq, hkv, Dp)
        else:
            self.args = _natural_args(self.plan, *row)
            self.grid = self.plan.launch_grid(B)
        self.keep = (q, k, v, cos, sin)

    def head(self):
        q, k, v, cos, sin = self.keep
        views = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ctypes.byref(self.args), cos.data_ptr(), sin.data_ptr()]
        if self.wide:
            views += [t.data_ptr() for t in self.scratch]
        return views


gqa_attention_flash_out.launches = 0
gqa_attention_flash_out.f32_launches = 0


@functools.cache
def _flash_out_lib():
    """csrc/flash_qkv.cu's library, its entry points' C types set
    (``flash_out_gemm``: the GEMM stage alone, for the card tests)."""
    from . import _build

    lib = _build.load("flash_qkv")
    lib.flash_out.restype = ctypes.c_int
    lib.flash_out.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(_NaturalArgs)]
        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.flash_out_gemm.restype = ctypes.c_int
    lib.flash_out_gemm.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p])
    # The split entry (ops/split.py).
    lib.flash_out_split1.restype = ctypes.c_int
    lib.flash_out_split1.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(_NaturalArgs)]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.flash_out_split2.restype = ctypes.c_int
    lib.flash_out_split2.argtypes = ([ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_out_split3.restype = ctypes.c_int
    lib.flash_out_split3.argtypes = ([ctypes.c_void_p] * 5
                                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


# ---- split q/k/v: B11 (flash), B15 (per q-head), B16 (per kv-head) ----------

def flash_split_plain(q, k, v, num_q_heads, num_kv_heads, scale_dim=None):
    """Plain PyTorch version of the split-input flash kernel, with its
    rounding points: zero rows pad N to a multiple of 8 and are NOT masked:
    they score 0 and take part in the row max m, and their share of the
    sum, ``npad * exp2(-m)``, is taken off the denominator (``scale_dim``:
    see :func:`_scores_plain`)."""
    B, N, _ = q.shape
    hq, hkv = num_q_heads, num_kv_heads
    D = q.shape[2] // hq
    dt = q.dtype
    npad = _round_up(N, 8) - N

    def heads(x, h):  # [B, N, h*D] -> [B, hq, Np, D], kv heads repeated
        x = F.pad(x, (0, 0, 0, npad)).reshape(B, N + npad, h, D)
        return x.transpose(1, 2).repeat_interleave(hq // h, dim=1)

    scale2 = (1.0 / math.sqrt(scale_dim or D)) * math.log2(math.e)
    s = ((heads(q, hq) * torch.tensor(scale2, dtype=dt)).float()
         @ heads(k, hkv).float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    if npad:
        denom = denom - npad * torch.exp2(-m)
    o = (e.to(dt).float() @ heads(v, hkv).float()) * (1.0 / denom)
    return o.to(dt).transpose(1, 2).reshape(B, N + npad, hq * D)[:, :N]


def gqa_attention_plain(q, k, v, scale_dim=None):
    """Plain PyTorch version of the per-q-head and the per-kv-head kernels
    (one function), with their rounding points: fp32 scores times
    ``1/sqrt(D)`` after the product, keys past N carry no weight (the
    kernels' padding to 128 adds only zeros), ``e = exp(s - m)``, the
    weights ``bf16(e / sum(e))`` before the value product (``scale_dim``:
    see :func:`_scores_plain`)."""
    B, N, hq, D = q.shape
    g = hq // k.shape[2]
    dt = q.dtype
    kh, vh = (x.transpose(1, 2).repeat_interleave(g, dim=1).float()
              for x in (k, v))
    s = (q.transpose(1, 2).float() @ kh.transpose(-1, -2)) * (
        1.0 / math.sqrt(scale_dim or D))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return (w.float() @ vh).to(dt).transpose(1, 2)


def gqa_attention_flash(q, k, v, num_q_heads: int, num_kv_heads: int):
    """Flash GQA on split, RoPE'd inputs in the projections' flat layout.

    Args:
        q: [B, N, Hq*D]; k/v: [B, N, Hkv*D] (heads in column blocks).
    Returns:
        [B, N, Hq*D] in q's dtype (bf16; fp32 in its fp32 mode, counted
        apart in ``f32_launches``).
    """
    hq, hkv = num_q_heads, num_kv_heads
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or q.shape[:2] != k.shape[:2] or hq % hkv or q.shape[2] % hq
            or k.shape[2] != hkv * (q.shape[2] // hq)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not {hq}/{hkv}-head GQA inputs")
    if q.device.type == "cpu":
        return flash_split_plain(q, k, v, hq, hkv)
    if _split_dtype(q, k, v) == torch.float32:
        out = _flash_split_f32(q, k, v, hq, hkv)
        gqa_attention_flash.f32_launches += 1
    else:
        out = _flash_deferred(q, k, v, hq, hkv, None)
    gqa_attention_flash.launches += 1
    return out


gqa_attention_flash.launches = 0
gqa_attention_flash.f32_launches = 0


def _check_heads(q, k, v):
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [B, N, H, D] GQA inputs")


def gqa_attention(q, k, v):
    """GQA, a program per (batch, q-head) on the TPU.

    Args:
        q: [B, N, Hq, D] (RoPE applied); k/v: [B, N, Hkv, D].
    Returns:
        [B, N, Hq, D] in q's dtype (bf16; fp32 in its fp32 mode, counted
        apart in ``f32_launches``).
    """
    _check_heads(q, k, v)
    if q.device.type == "cpu":
        return gqa_attention_plain(q, k, v)
    if _split_dtype(q, k, v) == torch.float32:
        out = _natural_f32(q, k, v, "gqa_attention(fp32)")
        gqa_attention.f32_launches += 1
    else:
        out = _launch_natural(q, k, v, grouped=False)
    gqa_attention.launches += 1
    return out


gqa_attention.launches = 0
gqa_attention.f32_launches = 0


def gqa_attention_grouped(q, k, v):
    """The same function as :func:`gqa_attention`, a program per (batch,
    kv-head) that runs its group's q-heads against K and V loaded once."""
    _check_heads(q, k, v)
    if q.device.type == "cpu":
        return gqa_attention_plain(q, k, v)
    if _split_dtype(q, k, v) == torch.float32:
        out = _natural_f32(q, k, v, "gqa_attention_grouped(fp32)")
        gqa_attention_grouped.f32_launches += 1
    else:
        out = _launch_natural(q, k, v, grouped=True)
    gqa_attention_grouped.launches += 1
    return out


gqa_attention_grouped.launches = 0
gqa_attention_grouped.f32_launches = 0


def _row_view(t):
    """``t`` [B, N, W] or [B, N, H, D] as the kernels read it: rows of dense
    heads at one row stride, which a column slice of the fused projection
    has, 16-byte aligned for the kernels' vector reads; any other layout is
    copied.  Returns the tensor and its row stride."""
    from . import _build

    dense = t.stride(-1) == 1 and (t.dim() == 3 or t.stride(2) == t.shape[3])
    if not (dense and t.stride(0) == t.shape[1] * t.stride(1)
            and t.data_ptr() % 16 == 0 and t.stride(1) % 8 == 0):
        t = _build.aligned(t)
    return t, t.stride(1)


def _split_dtype(q, k, v):
    """The one dtype of q, k and v, bf16 or fp32 (the fp32 modes), on one
    device; raises otherwise."""
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.bfloat16,
                                                             torch.float32):
        raise TypeError(f"the split attention kernels take bf16 or fp32 "
                        f"q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    return q.dtype


def _check_split(q, k, v, D):
    if _split_dtype(q, k, v) != torch.bfloat16:
        raise TypeError(f"the bf16 split attention kernels take bf16, got "
                        f"{q.dtype}")
    padded_head_dim(D)


def _check_smem(plan, device, what):
    limit = _smem_optin(device.index)
    if plan.smem > limit:
        raise ValueError(f"{what}: N={plan.N} needs {plan.smem} B of shared "
                         f"memory, the card gives {limit}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


# ---- B15 and B16: one kernel, two grids (csrc/attention_natural.cu) --------

NATURAL_MAX_N = 1024    # W <= 8 key chunks; B2's, B11's and B12's limit, too
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the attention kernels are built for
_NATURAL_CHUNK = 128    # keys a warp holds in registers (16 n-tiles)
_STREAM_WARPS = 8       # warps a CTA of the streaming mode: 255 registers a thread
_SMEM_SM90 = 232_448    # an sm_90 block's opt-in shared memory
WIDE_COLS = 128         # past 128 a head pads to a multiple: depth chunk, column group
_WIDE_ROWS = 64         # query rows a CTA of the wide forward (4 warps)
_WIDE_KEYS = 128        # keys a chunk of the wide forward


def _max_warps(d: int) -> int:
    """Warps a CTA of the attention body at head dim ``d``: 16 (128
    registers a thread), but 8 at 128, whose fp32 output tile alone is 64
    registers a thread."""
    return 8 if d == 128 else 16


def padded_head_dim(d: int) -> int:
    """The head dim of the kernel that runs head dim ``d``: the next of
    ``HEAD_DIMS`` up (``d`` itself where it is one); past 128 the next
    multiple of ``WIDE_COLS``, which ``csrc/attention_wide.cu`` runs (a
    head's fp32 output row would outgrow the attention body's registers).
    Raises ``TypeError`` below 1."""
    for dp in HEAD_DIMS:
        if 1 <= d <= dp:
            return dp
    if d > HEAD_DIMS[-1]:
        return _round_up(d, WIDE_COLS)
    raise TypeError(f"the attention kernels take head dims from 1, got {d}")


def pad_heads(x: torch.Tensor, d: int, dp: int) -> torch.Tensor:
    """``x [.., H * d]`` as ``[.., H * dp]``, each head's columns widened by
    zeros: an even ``d``'s halves at ``[0, d/2)`` and ``[dp/2, dp/2 +
    d/2)``, so that RoPE's half rotation (column i with i + dp/2) pairs the
    true columns; an odd ``d`` at ``[0, d)``.  A zero column adds exactly 0
    to every score and leaves its own output column 0."""
    if d == dp:
        return x
    *lead, w = x.shape
    h = w // d
    if d % 2:
        out = x.new_zeros((*lead, h, dp))
        out[..., :d] = x.reshape(*lead, h, d)
    else:
        out = x.new_zeros((*lead, h, 2, dp // 2))
        out[..., :d // 2] = x.reshape(*lead, h, 2, d // 2)
    return out.reshape(*lead, h * dp)


def unpad_heads(x: torch.Tensor, d: int, dp: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: ``[.., H * dp]`` -> ``[.., H * d]``."""
    if d == dp:
        return x
    *lead, w = x.shape
    h = w // dp
    if d % 2:
        return x.reshape(*lead, h, dp)[..., :d].reshape(*lead, h * d)
    return x.reshape(*lead, h, 2, dp // 2)[..., :d // 2].reshape(*lead,
                                                                  h * d)


def _row_bytes(d: int) -> int:
    """Shared-memory bytes of a ``d``-wide bf16 row plus its 8 pad."""
    return 2 * d + 16


@dataclasses.dataclass(frozen=True)
class NaturalPlan:
    """The launch of csrc/attention_natural.cu at one (N, heads, head dim
    D, batch).

    The keys are padded to ``nk``, ``W`` chunks of 128 (zero rows, masked).
    A round covers ``rows`` query rows of ``hc`` q-heads.  A CTA covers
    ``heads`` q-heads (1 for the per-q-head grid, G for the per-kv-head
    one) in ``head_rounds`` rounds and ``row_rounds`` row tiles in turn,
    over K and V loaded once where they are ``resident`` together.  Each of
    its ``warps`` warps owns 16 rows of one head over one key chunk: warp w
    takes chunk ``w % W`` of pair ``w // W``, which is row group ``pair %
    (rows // 16)`` of head slot ``pair // (rows // 16)``.  Round rd takes
    row tile ``x * row_rounds + rd // head_rounds`` and head slots ``(rd %
    head_rounds) * hc + [0, hc)``.  The grid is ``grid + (B,)``: x the tile
    group, y the q-head or the kv-head.  Offsets are bytes of dynamic
    shared memory: K and V (V at K's offset where they are not resident
    together), the q rows, the row statistics ``[2][pairs][W][16]`` fp32
    and the partial outputs ``[pairs][W][D / 8][32]`` fp32x4 (at K's offset
    where K is dead by then: one round, V resident).  Keys at or past
    ``limit`` are masked (N here; the deferred plan's own below), and
    ``npad`` zero keys below it have their share taken off the row sum.

    ``balanced`` (B10's forward): each (y, batch) takes all its tiles
    (``row_rounds``), and the ``total`` rounds of all of them, flattened
    (batch, y, round), are cut into spans of ``span``: CTA x of the 1-D
    grid takes rounds ``x * span ..`` and reloads K and V where the batch
    or y changes, so the card's SMs share the work evenly.  ``span`` 0:
    the grid's own (x, y, batch).

    ``stream`` (csrc/attention_stream.cuh): K and V pass through shared
    memory in 128-key chunks (two buffers each, at ``k_off`` and
    ``v_off``), so N has no cap; each warp owns 16 rows of one head over all
    ``nk`` keys (``W`` 1), three passes over K.  The CTA covers ``hc``
    heads of ``heads`` in ``head_rounds`` rounds times ``rows / 16`` row
    groups, one tile (``row_rounds`` 1); the warps' q rows at ``q_off``;
    no statistics or partial outputs (``red_off`` = ``part_off`` = the
    end).  ``N``-wide grids as the other modes'."""

    N: int
    nk: int
    hq: int
    hkv: int
    rows: int
    W: int
    heads: int
    hc: int
    head_rounds: int
    row_rounds: int
    resident: int
    k_off: int
    v_off: int
    q_off: int
    red_off: int
    part_off: int
    span: int
    total: int
    limit: int
    npad: int
    grid: tuple
    warps: int
    smem: int
    stream: int = 0

    def launch_grid(self, B: int) -> tuple:
        """The 3-D launch grid at batch B: ``grid + (B,)``, or the balanced
        grid's ``grid + (1,)`` (its spans already run over the batch)."""
        return (*self.grid, 1 if self.span else B)


@functools.cache
def _natural_plan(N: int, hq: int, hkv: int, D: int, grouped: bool, B: int,
                  sms: int, balanced: bool = False) -> NaturalPlan:
    """The launch plan of B15 (``grouped=False``) or B16 at N keys, head
    dim D, batch B, on a card of ``sms`` SMs.

    Each (q-head or kv-head, batch) gets as many CTAs as fill the SMs once,
    and each CTA takes its share of the row tiles in turn where K and V
    stay resident: they are then read from L2 once a CTA, not once a tile
    (at the serving shape that traffic bounded the kernels).

    Past 768 keys at D = 64 (W = 7 or 8 chunks) K and V no longer fit
    together: V then takes K's buffer once the scores are done, and K is
    loaded again each round.  Past ``NATURAL_MAX_N`` keys, and at D = 128
    where K and the partial outputs outgrow shared memory (past 640), the
    plan is the
    streaming mode's (:func:`_stream_plan`, its own grid whatever
    ``balanced`` asks; B10's forward has no streaming mode, and
    ``attention_train._train_plan`` raises there).

    A head dim that is not one of ``HEAD_DIMS`` runs on the next one up,
    zero-padded (:func:`pad_heads`): the plan is that instance's; past 128
    it is :func:`_wide_plan`'s (both grids, and ``balanced``, are then
    one).  Raises ``ValueError`` for N < 1."""
    if N < 1:
        raise ValueError(f"gqa_attention kernels: N={N} < 1")
    if hq % hkv:
        raise ValueError(f"{hq} q-heads do not group over {hkv} kv-heads")
    D = padded_head_dim(D)
    if D > HEAD_DIMS[-1]:
        return _wide_plan(N, hq, hkv, D)
    plan = (_rows_plan(N, hq, hkv, D, grouped, B, sms, balanced)
            if N <= NATURAL_MAX_N else None)
    if plan is not None and plan.smem <= _SMEM_SM90:
        return plan
    return _stream_plan(N, hq, hkv, D, grouped)


def _rows_plan(N, hq, hkv, D, grouped, B, sms, balanced):
    """The resident or non-resident plan (K whole in shared memory)."""
    g = hq // hkv
    nk = _round_up(N, _NATURAL_CHUNK)
    W = nk // _NATURAL_CHUNK
    fit = _max_warps(D) // W             # (row group, head) pairs a CTA holds
    if grouped:
        head_rounds = -(-g // fit)
        hc = -(-g // head_rounds)
        pairs, rows, heads, ny = hc, 16, g, hkv
    else:
        head_rounds, hc = 1, 1
        pairs = min(4, fit)
        rows, heads, ny = 16 * pairs, 1, hq
    kv = nk * _row_bytes(D)
    q_bytes = pairs * 16 * _row_bytes(D)
    red = 2 * pairs * W * 16 * 4
    part = pairs * W * (D // 8) * 32 * 16 if W > 1 else 0
    tiles = -(-N // rows)
    row_rounds = 1                       # where K and V cannot stay resident
    if balanced:
        row_rounds = tiles
    elif 2 * kv + q_bytes + red + part <= _SMEM_SM90:
        row_rounds = -(-tiles // min(tiles, max(1, sms // (ny * B))))
    rounds = head_rounds * row_rounds
    alias = rounds == 1 and part <= kv and not balanced
    resident = 2 * kv + q_bytes + red + (0 if alias else part) <= _SMEM_SM90
    alias = alias and resident
    q_off = (2 if resident else 1) * kv
    red_off = _round_up(q_off + q_bytes, 128)
    end = _round_up(red_off + red, 128)
    part_off = 0 if alias else end
    smem = end if alias else end + part
    span = total = 0
    grid = (-(-tiles // row_rounds), ny)
    if balanced:
        total = B * ny * rounds
        span = -(-total // sms)
        grid = (-(-total // span), 1)
    return NaturalPlan(N, nk, hq, hkv, rows, W, heads, hc, head_rounds,
                       row_rounds, int(resident), 0, kv if resident else 0,
                       q_off, red_off, part_off, span, total, N, 0, grid,
                       pairs * W, smem)


def _stream_plan(N, hq, hkv, D, grouped):
    """The streaming mode's plan (see :class:`NaturalPlan`): 8 warps a CTA;
    B15 a CTA per (q-head, batch, 128-row tile), B16 a CTA per (kv-head,
    batch, tile) with its G q-heads side by side (in rounds of 8 where G
    is larger), over K and V loaded once a pass."""
    g = hq // hkv
    if grouped:
        head_rounds = -(-g // _STREAM_WARPS)
        hc = -(-g // head_rounds)
        heads, ny = g, hkv
    else:
        head_rounds, hc, heads, ny = 1, 1, 1, hq
    R = _STREAM_WARPS // hc
    chunk = _NATURAL_CHUNK * _row_bytes(D)
    q_off = 4 * chunk
    smem = q_off + hc * R * 16 * _row_bytes(D)
    rows = 16 * R
    return NaturalPlan(N, _round_up(N, _NATURAL_CHUNK), hq, hkv, rows, 1,
                       heads, hc, head_rounds, 1, 0, 0, 2 * chunk, q_off,
                       smem, smem, 0, 0, N, 0, (-(-N // rows), ny), hc * R,
                       smem, 1)


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """The launch of csrc/attention_wide.cu's forward at a head dim ``dp``
    past 128, a multiple of ``WIDE_COLS``: a CTA of ``warps`` warps covers
    ``rows`` query rows of one q-head (warp w rows ``16 w ..``) and one of
    the ``groups`` = dp / 128 output column groups; the grid is ``grid +
    (B,)`` = (row tiles, hq * groups, B), y = q-head * groups + group.  The
    keys pass in chunks of 128 (``nk`` in all), each chunk's scores summed
    over the ``groups`` depth chunks of 128 in order.  ``smem``: the q rows'
    and K's depth chunk, V's group chunk ([64 + 2 * 128] rows of 136 bf16).
    Keys at or past ``limit`` are masked, and ``npad`` zero keys below it
    have their share taken off the row sum (B11), as in
    :class:`NaturalPlan`."""

    N: int
    nk: int
    hq: int
    hkv: int
    dp: int
    groups: int
    rows: int
    grid: tuple
    warps: int
    smem: int
    limit: int
    npad: int = 0


@functools.cache
def _wide_plan(N: int, hq: int, hkv: int, dp: int) -> WidePlan:
    """The wide forward's plan (see :class:`WidePlan`), any N."""
    groups = dp // WIDE_COLS
    smem = (_WIDE_ROWS + 2 * _WIDE_KEYS) * _row_bytes(WIDE_COLS)
    return WidePlan(N, _round_up(N, _WIDE_KEYS), hq, hkv, dp, groups,
                    _WIDE_ROWS, (-(-N // _WIDE_ROWS), hq * groups), 4, smem,
                    N)


class _WideArgs(ctypes.Structure):
    """``WidePlan`` of csrc/attention_wide.cu, field for field."""

    _fields_ = ([(f, ctypes.c_int) for f in ("N", "hq", "hkv", "dp",
                                              "groups")]
                + [(f, ctypes.c_longlong) for f in ("q_row", "k_row",
                                                    "v_row")]
                + [("scale", ctypes.c_float)]
                + [(f, ctypes.c_int) for f in ("limit", "npad",
                                               "prescaled")])


def _wide_args(plan: WidePlan, q_row: int, k_row: int, v_row: int,
               scale: float) -> _WideArgs:
    return _WideArgs(plan.N, plan.hq, plan.hkv, plan.dp, plan.groups, q_row,
                     k_row, v_row, scale, plan.limit, plan.npad, 0)


@functools.cache
def _wide_lib():
    """csrc/attention_wide.cu's library, its serving entries' C types set."""
    from . import _build

    lib = _build.load("attention_wide")
    lib.attention_wide.restype = ctypes.c_int
    lib.attention_wide.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_WideArgs)]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.attention_wide_s8v.restype = ctypes.c_int
    lib.attention_wide_s8v.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_WideArgs)]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_out_wide.restype = ctypes.c_int
    lib.flash_out_wide.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(_WideArgs)]
        + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_out_wide_split1.restype = ctypes.c_int
    lib.flash_out_wide_split1.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(_WideArgs)]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _rope_scratch(q, k, B, N, hq, hkv, dp):
    """The rope pass's outputs: q' [B, N, hq, dp] and K' [B, N, hkv, dp]."""
    return (torch.empty((B, N, hq, dp), dtype=torch.bfloat16, device=q.device),
            torch.empty((B, N, hkv, dp), dtype=torch.bfloat16,
                        device=k.device))


class _NaturalArgs(ctypes.Structure):
    """``NaturalPlan`` of csrc/attention_rows.cuh, field for field."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "N", "nk", "hq", "hkv", "rows", "W", "heads", "hc", "head_rounds",
        "row_rounds", "resident", "k_off", "v_off", "q_off", "red_off",
        "part_off", "span", "total")]
        + [(f, ctypes.c_longlong) for f in ("q_row", "k_row", "v_row")]
        + [("scale", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in ("limit", "npad", "stream")])


def _natural_args(plan: NaturalPlan, q_row: int, k_row: int, v_row: int,
                  scale: float) -> _NaturalArgs:
    """The C struct of ``plan`` with the views' row strides and q's
    factor."""
    return _NaturalArgs(
        *(getattr(plan, f) for f, _ in _NaturalArgs._fields_[:18]),
        q_row, k_row, v_row, scale, plan.limit, plan.npad, plan.stream)


@functools.cache
def _natural_lib():
    """csrc/attention_natural.cu's library, its entry points' C types set."""
    from . import _build

    lib = _build.load("attention_natural")
    lib.attention_natural.restype = ctypes.c_int
    lib.attention_natural.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_NaturalArgs)]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.attention_natural_divide.restype = ctypes.c_int
    lib.attention_natural_divide.argtypes = ([ctypes.c_void_p] * 4
                                             + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _launch_natural(q, k, v, grouped):
    """One launch of csrc/attention_natural.cu on [B, N, H, D] q, k, v."""
    from . import _build

    B, N, hq, D = q.shape
    _check_split(q, k, v, D)
    scale = 1.0 / math.sqrt(D)
    Dp = padded_head_dim(D)
    if Dp != D:  # zero head columns: the same scores and outputs
        q, k, v = (pad_heads(x.reshape(B, N, -1), D, Dp).reshape(B, N, -1, Dp)
                   for x in (q, k, v))
    plan = _natural_plan(N, hq, k.shape[2], Dp, grouped, B,
                         _sm_count(q.device.index))
    _check_smem(plan, q.device, "gqa_attention kernels")
    (q, q_row), (k, k_row), (v, v_row) = map(_row_view, (q, k, v))
    if isinstance(plan, WidePlan):  # both grids: the same launch
        out = _launch_wide(plan, q, k, v, q_row, k_row, v_row, scale, 0)
        return unpad_heads(out.reshape(B, N, -1), D, Dp).reshape(B, N, hq, D)
    lib = _natural_lib()
    args = _natural_args(plan, q_row, k_row, v_row, scale)
    out = torch.empty((B, N, hq, Dp), dtype=torch.bfloat16, device=q.device)
    gx, gy, gz = plan.launch_grid(B)
    err = lib.attention_natural(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.byref(args), Dp, gz, gx, gy, plan.warps, plan.smem,
        _build.stream_ptr(q.device))
    _build.check(lib, err, "gqa_attention_grouped" if grouped
                 else "gqa_attention")
    if Dp != D:
        out = unpad_heads(out.reshape(B, N, -1), D, Dp).reshape(B, N, hq, D)
    return out


def _launch_wide(plan, q, k, v, q_row, k_row, v_row, scale, kind, cos=None,
                 sin=None, sv=None):
    """One call of csrc/attention_wide.cu's ``attention_wide`` (kind 0
    natural, 1 deferred; with ``cos``/``sin`` the rope pass first) on row
    views q, k, v: ``[B, N, hq * dp]`` bf16.  With ``sv`` (B2's int8 value
    product) ``v`` is V's codes (:func:`_v_codes`) and the call is
    ``attention_wide_s8v``."""
    from . import _build

    B, N = q.shape[:2]
    hq, hkv, dp = plan.hq, plan.hkv, plan.dp
    args = _wide_args(plan, q_row, k_row, v_row, scale)
    out = torch.empty((B, N, hq * dp), dtype=torch.bfloat16, device=q.device)
    qr = kr = None
    if cos is not None:
        qr, kr = _rope_scratch(q, k, B, N, hq, hkv, dp)
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = _wide_lib()
    if sv is not None:
        err = lib.attention_wide_s8v(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), ctypes.byref(args),
                                     cos.data_ptr(), sin.data_ptr(),
                                     qr.data_ptr(), kr.data_ptr(),
                                     sv.data_ptr(), B,
                                     _build.stream_ptr(q.device))
        _build.check(lib, err, "attention_wide_s8v")
        return out
    err = lib.attention_wide(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), ctypes.byref(args), ptr(cos),
                             ptr(sin), ptr(qr), ptr(kr), kind, B,
                             _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_wide")
    return out


def natural_divide(e, l):
    """The B15/B16 kernel's divide and ``__fdiv_rn`` of fp32 CUDA tensors
    ``e`` and ``l``, elementwise: ``(kernel, reference)``."""
    from . import _build

    e, l = (t.float().contiguous() for t in (e, l))
    fast, ref = torch.empty_like(e), torch.empty_like(e)
    lib = _natural_lib()
    err = lib.attention_natural_divide(e.data_ptr(), l.data_ptr(),
                                       fast.data_ptr(), ref.data_ptr(),
                                       e.numel(), _build.stream_ptr(e.device))
    _build.check(lib, err, "attention_natural_divide")
    return fast, ref


# ---- B2 and B11: the deferred epilogue (csrc/attention_deferred.cu) -------

@functools.cache
def _deferred_plan(N: int, hq: int, hkv: int, D: int, B: int, sms: int,
                   n_valid: int | None, balanced: bool) -> NaturalPlan:
    """The launch plan of B2 and B12 (``n_valid``: keys at or past it are
    masked) or B11 (``n_valid`` None: N is padded with zero keys to a
    multiple of 8, which take part in the row max, and their share comes
    off the row sum): B16's per-kv-head layout, the G q-heads side by side
    over K and V loaded once, on its own grid or the balanced one (at D =
    128 past 640 keys, the streaming mode's plan, whose grid is its own;
    past head dim 128 the wide plan, :func:`_wide_plan`).  Raises
    ``ValueError`` outside [1, ``NATURAL_MAX_N``]: JAX's
    ``flash_supported`` stops these branches below it."""
    if N > NATURAL_MAX_N:
        raise ValueError(f"flash kernels: N={N} outside [1, "
                         f"{NATURAL_MAX_N}]")
    plan = _natural_plan(N, hq, hkv, D, True, B, sms, balanced=balanced)
    if n_valid is None:
        limit = _round_up(N, 8)
        return dataclasses.replace(plan, limit=limit, npad=limit - N)
    if not 1 <= n_valid <= N:
        raise ValueError(f"n_valid {n_valid} outside [1, {N}]")
    return dataclasses.replace(plan, limit=n_valid)


@functools.cache
def _deferred_lib():
    """csrc/attention_deferred.cu's library, its entry point's C types set."""
    from . import _build

    lib = _build.load("attention_deferred")
    lib.attention_deferred.restype = ctypes.c_int
    lib.attention_deferred.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_NaturalArgs)]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.attention_deferred_s8v.restype = ctypes.c_int
    lib.attention_deferred_s8v.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_NaturalArgs)]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.attention_v_codes.restype = ctypes.c_int
    lib.attention_v_codes.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _v_codes(v, v_row, hkv, D, nk):
    """V's codes and scales for B2's int8 value product, one launch of
    csrc/attention_deferred.cu's ``v_codes_kernel`` on the row view ``v``
    ``[B, N, hkv * D]`` bf16 or fp32 (row stride ``v_row``): codes ``[B,
    hkv, D, nk]``
    int8 (K-major, each 32-key block in ``kperm`` order, zero past N) and
    ``sv [B, hkv, D]`` fp32, ``max(absmax * _INV127, 1e-12)`` over all N
    rows."""
    from . import _build

    B, N = v.shape[:2]
    codes = torch.empty((B, hkv, D, nk), dtype=torch.int8, device=v.device)
    sv = torch.empty((B, hkv, D), dtype=torch.float32, device=v.device)
    lib = _deferred_lib()
    err = lib.attention_v_codes(v.data_ptr(), v_row, B, N, hkv, D, nk,
                                codes.data_ptr(), sv.data_ptr(),
                                int(v.dtype == torch.float32),
                                _build.stream_ptr(v.device))
    _build.check(lib, err, "attention_v_codes")
    _v_codes.launches += 1
    return codes, sv


_v_codes.launches = 0


def kperm(p: int) -> int:
    """The key that position ``p`` of a 32-key block of V's codes holds
    (``csrc/attention_rows.cuh:kperm``: the order in which the s8 product's
    A fragments take a thread's weights)."""
    return (p & 16) | ((p & 2) << 2) | (((p >> 2) & 3) << 1) | (p & 1)


def v_codes_plain(v, hkv, nk):
    """Plain version of ``v_codes_kernel`` on ``v [B, N, hkv * D]``: the
    codes ``[B, hkv, D, nk]`` int8 in its layout and ``sv [B, hkv, D]``."""
    B, N, w = v.shape
    D = w // hkv
    vf = v.float().reshape(B, N, hkv, D).permute(0, 2, 3, 1)  # [B, hkv, D, N]
    sv = (vf.abs().amax(dim=-1) * _INV127).clamp_min(1e-12)
    q = torch.round(vf / sv[..., None]).to(torch.int8)
    q = F.pad(q, (0, nk - N))
    perm = torch.tensor([b * 32 + kperm(p) for b in range(nk // 32)
                         for p in range(32)], device=v.device)
    return q[..., perm].contiguous(), sv


def _flash_deferred(q, k, v, hq, hkv, n_valid, cos=None, sin=None,
                    balanced=None, int8_v=False):
    """One launch of csrc/attention_deferred.cu on [B, N, H * D] views q,
    k and v: B2 with ``n_valid`` and the fp32 RoPE tables ``cos``, ``sin``
    ([N, D], 8-byte aligned), B11 with ``n_valid`` None and no tables.
    ``int8_v`` (B2's ``int8_qk``): V's codes and scales first, one launch
    of :func:`_v_codes`, then B2 on them.
    ``balanced`` None takes the grid that was faster at the serving shapes
    (PERF.md §6): B2 B16's per-kv-head grid (120 CTAs of 5
    rounds), where each CTA loads and rotates K once; B11 the balanced one
    (132 CTAs of 4 rounds), whose K and V reloads where a span crosses a
    (batch, kv-head) cost no rotation.  True or False forces a grid, for
    the test that holds the two grids bit-equal and for
    tools/torch_deferred_grids.py, which times both."""
    from . import _build

    B, N = q.shape[:2]
    D = q.shape[2] // hq
    _check_split(q, k, v, D)
    if balanced is None:
        balanced = cos is None
    scale2 = _scale2_bf16(D)
    Dp = padded_head_dim(D)
    if Dp != D:  # zero head columns, RoPE's halves kept apart (pad_heads)
        q, k, v = (pad_heads(x, D, Dp) for x in (q, k, v))
        if cos is not None:
            cos, sin = (pad_heads(t, D, Dp) for t in (cos, sin))
    plan = _deferred_plan(N, hq, hkv, Dp, B, _sm_count(q.device.index),
                          n_valid, balanced)
    _check_smem(plan, q.device, "flash kernels")
    (q, q_row), (k, k_row), (v, v_row) = map(_row_view, (q, k, v))
    sv = None
    if int8_v:
        if cos is None:
            raise ValueError("the int8 value product is B2's (RoPE tables)")
        v, sv = _v_codes(v, v_row, hkv, Dp, plan.nk)
    if isinstance(plan, WidePlan):  # one grid
        out = _launch_wide(plan, q, k, v, q_row, k_row, v_row, scale2, 1,
                           cos, sin, sv)
        return unpad_heads(out, D, Dp)
    args = _natural_args(plan, q_row, k_row, v_row, scale2)
    out = torch.empty((B, N, hq * Dp), dtype=torch.bfloat16, device=q.device)
    lib = _deferred_lib()
    gx, gy, gz = plan.launch_grid(B)
    if sv is not None:
        err = lib.attention_deferred_s8v(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.byref(args), cos.data_ptr(), sin.data_ptr(),
            sv.data_ptr(), Dp, gz, gx, gy, plan.warps, plan.smem,
            _build.stream_ptr(q.device))
        _build.check(lib, err, "gqa_attention_flash_qkv(int8_qk)")
        return unpad_heads(out, D, Dp)
    err = lib.attention_deferred(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.byref(args), None if cos is None else cos.data_ptr(),
        None if sin is None else sin.data_ptr(), Dp, gz, gx, gy, plan.warps,
        plan.smem, _build.stream_ptr(q.device))
    _build.check(lib, err, "gqa_attention_flash" if cos is None
                 else "gqa_attention_flash_qkv")
    return unpad_heads(out, D, Dp)
