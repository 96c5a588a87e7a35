"""The split entries of the s8 kernels for tensor parallelism.

A model group of M ranks (``parallel.distributed.ModelGroup``) holds 1/M of
each block projection.  These wrappers compute a rank's share of the
whole-width function on the card and meet the other ranks in the group's
collectives, so that each rank ends with the one-card result bit for bit:

- column-parallel mlp_in (B1 behind the fused prologue, B5 behind the
  unfused one): the rank's columns of the GELU output; its row scale is
  taken over the whole MLP width, the ranks' row maxima joined by
  ``group.max_`` between the kernel's two passes;
- row-parallel out_proj (B4; ``ops/quant.py:w8a8_dot`` takes it for
  ``impl="fused"``): the rank's columns of the input (its heads) against
  its rows of the kernel; the row scale over the whole row (``group.max_``
  of the ranks' maxima), the int32 partial products added by
  ``group.sum_`` before the one dequant.

A CPU tensor takes the whole kernel's plain version with the group's hook
(``group=``: the row maxima and int32 sums over the group), a CUDA tensor
the kernels of ``csrc/s8_split.cuh`` behind the C entries of
``csrc/norm_mod.cu`` (B1), ``csrc/dense_gelu_quant.cu`` (B5) and
``csrc/w8a8_fused.cu`` (B4), or it raises.  ``launches`` counts each
wrapper's kernel calls (one a call).
"""

from __future__ import annotations

import ctypes

import torch

from .int8_matmul import (GELU_IMPLS, check_t, check_weights,
                          dense_gelu_quant_plain, group_max, group_sum,
                          matmul_fused_plain)
from .prologue import _check as _prologue_check
from .prologue import _shared_args, norm_mod_dense_gelu_quant_plain

_TILE = 128


# ---- the wrappers ----------------------------------------------------------

def int8_norm_mod_dense_gelu_quant_split(x, scale, shift, w_q, w_scale, bias,
                                         group, *, norm="rms",
                                         gelu_impl="tanh", w_t=None):
    """B1 on a rank's columns of mlp_in: ``w_q [H, N]`` (and ``w_t [N,
    H]``, ``w_scale``, ``bias``) are its N columns; ``x [B, Np, H]`` bf16,
    the whole (replicated) residual stream.  Returns ``(int8 [B, Np, N],
    fp32 [B, Np, 1])``: the rank's columns of the one-card codes, and the
    one-card row scales.  ``group``: the model group (None: one rank)."""
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl {gelu_impl!r} not in {GELU_IMPLS}")
    B, Np, H, N = _prologue_check("norm_mod_gelu_split", x, scale, shift, w_q,
                                  w_scale, bias, norm, w_t)
    if x.device.type == "cpu":
        return norm_mod_dense_gelu_quant_plain(
            x, scale, shift, w_q, w_scale, bias, norm, gelu_impl, group)
    from . import _build

    if x.dtype != torch.bfloat16:
        raise TypeError(f"norm_mod_gelu_split takes bf16 x, got {x.dtype}")
    lib, head, keep = _shared_args("norm_mod_gelu_split", x, scale, shift,
                                   w_t, w_scale, bias)
    M, dev = B * Np, x.device
    part = torch.empty((M, N // _TILE), dtype=torch.float32, device=dev)
    rm = torch.empty((M,), dtype=torch.float32, device=dev)
    fn = lib.norm_mod_gelu_split1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
        ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    st = _build.stream_ptr(dev)
    err = fn(*head, part.data_ptr(), rm.data_ptr(), M, Np, H, N,
             int(norm == "rms"), GELU_IMPLS.index(gelu_impl), st)
    _build.check(lib, err, "norm_mod_gelu_split1")
    group_max(group, rm)
    g_q = torch.empty((B, Np, N), dtype=torch.int8, device=dev)
    g_s = torch.empty((B, Np, 1), dtype=torch.float32, device=dev)
    _, _, _, w_t, ws, b, a_q, s = keep
    fn = lib.norm_mod_gelu_split2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    err = fn(a_q.data_ptr(), s.data_ptr(), w_t.data_ptr(), ws.data_ptr(),
             b.data_ptr(), part.data_ptr(), rm.data_ptr(), g_q.data_ptr(),
             g_s.data_ptr(), M, H, N,
             GELU_IMPLS.index(gelu_impl), st)
    _build.check(lib, err, "norm_mod_gelu_split2")
    int8_norm_mod_dense_gelu_quant_split.launches += 1
    return g_q, g_s


int8_norm_mod_dense_gelu_quant_split.launches = 0


def int8_dense_gelu_quant_split(a, w_q, w_scale, bias, group, *,
                                gelu_impl="tanh", fast_epilogue=True,
                                w_t=None):
    """B5 on a rank's columns of mlp_in: ``a [M, K]`` bf16, the whole
    (replicated) row; ``w_q [K, N]`` (``w_t [N, K]``) its N columns.
    Returns ``(int8 [M, N], fp32 [M, 1])`` as :func:`int8_norm_mod_dense_
    gelu_quant_split` does."""
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl {gelu_impl!r} not in {GELU_IMPLS}")
    M = a.shape[0]
    K, N = check_weights("dense_gelu_quant_split", a.shape[1], w_q, w_scale,
                         bias)
    check_t("dense_gelu_quant_split", w_q, w_t)
    if a.device.type == "cpu":
        return dense_gelu_quant_plain(a, w_q, w_scale, bias, gelu_impl,
                                      fast_epilogue, group)
    from . import _build

    if a.dtype != torch.bfloat16:
        raise TypeError(f"dense_gelu_quant_split takes bf16 a, got {a.dtype}")
    if w_t is None or K % _TILE:
        raise ValueError("dense_gelu_quant_split: the card's kernel reads the "
                         "weight K-major (w_t) and K in stages of 128")
    lib = _build.load("dense_gelu_quant")
    dev, st = a.device, _build.stream_ptr(a.device)
    a = _build.aligned(a)
    w_t = _build.aligned(w_t)
    ws = w_scale.reshape(N).float().contiguous()
    b = bias.reshape(N).float().contiguous()
    a_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    part = torch.empty((M, N // _TILE), dtype=torch.float32, device=dev)
    rm = torch.empty((M,), dtype=torch.float32, device=dev)
    fn = lib.dgq_split1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fast = int(bool(fast_epilogue))
    gi = GELU_IMPLS.index(gelu_impl)
    err = fn(a.data_ptr(), w_t.data_ptr(), ws.data_ptr(), b.data_ptr(),
             a_q.data_ptr(), s.data_ptr(), part.data_ptr(), rm.data_ptr(),
             M, K, N, gi, fast, st)
    _build.check(lib, err, "dgq_split1")
    group_max(group, rm)
    g_q = torch.empty((M, N), dtype=torch.int8, device=dev)
    g_s = torch.empty((M, 1), dtype=torch.float32, device=dev)
    fn = lib.dgq_split2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = fn(a_q.data_ptr(), s.data_ptr(), w_t.data_ptr(), ws.data_ptr(),
             b.data_ptr(), part.data_ptr(), rm.data_ptr(), g_q.data_ptr(),
             g_s.data_ptr(), M, K, N, gi, fast, st)
    _build.check(lib, err, "dgq_split2")
    int8_dense_gelu_quant_split.launches += 1
    return g_q, g_s


int8_dense_gelu_quant_split.launches = 0


def int8_matmul_fused_split(a, w_q, w_scale, group, *,
                            out_dtype=torch.bfloat16, w_t=None,
                            parts=None):
    """B4 row-parallel: ``a [M, K]`` bf16, the rank's columns of the input
    row (its heads), ``w_q [K, N]`` (``w_t [N, K]``) its rows of the
    kernel, ``w_scale [1, N]`` whole.  Returns the one-card ``[M, N]``
    product in ``out_dtype`` (bf16 or fp32).  ``parts``: on the card, a
    dict that receives the launches' intermediates (``amax``, ``a_q``,
    ``s``, ``acc_local`` before the sum) for the card checks."""
    M = a.shape[0]
    K, N = check_weights("matmul_fused_split", a.shape[1], w_q, w_scale)
    check_t("matmul_fused_split", w_q, w_t)
    if a.device.type == "cpu":
        return matmul_fused_plain(a, w_q, w_scale, out_dtype, group)
    from . import _build

    if a.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16,
                                                      torch.float32):
        raise TypeError(f"matmul_fused_split takes bf16 a and writes bf16 or "
                        f"fp32, got {a.dtype}, {out_dtype}")
    if w_t is None or K % 16:
        raise ValueError("matmul_fused_split: the card's kernel reads the "
                         "weight K-major (w_t), K % 16 == 0")
    lib = _build.load("w8a8_fused")
    dev, st = a.device, _build.stream_ptr(a.device)
    a = _build.aligned(a)
    w_t = _build.aligned(w_t)
    ws = w_scale.reshape(N).float().contiguous()
    amax = torch.empty((M,), dtype=torch.float32, device=dev)
    fn = lib.w8a8_split1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    _build.check(lib, fn(a.data_ptr(), amax.data_ptr(), M, K, st),
                 "w8a8_split1")
    group_max(group, amax)
    a_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    acc = torch.empty((M, N), dtype=torch.int32, device=dev)
    fn = lib.w8a8_split2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    _build.check(lib, fn(a.data_ptr(), amax.data_ptr(), w_t.data_ptr(),
                         a_q.data_ptr(), s.data_ptr(), acc.data_ptr(), M, K,
                         N, st), "w8a8_split2")
    if parts is not None:
        parts.update(amax=amax, a_q=a_q, s=s.reshape(M, 1),
                     acc_local=acc.clone())
    group_sum(group, acc)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    fn = lib.w8a8_split3
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    _build.check(lib, fn(acc.data_ptr(), s.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), M, N,
                         int(out_dtype == torch.float32), st), "w8a8_split3")
    int8_matmul_fused_split.launches += 1
    return out


int8_matmul_fused_split.launches = 0
