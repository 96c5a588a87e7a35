"""W8A8 serving products: dense + GELU + requantize, the fused W8A8 dot, the
s8 product on a pre-quantised A, and the whole MLP.

Ports of ``int8_dense_gelu_quant``, ``int8_matmul_fused``, ``int8_matmul``
and ``int8_mlp`` (JAX package, ``ops/int8_matmul.py``).  Each wrapper
dispatches on the tensor's device: a CPU tensor takes the plain PyTorch
version below, a CUDA tensor launches the hand-written kernel in
``csrc/dense_gelu_quant.cu``, ``csrc/w8a8_fused.cu`` (the fused dot and
the product on a pre-quantised A) or ``csrc/mlp_full.cu``, or raises.
Nothing falls back.  All run on the s8 ``wgmma`` core of
``csrc/s8_wgmma.cuh``, which reads 8-bit operands K-major only: their
wrappers take the weights a second time, transposed (``w_t``, made once by
the caller), and raise on the card without it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

# Multiply by the f32 reciprocal of 127 (never divide by 127): the JAX
# package's quantisers all scale this way, so the scales are bit-identical.
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def group_max(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` (row maxima) maxed over a tensor-parallel model group
    (``parallel.distributed.ModelGroup``, in place), or ``t`` itself where
    ``group`` is None: the plain versions' hook for a rank's share."""
    return t if group is None else group.max_(t)


def group_sum(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` (int32 partial products) summed over a model group, or ``t``
    itself where ``group`` is None."""
    return t if group is None else group.sum_(t)

GELU_IMPLS = ("tanh", "erf", "sigmoid")


def quantize_rows(x: torch.Tensor, eps: float = 1e-12, group=None):
    """Symmetric per-row absmax int8 quantisation of ``x [M, K]``.

    Returns ``(x_q int8 [M, K], scale fp32 [M, 1])``; the scale is the
    unfloored ``max|x| * _INV127``, the divide uses the floored one.
    ``group``: the model group whose ranks hold the row's other columns
    (the max taken over the whole row).
    """
    xf = x.float()
    scale = group_max(group, xf.abs().amax(dim=-1, keepdim=True)) * _INV127
    x_q = torch.round(xf / scale.clamp_min(eps)).to(torch.int8)
    return x_q, scale


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26 (max abs error 1.5e-7), the form
    the TPU kernel uses."""
    sign = torch.sign(x)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def _gelu(y: torch.Tensor, impl: str = "tanh") -> torch.Tensor:
    """In-kernel GELU forms (``ModelConfig.gelu_impl``), fp32."""
    if impl == "erf":
        return 0.5 * y * (1.0 + _erf(y * (1.0 / math.sqrt(2.0))))
    if impl == "sigmoid":
        return y * torch.sigmoid(1.702 * y)
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))


def int8_mm(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact ``int8 [M, K] @ int8 [K, N] -> int32 [M, N]``.

    A plain product outside any kernel (the JAX package leaves it to XLA),
    so it goes to ``torch._int_mm``, which accumulates in int32 on both the
    CPU and the card.  That op wants more than 16 rows: M is padded.
    """
    M = a_q.shape[0]
    if M <= 16:
        a_q = torch.cat([a_q, a_q.new_zeros(17 - M, a_q.shape[1])])
    return torch._int_mm(a_q.contiguous(), w_q.contiguous())[:M]


def dense_gelu_quant_plain(a, w_q, w_scale, bias, gelu_impl="tanh",
                           fast_epilogue=True, group=None):
    """Plain PyTorch version of the kernel, with its rounding points.
    ``group``: the model group whose ranks hold the other columns of
    ``w_q`` (the GELU row's scale taken over the whole row)."""
    a_q, s = quantize_rows(a)
    s = s.clamp_min(1e-12)
    acc = int8_mm(a_q, w_q).float()
    y = acc * s * w_scale.reshape(1, -1) + bias.reshape(1, -1).float()
    if not fast_epilogue:
        y = y.bfloat16().float()
        g = _gelu(y, gelu_impl).bfloat16().float()
    else:
        g = _gelu(y, gelu_impl)
    gs = (group_max(group, g.abs().amax(dim=1, keepdim=True)) * _INV127
          ).clamp_min(1e-12)
    return torch.round(g / gs).to(torch.int8), gs


def check_weights(what, K, w_q, w_scale, bias=None, k_run=None, k_mult=64):
    """``(K, N)`` of an int8 ``[K, N]`` kernel the GEMM of the CUDA kernels
    takes (K % ``k_mult`` == 0, N % 128 == 0; ``k_run``, where given, is the
    contraction the GEMM runs, K widened by zero rows, and K % ``k_mult``
    applies to it), with its ``[1, N]`` scale and optional bias; raises
    ``ValueError`` otherwise."""
    K2, N = w_q.shape
    if K != K2 or (k_run or K) % k_mult or N % 128:
        raise ValueError(f"{what}: contraction {K} x kernel {tuple(w_q.shape)} "
                         f"needs K % {k_mult} == 0, N % 128 == 0")
    if (w_q.dtype != torch.int8 or w_scale.numel() != N
            or (bias is not None and bias.numel() != N)):
        raise ValueError(f"{what}: w_q int8 [K, N], w_scale and bias [1, N]")
    return K, N


def _check(a, w_q, w_scale, bias):
    return (a.shape[0],) + check_weights("dense_gelu_quant", a.shape[1],
                                         w_q, w_scale, bias)


def int8_dense_gelu_quant(a, w_q, w_scale, bias, *, gelu_impl="tanh",
                          fast_epilogue=True, w_t=None):
    """Fused ``quantize(gelu(dequant(a @ w_q) + b))``.

    Args:
        a: [M, K] bf16 or fp32 activations (unquantised; fp32 is the JAX
            model's at ``dtype="float32"``: the row quant reads fp32 values).
        w_q: [K, N] int8 kernel; w_scale: [1, N] fp32; bias: [1, N].
        w_t: [N, K] int8, ``w_q.t()`` contiguous: the K-major copy the
            card's kernel reads (``wgmma`` takes 8-bit operands K-major
            only); needed on the card, made once by the caller.  The plain
            version checks its shape and reads ``w_q``.
    Returns:
        (int8 [M, N], fp32 row scales [M, 1]).

    ``launches`` counts every launch; ``f32_launches`` those of the fp32
    mode (an fp32 ``a``).
    """
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl {gelu_impl!r} not in {GELU_IMPLS}")
    M, K, N = _check(a, w_q, w_scale, bias)
    check_t("dense_gelu_quant", w_q, w_t)
    if a.device.type == "cpu":
        return dense_gelu_quant_plain(a, w_q, w_scale, bias, gelu_impl,
                                      fast_epilogue)
    return _launch(a, w_t, w_scale, bias, M, K, N, gelu_impl, fast_epilogue)


int8_dense_gelu_quant.launches = 0
int8_dense_gelu_quant.f32_launches = 0

_TILE = 128  # rows, columns and depth of a stage of the s8 wgmma tiles


def _launch(a, w_t, w_scale, bias, M, K, N, gelu_impl, fast_epilogue):
    from . import _build

    if a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dense_gelu_quant kernel takes bf16 or fp32, got "
                        f"{a.dtype}")
    if w_t is None:
        raise ValueError("dense_gelu_quant: the card's kernel reads the "
                         "weight K-major: pass w_t = w_q.t().contiguous(), "
                         "made once")
    if K % _TILE:
        raise ValueError(f"dense_gelu_quant: the s8 wgmma GEMM takes K in "
                         f"stages of 128, got K = {K}")
    lib = _build.load("dense_gelu_quant")
    fn = lib.dense_gelu_quant_dt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    f32 = a.dtype == torch.float32
    dev = a.device
    a = _build.aligned(a)
    w_t = _build.aligned(w_t)
    ws = w_scale.reshape(N).float().contiguous()
    b = bias.reshape(N).float().contiguous()
    a_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    part = torch.empty((M, N // _TILE), dtype=torch.float32, device=dev)
    g_q = torch.empty((M, N), dtype=torch.int8, device=dev)
    g_s = torch.empty((M, 1), dtype=torch.float32, device=dev)
    err = fn(a.data_ptr(), w_t.data_ptr(), ws.data_ptr(), b.data_ptr(),
             a_q.data_ptr(), s.data_ptr(), part.data_ptr(), g_q.data_ptr(),
             g_s.data_ptr(), M, K, N, GELU_IMPLS.index(gelu_impl),
             int(bool(fast_epilogue)), int(f32), _build.stream_ptr(dev))
    _build.check(lib, err, "dense_gelu_quant")
    int8_dense_gelu_quant.launches += 1
    int8_dense_gelu_quant.f32_launches += f32
    return g_q, g_s


def matmul_fused_plain(a, w_q, w_scale, out_dtype=torch.bfloat16,
                       group=None):
    """Plain PyTorch version of the fused W8A8 kernel: the floored scale
    both divides and rescales, ``((acc * s) * ws) -> out_dtype``.
    ``group``: the model group whose ranks hold the row's other columns
    and the kernel's other rows (the row scale over the whole row, the
    int32 partial products summed before the rescale)."""
    a_q, s = quantize_rows(a, group=group)
    s = s.clamp_min(1e-12)
    acc = group_sum(group, int8_mm(a_q, w_q)).float()
    return (acc * s * w_scale.reshape(1, -1)).to(out_dtype)


def check_t(what, w_q, w_t):
    """``w_t`` is ``w_q`` K-major: ``[N, K]`` int8, contiguous (the copy
    the s8 ``wgmma`` GEMMs read, made once by the caller)."""
    if w_t is not None and (w_t.shape != w_q.shape[::-1]
                            or w_t.dtype != torch.int8
                            or not w_t.is_contiguous()):
        raise ValueError(f"{what}: w_t must be w_q.t() contiguous, int8 "
                         f"{tuple(w_q.shape[::-1])}, got {tuple(w_t.shape)} "
                         f"{w_t.dtype}")


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # what the kernels take and write


def int8_matmul_fused(a, w_q, w_scale, *, out_dtype=torch.bfloat16,
                      w_t=None):
    """W8A8 product with the per-row quantisation of ``a`` inside the
    kernel (the serving out_proj; ``w8a8_dot(impl="fused")``).

    Args:
        a: [M, K] bf16 or fp32 activations (unquantised).
        w_q: [K, N] int8 kernel; w_scale: [1, N] fp32.
        out_dtype: bf16 or fp32 on the card (``w8a8_dot`` passes the
            lhs's dtype, as the JAX package does); the plain version takes
            any.
        w_t: [N, K] int8, ``w_q.t()`` contiguous: the K-major copy the
            card's kernel reads (``wgmma`` takes 8-bit operands K-major
            only); needed on the card, made once by the caller.  The plain
            version checks its shape and reads ``w_q``.
    Returns:
        [M, N] out_dtype.

    ``launches`` counts every launch; ``f32_launches`` those of the fp32
    mode (an fp32 ``a``).
    """
    M = a.shape[0]
    K, N = check_weights("matmul_fused", a.shape[1], w_q, w_scale)
    check_t("matmul_fused", w_q, w_t)
    if a.device.type == "cpu":
        return matmul_fused_plain(a, w_q, w_scale, out_dtype)
    from . import _build

    if a.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"matmul_fused kernel takes and writes bf16 or fp32, "
                        f"got a {a.dtype}, out_dtype {out_dtype}")
    if w_t is None:
        raise ValueError("matmul_fused: the card's kernel reads the weight "
                         "K-major: pass w_t = w_q.t().contiguous(), made once")
    if K < 128:
        raise ValueError(f"matmul_fused: the s8 wgmma GEMM needs K >= 128, "
                         f"got {K}")
    lib = _build.load("w8a8_fused")
    fn = lib.w8a8_fused_dt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    dev = a.device
    a = _build.aligned(a)
    w_t = _build.aligned(w_t)
    ws = w_scale.reshape(N).float().contiguous()
    a_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = fn(a.data_ptr(), w_t.data_ptr(), ws.data_ptr(), a_q.data_ptr(),
             s.data_ptr(), out.data_ptr(), M, K, N,
             int(a.dtype == torch.float32), int(out_dtype == torch.float32),
             _build.stream_ptr(dev))
    _build.check(lib, err, "matmul_fused")
    int8_matmul_fused.launches += 1
    int8_matmul_fused.f32_launches += a.dtype == torch.float32
    return out


int8_matmul_fused.launches = 0
int8_matmul_fused.f32_launches = 0


def matmul_prequant_plain(a_q, a_scale, w_q, w_scale, out_dtype=torch.bfloat16,
                          group=None):
    """Plain PyTorch version of the s8 product on a pre-quantised A:
    ``((acc * a_scale) * ws) -> out_dtype`` with the caller's scale.
    ``group``: the model group whose ranks hold the codes' other columns
    and the kernel's other rows (the int32 partial products summed)."""
    acc = group_sum(group, int8_mm(a_q, w_q)).float()
    return (acc * a_scale.reshape(-1, 1).float() * w_scale.reshape(1, -1)
            ).to(out_dtype)


def int8_matmul(a_q, a_scale, w_q, w_scale, *, out_dtype=torch.bfloat16,
                w_t=None):
    """``(a_q * a_scale) @ (w_q * w_scale) -> [M, N] out_dtype``.

    Args:
        a_q: [M, K] int8 codes; a_scale: [M, 1] fp32 (the quantiser's
            unfloored scale, as ``w8a8_dot`` passes it).
        w_q: [K, N] int8 kernel; w_scale: [1, N] fp32.
        w_t: [N, K] int8, ``w_q.t()`` contiguous: the K-major copy the
            card's kernel reads; needed on the card, made once by the
            caller.  The plain version checks its shape and reads ``w_q``.
    The card's kernel writes bf16 or fp32 (K % 16 == 0); the plain version
    any ``out_dtype``.  It is launched under programmatic stream
    serialisation: it starts while the launch in front of it drains
    (``w8a8_dot``'s row quant, :func:`int8_quantize_rows`) and waits for it
    before it reads anything but ``w_t``, which no launch that lets the
    next one start early (the port's row quants, ``int8_mlp``'s first
    product) writes.
    """
    M = a_q.shape[0]
    K, N = check_weights("int8_matmul", a_q.shape[1], w_q, w_scale, k_mult=16)
    if a_q.dtype != torch.int8 or a_scale.numel() != M:
        raise ValueError("int8_matmul: a_q int8 [M, K], a_scale [M, 1]")
    check_t("int8_matmul", w_q, w_t)
    if a_q.device.type == "cpu":
        return matmul_prequant_plain(a_q, a_scale, w_q, w_scale, out_dtype)
    from . import _build

    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_matmul kernel writes bf16 or fp32, not "
                        f"{out_dtype}")
    if w_t is None:
        raise ValueError("int8_matmul: the card's kernel reads the weight "
                         "K-major: pass w_t = w_q.t().contiguous(), made once")
    lib = _build.load("w8a8_fused")
    fn = lib.matmul_prequant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    a_q = _build.aligned(a_q)
    w_t = _build.aligned(w_t)
    s = a_scale.reshape(M).float().contiguous()
    ws = w_scale.reshape(N).float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a_q.device)
    err = fn(a_q.data_ptr(), s.data_ptr(), w_t.data_ptr(), ws.data_ptr(),
             out.data_ptr(), M, K, N, int(out_dtype == torch.float32), 1,
             _build.stream_ptr(a_q.device))
    _build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_quantize_rows(a):
    """``w8a8_dot``'s quantisation of ``a [M, K]``: ``(a_q int8 [M, K],
    a_scale fp32 [M, 1])``, the codes by the scale floored at 1e-12, the
    scale written unfloored (:func:`quantize_rows`, its plain version).

    The JAX package leaves it to XLA; on the card it is one launch of
    ``csrc/w8a8_fused.cu``'s row quant (bf16, K % 8 == 0), bit-equal to the
    plain version, which lets the launch behind it (:func:`int8_matmul`)
    start early.
    """
    if a.device.type == "cpu":
        return quantize_rows(a)
    from . import _build

    M, K = a.shape
    if a.dtype != torch.bfloat16 or K % 8:
        raise TypeError(f"int8_quantize_rows kernel takes bf16 rows of a "
                        f"multiple of 8, got {a.dtype} [{M}, {K}]")
    lib = _build.load("w8a8_fused")
    fn = lib.prequant_quant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    a = _build.aligned(a)
    a_q = torch.empty((M, K), dtype=torch.int8, device=a.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), a_q.data_ptr(), s.data_ptr(), M, K,
             _build.stream_ptr(a.device))
    _build.check(lib, err, "int8_quantize_rows")
    int8_quantize_rows.launches += 1
    return a_q, s


int8_quantize_rows.launches = 0


def _pick_slabs(n1: int, target: int = 1280) -> int:
    """Smallest slab count whose slab size is <= target and lane-aligned
    (a copy of the JAX package's, so both cut the hidden width alike)."""
    for k in range(1, 64):
        if n1 % k == 0 and n1 // k <= target and (n1 // k) % 128 == 0:
            return k
    return 1


def mlp_plain(a, w1_q, w1_scale, b1, w2_q, w2_scale, b2, gelu_impl="tanh",
              group=None, rank=0, ranks=1):
    """Plain PyTorch version of the whole-MLP kernel, with its rounding
    points: reciprocal-multiply quantisation, bf16 y and g, per-(row, slab)
    requant scales, and the fp32 sum over slabs in slab order.

    ``ranks`` > 1: the share of rank ``rank`` of a model group that holds
    columns ``[rank n1, (rank + 1) n1)`` of w1 (``w1_q`` and its scale and
    bias) and those rows of w2, the slabs those of the whole width: each
    (row, slab)'s max |g| over the group (``group_max``), each slab's int32
    product summed over it (``group_sum``), so every rank folds the
    one-card terms in slab order and returns the one-card output."""
    af = a.float()
    s = (af.abs().amax(dim=1, keepdim=True) * _INV127).clamp_min(1e-12)
    a_q = torch.round(af * (1.0 / s)).to(torch.int8)
    # The slabs of the whole width that this rank's columns touch, each
    # with its local columns.
    n1 = w1_q.shape[1]
    n_slabs = _pick_slabs(n1 * ranks)
    slab, c0 = n1 * ranks // n_slabs, rank * n1
    pieces = [(g, slice(max(c0, g * slab) - c0,
                        min(c0 + n1, (g + 1) * slab) - c0))
              for g in range(c0 // slab, (c0 + n1 - 1) // slab + 1)]
    M, N2 = a.shape[0], w2_q.shape[1]
    w1s, bb1 = w1_scale.reshape(1, -1), b1.reshape(1, -1).float()
    gmax = torch.zeros((M, n_slabs), device=a.device)
    gs = []
    for j, c in pieces:
        y = (int8_mm(a_q, w1_q[:, c]).float() * s * w1s[:, c] + bb1[:, c])
        gs.append(_gelu(y.bfloat16().float(), gelu_impl).bfloat16().float())
        gmax[:, j] = gs[-1].abs().amax(dim=1)
    scale = (group_max(group, gmax) * _INV127).clamp_min(1e-12)
    acc = torch.zeros((n_slabs, M, N2), dtype=torch.int32, device=a.device)
    for (j, c), g in zip(pieces, gs):
        g_q = torch.round(g * (1.0 / scale[:, j:j + 1])).to(torch.int8)
        acc[j] = int8_mm(g_q, w2_q[c])
    acc = group_sum(group, acc)
    acc2 = torch.zeros((M, N2), device=a.device)
    for j in range(n_slabs):
        acc2 = acc2 + acc[j].float() * scale[:, j:j + 1]
    return (acc2 * w2_scale.reshape(1, -1) + b2.reshape(1, -1).float()
            ).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """The card's launches of :func:`int8_mlp` (``csrc/mlp_full.cu``), as
    that source computes them.

    The hidden launch runs a CTA of ``hidden_rows`` rows and one slab of
    ``slab`` columns at ``hidden_grid = (n_slabs, row blocks)``: its two
    consumer warpgroups take the slab's ``tiles`` 128-wide column tiles in
    turns (warpgroup ``t % 2`` takes tile ``t``), with ``hidden_smem`` bytes
    of shared memory (the slab's bf16 g among them, but for each
    warpgroup's last tile, kept in its registers).  The second product
    runs ``out_rows`` x 128 tiles at ``out_grid = (N2 / 128, ceil(M /
    out_rows))``.
    """

    M: int
    K: int
    N1: int
    N2: int
    n_slabs: int
    slab: int
    hidden_rows: int
    hidden_grid: tuple
    tiles: int
    hidden_smem: int
    out_rows: int
    out_grid: tuple

    def hidden_cover(self):
        """Every ``(row, slab, column tile)`` each hidden CTA's warpgroups
        write, as ``(cta, warpgroup, row, slab, tile)`` tuples (rows past M
        are skipped, as the kernel skips their stores)."""
        gx, gy = self.hidden_grid
        for by in range(gy):
            for j in range(gx):
                for t in range(self.tiles):
                    for r in range(by * self.hidden_rows,
                                   min((by + 1) * self.hidden_rows, self.M)):
                        yield (j, by), t % 2, r, j, t


_MLP_HIDDEN_ROWS, _MLP_STAGES, _MLP_MAX_SLAB, _MLP_OUT_ROWS = 64, 4, 1280, 192
_MLP_REG_TILES = 2  # the last column tile of each warpgroup: in registers
_SMEM_LIMIT = 232448  # the H100's largest dynamic shared memory a CTA


def mlp_plan(M: int, K: int, N1: int, N2: int) -> MlpPlan:
    """The launch plan of :func:`int8_mlp` on the card; raises
    ``ValueError`` for a shape its kernels do not take: K % 128, K <= 4096
    (the row quant keeps a row in registers), N2 % 128, and each slab
    (``_pick_slabs``) a multiple of 128 no wider than 1280 (its g fills the
    hidden CTA's shared memory)."""
    n_slabs = _pick_slabs(N1)
    slab = N1 // n_slabs
    if K % _TILE or K > 4096 or N2 % _TILE:
        raise ValueError(f"int8_mlp: the kernels take K % 128 == 0, K <= "
                         f"4096 and N2 % 128 == 0, got K = {K}, N2 = {N2}")
    if slab % _TILE or slab > _MLP_MAX_SLAB:
        raise ValueError(f"int8_mlp: a slab of {slab} (N1 = {N1}) is not a "
                         f"multiple of 128 up to {_MLP_MAX_SLAB}")
    rows = _MLP_HIDDEN_ROWS
    in_smem = max(slab // _TILE - _MLP_REG_TILES, 0)
    smem = (_MLP_STAGES * (rows + _TILE) * _TILE
            + rows * (2 * _TILE * in_smem + 16) + 3 * rows * 4
            + 2 * _MLP_STAGES * 8 + 1024)
    assert smem <= _SMEM_LIMIT, smem
    return MlpPlan(M, K, N1, N2, n_slabs, slab, rows,
                   (n_slabs, -(-M // rows)), slab // _TILE, smem,
                   _MLP_OUT_ROWS, (N2 // _TILE, -(-M // _MLP_OUT_ROWS)))


def int8_mlp(a, w1_q, w1_scale, b1, w2_q, w2_scale, b2, *, gelu_impl="tanh",
             w1_t=None, w2_t=None):
    """The whole serving MLP, ``dequant(quant(gelu(a @ w1 + b1)) @ w2) + b2``,
    with per-(row, slab) requant scales of the hidden activation.

    Args:
        a: [M, K] bf16 activations (unquantised), or fp32 (the JAX model's
            at ``dtype="float32"``: the fp32 mode, whose row quant reads
            fp32 rows; ``f32_launches`` counts it apart).
        w1_q: [K, N1] int8; w1_scale, b1: [1, N1] fp32.
        w2_q: [N1, N2] int8; w2_scale, b2: [1, N2].
        w1_t, w2_t: [N1, K] and [N2, N1] int8, ``w1_q.t()`` and
            ``w2_q.t()`` contiguous: the K-major copies the card's kernels
            read; needed on the card, made once by the caller.  The plain
            version checks their shapes and reads ``w1_q`` and ``w2_q``.
    Returns:
        [M, N2] bf16, in either mode (as the JAX kernel writes it).
    """
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl {gelu_impl!r} not in {GELU_IMPLS}")
    M = a.shape[0]
    K, N1 = check_weights("int8_mlp", a.shape[1], w1_q, w1_scale, b1)
    _, N2 = check_weights("int8_mlp", N1, w2_q, w2_scale, b2)
    check_t("int8_mlp", w1_q, w1_t)
    check_t("int8_mlp", w2_q, w2_t)
    if a.device.type == "cpu":
        return mlp_plain(a, w1_q, w1_scale, b1, w2_q, w2_scale, b2, gelu_impl)
    from . import _build

    if a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"int8_mlp kernel takes bf16 or fp32, got {a.dtype}")
    if w1_t is None or w2_t is None:
        raise ValueError("int8_mlp: the card's kernels read both weights "
                         "K-major: pass w1_t = w1_q.t().contiguous() and "
                         "w2_t = w2_q.t().contiguous(), made once")
    plan = mlp_plan(M, K, N1, N2)
    lib = _build.load("mlp_full")
    f32 = a.dtype == torch.float32
    fn = lib.int8_mlp_f32 if f32 else lib.int8_mlp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    dev = a.device
    a, w1_t, w2_t = (_build.aligned(t) for t in (a, w1_t, w2_t))
    w1s, bb1, w2s, bb2 = (t.reshape(-1).float().contiguous()
                          for t in (w1_scale, b1, w2_scale, b2))
    aq = torch.empty((M, K), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    gq = torch.empty((M, N1), dtype=torch.int8, device=dev)
    gs = torch.empty((M, plan.n_slabs), dtype=torch.float32, device=dev)
    out = torch.empty((M, N2), dtype=torch.bfloat16, device=dev)
    err = fn(a.data_ptr(), w1_t.data_ptr(), w1s.data_ptr(), bb1.data_ptr(),
             w2_t.data_ptr(), w2s.data_ptr(), bb2.data_ptr(), aq.data_ptr(),
             s.data_ptr(), gq.data_ptr(), gs.data_ptr(), out.data_ptr(), M, K,
             N1, N2, plan.n_slabs, GELU_IMPLS.index(gelu_impl),
             _build.stream_ptr(dev))
    _build.check(lib, err, "int8_mlp")
    int8_mlp.launches += 1
    int8_mlp.f32_launches += f32
    return out


int8_mlp.launches = 0
int8_mlp.f32_launches = 0
