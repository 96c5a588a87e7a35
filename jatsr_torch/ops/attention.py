"""The serving attention kernels: flash GQA from the unsplit fused-QKV
projection, alone or with the int8 out projection fused in, and GQA on
split, RoPE'd q/k/v (the flash kernel and the per-q-head and per-kv-head
kernels).

Ports of ``gqa_attention_flash_qkv``, ``gqa_attention_flash_out``,
``gqa_attention_flash``, ``gqa_attention`` and ``gqa_attention_grouped``
(JAX package, ``ops/attention.py``).  Each wrapper dispatches on the
tensor's device: a CPU tensor takes the plain PyTorch version below, a CUDA
tensor launches the hand-written kernel in ``csrc/flash_qkv.cu`` or
``csrc/attention_split.cu`` or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .int8_matmul import _INV127, check_weights, int8_mm

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


def _scores_plain(qkv, cos, sin, hq, hkv, n_valid):
    """The flash kernels' masked base-2 scores ``[B, Hq, N, N]`` fp32 and
    the ``[B, Hq, N, D]`` values (kv heads repeated)."""
    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    g = hq // hkv
    dt = qkv.dtype
    scale2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
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


def flash_qkv_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid=0):
    """Plain PyTorch version of the kernel, with its rounding points."""
    B, N, _ = qkv.shape
    dt = qkv.dtype
    s, v = _scores_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    o = (e.to(dt).float() @ v.float()) * r
    return o.to(dt).permute(0, 2, 1, 3).reshape(B, N, -1)


def gqa_attention_flash_qkv(qkv, cos, sin, num_q_heads: int,
                            num_kv_heads: int, n_valid: int = 0):
    """Flash GQA from the raw fused-QKV projection output.

    Args:
        qkv: [B, N, (Hq + 2*Hkv) * D]: q heads, then k heads, then v heads,
            before RoPE (the rotation happens inside).
        cos/sin: [N, D] fp32 RoPE tables.
        n_valid: keys at positions >= n_valid are masked; 0 means N.
    Returns:
        [B, N, Hq*D] in qkv's dtype.
    """
    B, N, TD = qkv.shape
    if TD % (num_q_heads + 2 * num_kv_heads) or num_q_heads % num_kv_heads:
        raise ValueError(f"qkv width {TD} does not split into "
                         f"{num_q_heads}+2x{num_kv_heads} heads")
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid {n_valid} outside [0, {N}]")
    if qkv.device.type == "cpu":
        return flash_qkv_plain(qkv, cos, sin, num_q_heads, num_kv_heads,
                               n_valid)
    return _launch(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid or N)


gqa_attention_flash_qkv.launches = 0


def _prepare(qkv, cos, sin, hq, hkv):
    """The library, the prep images' scratch and bf16(scale * log2 e) of a
    flash launch, after the checks both kernels share."""
    from . import _build

    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    if qkv.dtype != torch.bfloat16 or D != 64:
        raise TypeError(f"the flash kernels take bf16 with head dim 64, got "
                        f"{qkv.dtype} with head dim {D}")
    if cos.shape != (N, D) or sin.shape != (N, D):
        raise ValueError(f"cos/sin must be [{N}, {D}]")
    lib = _build.load("flash_qkv")
    lib.flash_qkv_smem_bytes.restype = ctypes.c_int
    lib.flash_qkv_smem_bytes.argtypes = [ctypes.c_int]
    smem, limit = lib.flash_qkv_smem_bytes(N), _smem_optin(qkv.device.index)
    if smem > limit:
        raise ValueError(f"flash kernels: N={N} needs {smem} B of shared "
                         f"memory, the card gives {limit}")
    lib.flash_qkv_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_qkv_scratch_bytes.argtypes = [ctypes.c_int] * 4
    scratch = torch.empty(lib.flash_qkv_scratch_bytes(B, N, hq, hkv),
                          dtype=torch.uint8, device=qkv.device)
    return lib, scratch, _scale2_bf16(D)


@functools.cache
def _scale2_bf16(d: int) -> float:
    """bf16(scale * log2 e), the flash kernels' q factor, as a float."""
    return float(torch.tensor((1.0 / math.sqrt(d)) * math.log2(math.e),
                              dtype=torch.bfloat16))


def _launch(qkv, cos, sin, hq, hkv, n_valid):
    from . import _build

    B, N, _ = qkv.shape
    lib, scratch, scale2 = _prepare(qkv, cos, sin, hq, hkv)
    fn = lib.flash_qkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    qkv = _build.aligned(qkv)
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    out = torch.empty((B, N, hq * 64), dtype=torch.bfloat16,
                      device=qkv.device)
    err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
             scratch.data_ptr(), out.data_ptr(), B, N, n_valid, hq, hkv,
             scale2, _build.stream_ptr(qkv.device))
    _build.check(lib, err, "flash_qkv")
    gqa_attention_flash_qkv.launches += 1
    return out


def flash_out_plain(qkv, cos, sin, wo_q, wo_scale, wo_bias, num_q_heads,
                    num_kv_heads, n_valid=0):
    """Plain PyTorch version of the fused out-projection kernel, with its
    rounding points: normalised weights rounded before the value product,
    each head's output rounded, the whole row quantised by a true divide by
    its floored scale, then ``((acc * so) * wos + bo)``."""
    B, N, _ = qkv.shape
    dt = qkv.dtype
    s, v = _scores_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    w = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    o = (w.float() @ v.float()).to(dt)                   # [B, Hq, N, D]
    o = o.permute(0, 2, 1, 3).reshape(B * N, -1).float()
    so = (o.abs().amax(dim=1, keepdim=True) * _INV127).clamp_min(1e-12)
    o_q = torch.round(o / so).to(torch.int8)
    acc = int8_mm(o_q, wo_q).float()
    out = acc * so * wo_scale.reshape(1, -1) + wo_bias.reshape(1, -1).float()
    return out.to(dt).reshape(B, N, -1)


def gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_scale, wo_bias,
                            num_q_heads: int, num_kv_heads: int,
                            n_valid: int = 0):
    """Flash GQA with the int8 output projection fused in.

    Args:
        qkv: [B, N, (Hq + 2*Hkv) * D] pre-RoPE fused projection output.
        cos/sin: [N, D] fp32 RoPE tables.
        wo_q: [Hq*D, H] int8 out-projection kernel; wo_scale: [1, H] fp32
            per-column scales; wo_bias: [1, H] fp32 (zeros where the
            projection has none).
        n_valid: keys at positions >= n_valid are masked; 0 means N.
    Returns:
        [B, N, H] in qkv's dtype: the attention branch before the residual.
    """
    B, N, TD = qkv.shape
    hq, hkv = num_q_heads, num_kv_heads
    if TD % (hq + 2 * hkv) or hq % hkv:
        raise ValueError(f"qkv width {TD} does not split into "
                         f"{hq}+2x{hkv} heads")
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid {n_valid} outside [0, {N}]")
    _, H = check_weights("flash_out", hq * (TD // (hq + 2 * hkv)), wo_q,
                         wo_scale, wo_bias)
    if qkv.device.type == "cpu":
        return flash_out_plain(qkv, cos, sin, wo_q, wo_scale, wo_bias, hq, hkv,
                               n_valid)
    from . import _build

    lib, scratch, scale2 = _prepare(qkv, cos, sin, hq, hkv)
    fn = lib.flash_out
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    dev = qkv.device
    M, K = B * N, hq * 64
    qkv = _build.aligned(qkv)
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    wo_q = _build.aligned(wo_q)
    wos, bo = (t.reshape(H).float().contiguous() for t in (wo_scale, wo_bias))
    o = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    oq = torch.empty((M, K), dtype=torch.int8, device=dev)
    so = torch.empty((M,), dtype=torch.float32, device=dev)
    out = torch.empty((B, N, H), dtype=torch.bfloat16, device=dev)
    err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), wo_q.data_ptr(),
             wos.data_ptr(), bo.data_ptr(), scratch.data_ptr(), o.data_ptr(),
             oq.data_ptr(), so.data_ptr(), out.data_ptr(), B, N, n_valid or N,
             hq, hkv, H, scale2, _build.stream_ptr(dev))
    _build.check(lib, err, "flash_out")
    gqa_attention_flash_out.launches += 1
    return out


gqa_attention_flash_out.launches = 0


# ---- split q/k/v: B11 (flash), B15 (per q-head), B16 (per kv-head) ----------

def flash_split_plain(q, k, v, num_q_heads, num_kv_heads):
    """Plain PyTorch version of the split-input flash kernel, with its
    rounding points: zero rows pad N to a multiple of 8 and are NOT masked:
    they score 0 and take part in the row max m, and their share of the
    sum, ``npad * exp2(-m)``, is taken off the denominator."""
    B, N, _ = q.shape
    hq, hkv = num_q_heads, num_kv_heads
    D = q.shape[2] // hq
    dt = q.dtype
    npad = _round_up(N, 8) - N

    def heads(x, h):  # [B, N, h*D] -> [B, hq, Np, D], kv heads repeated
        x = F.pad(x, (0, 0, 0, npad)).reshape(B, N + npad, h, D)
        return x.transpose(1, 2).repeat_interleave(hq // h, dim=1)

    scale2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    s = ((heads(q, hq) * torch.tensor(scale2, dtype=dt)).float()
         @ heads(k, hkv).float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    if npad:
        denom = denom - npad * torch.exp2(-m)
    o = (e.to(dt).float() @ heads(v, hkv).float()) * (1.0 / denom)
    return o.to(dt).transpose(1, 2).reshape(B, N + npad, hq * D)[:, :N]


def gqa_attention_plain(q, k, v):
    """Plain PyTorch version of the per-q-head and the per-kv-head kernels
    (one function), with their rounding points: fp32 scores times
    ``1/sqrt(D)`` after the product, keys past N carry no weight (the
    kernels' padding to 128 adds only zeros), ``e = exp(s - m)``, the
    weights ``bf16(e / sum(e))`` before the value product."""
    B, N, hq, D = q.shape
    g = hq // k.shape[2]
    dt = q.dtype
    kh, vh = (x.transpose(1, 2).repeat_interleave(g, dim=1).float()
              for x in (k, v))
    s = (q.transpose(1, 2).float() @ kh.transpose(-1, -2)) * (
        1.0 / math.sqrt(D))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return (w.float() @ vh).to(dt).transpose(1, 2)


def gqa_attention_flash(q, k, v, num_q_heads: int, num_kv_heads: int):
    """Flash GQA on split, RoPE'd inputs in the projections' flat layout.

    Args:
        q: [B, N, Hq*D]; k/v: [B, N, Hkv*D] (heads in column blocks).
    Returns:
        [B, N, Hq*D] in q's dtype.
    """
    hq, hkv = num_q_heads, num_kv_heads
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or q.shape[:2] != k.shape[:2] or hq % hkv or q.shape[2] % hq
            or k.shape[2] != hkv * (q.shape[2] // hq)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not {hq}/{hkv}-head GQA inputs")
    if q.device.type == "cpu":
        return flash_split_plain(q, k, v, hq, hkv)
    out = _launch_split(0, q, k, v, hq, hkv, q.shape[2] // hq)
    gqa_attention_flash.launches += 1
    return out


gqa_attention_flash.launches = 0


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
        [B, N, Hq, D] in q's dtype.
    """
    _check_heads(q, k, v)
    if q.device.type == "cpu":
        return gqa_attention_plain(q, k, v)
    B, N, hq, D = q.shape
    out = _launch_split(1, q, k, v, hq, k.shape[2], D)
    gqa_attention.launches += 1
    return out.reshape(B, N, hq, D)


gqa_attention.launches = 0


def gqa_attention_grouped(q, k, v):
    """The same function as :func:`gqa_attention`, a program per (batch,
    kv-head) that runs its group's q-heads against K and V loaded once."""
    _check_heads(q, k, v)
    if q.device.type == "cpu":
        return gqa_attention_plain(q, k, v)
    B, N, hq, D = q.shape
    out = _launch_split(2, q, k, v, hq, k.shape[2], D)
    gqa_attention_grouped.launches += 1
    return out.reshape(B, N, hq, D)


gqa_attention_grouped.launches = 0


def _row_view(t):
    """``t`` [B, N, W] or [B, N, H, D] as the kernels read it: rows of dense
    heads at one row stride, which a column slice of the fused projection
    has; any other layout is copied.  Returns the tensor and its row
    stride."""
    dense = t.stride(-1) == 1 and (t.dim() == 3 or t.stride(2) == t.shape[3])
    if not (dense and t.stride(0) == t.shape[1] * t.stride(1)):
        t = t.contiguous()
    return t, t.stride(1)


@functools.cache
def _split_lib():
    """csrc/attention_split.cu's library, its entry points' C types set."""
    from . import _build

    lib = _build.load("attention_split")
    lib.attention_split_smem_bytes.restype = ctypes.c_int
    lib.attention_split_smem_bytes.argtypes = [ctypes.c_int]
    lib.attention_split_scratch_bytes.restype = ctypes.c_longlong
    lib.attention_split_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.attention_split.restype = ctypes.c_int
    lib.attention_split.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_void_p])
    return lib


@functools.cache
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _launch_split(kind, q, k, v, hq, hkv, D):
    """One C call of csrc/attention_split.cu: kind 0 is the flash kernel,
    1 the per-q-head kernel, 2 the per-kv-head kernel."""
    from . import _build

    B, N = q.shape[:2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or D != 64:
        raise TypeError(f"the split attention kernels take bf16 with head dim "
                        f"64, got {q.dtype} with head dim {D}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    lib = _split_lib()
    smem, limit = lib.attention_split_smem_bytes(N), _smem_optin(
        q.device.index)
    if smem > limit:
        raise ValueError(f"split attention: N={N} needs {smem} B of shared "
                         f"memory, the card gives {limit}")
    scratch = torch.empty(lib.attention_split_scratch_bytes(B, N, hq, hkv),
                          dtype=torch.uint8, device=q.device)
    (q, q_row), (k, k_row), (v, v_row) = map(_row_view, (q, k, v))
    out = torch.empty((B, N, hq * D), dtype=torch.bfloat16, device=q.device)
    err = lib.attention_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_row, k_row, v_row,
        scratch.data_ptr(), out.data_ptr(), B, N, hq, hkv, kind,
        _scale2_bf16(D) if kind == 0 else 1.0, 1.0 / math.sqrt(D),
        _build.stream_ptr(q.device))
    _build.check(lib, err, ("flash_split", "gqa_attention",
                            "gqa_attention_grouped")[kind])
    return out
