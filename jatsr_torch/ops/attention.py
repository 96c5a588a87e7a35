"""Flash GQA attention from the unsplit fused-QKV projection, alone or with
the int8 out projection fused in.

Ports of ``gqa_attention_flash_qkv`` and ``gqa_attention_flash_out`` (JAX
package, ``ops/attention.py``).  Each wrapper dispatches on the tensor's
device: a CPU tensor takes the plain PyTorch version below, a CUDA tensor
launches the hand-written kernel in ``csrc/flash_qkv.cu`` or raises.
Nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .int8_matmul import _INV127, check_weights, int8_mm

# The TPU kernel's per-program VMEM budget: beyond it the JAX model takes
# its XLA einsum path, which the port does not have yet.
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
    smem = lib.flash_qkv_smem_bytes(N)
    limit = torch.cuda.get_device_properties(qkv.device) \
        .shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"flash kernels: N={N} needs {smem} B of shared "
                         f"memory, the card gives {limit}")
    lib.flash_qkv_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_qkv_scratch_bytes.argtypes = [ctypes.c_int] * 4
    scratch = torch.empty(lib.flash_qkv_scratch_bytes(B, N, hq, hkv),
                          dtype=torch.uint8, device=qkv.device)
    scale2 = float(torch.tensor((1.0 / math.sqrt(D)) * math.log2(math.e),
                                dtype=torch.bfloat16))
    return lib, scratch, scale2


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
