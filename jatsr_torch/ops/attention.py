"""Flash GQA attention from the unsplit fused-QKV projection.

Port of ``gqa_attention_flash_qkv`` (JAX package, ``ops/attention.py``).
The wrapper dispatches on the tensor's device: a CPU tensor takes the plain
PyTorch version below, a CUDA tensor launches the hand-written kernel in
``csrc/flash_qkv.cu`` or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

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


def flash_qkv_plain(qkv, cos, sin, num_q_heads, num_kv_heads, n_valid=0):
    """Plain PyTorch version of the kernel, with its rounding points."""
    B, N, TD = qkv.shape
    hq, hkv = num_q_heads, num_kv_heads
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
    s = q.float() @ k.float().transpose(-1, -2)          # [B, Hq, N, N] fp32
    col = torch.arange(N, device=qkv.device)
    s = s.masked_fill(col >= (n_valid or N), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    o = (e.to(dt).float() @ v.float()) * r
    return o.to(dt).permute(0, 2, 1, 3).reshape(B, N, hq * D)


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


def _launch(qkv, cos, sin, hq, hkv, n_valid):
    from . import _build

    B, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    if qkv.dtype != torch.bfloat16 or D != 64:
        raise TypeError(f"flash_qkv kernel takes bf16 with head dim 64, got "
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
        raise ValueError(f"flash_qkv: N={N} needs {smem} B of shared memory, "
                         f"the card gives {limit}")
    lib.flash_qkv_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_qkv_scratch_bytes.argtypes = [ctypes.c_int] * 4
    fn = lib.flash_qkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    qkv = _build.aligned(qkv)
    cos = cos.float().contiguous()
    sin = sin.float().contiguous()
    scratch = torch.empty(lib.flash_qkv_scratch_bytes(B, N, hq, hkv),
                          dtype=torch.uint8, device=qkv.device)
    out = torch.empty((B, N, hq * D), dtype=torch.bfloat16,
                      device=qkv.device)
    scale2 = float(torch.tensor((1.0 / math.sqrt(D)) * math.log2(math.e),
                                dtype=torch.bfloat16))
    err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
             scratch.data_ptr(), out.data_ptr(), B, N, n_valid, hq, hkv,
             scale2, _build.stream_ptr(qkv.device))
    _build.check(lib, err, "flash_qkv")
    gqa_attention_flash_qkv.launches += 1
    return out
