"""Dynamic W8A8 products and static int8 weights for serving.

Port of the JAX package's ``ops/quant.py``: the activation is quantised
per row, the weight per output column (once, at load time, by
:func:`quantize_params_static`; or at every call, by
:func:`int8_dot_general`, under ``matmul_precision="int8"``), the product
accumulates exactly in int32 and the rescale is fp32.  On the ``"xla"``
path the int32 product is a plain product outside any kernel, so it goes
to ``torch._int_mm``; on the card
``"fused"`` launches the fused W8A8 kernel, which quantises inside, and
``"pallas"`` quantises (one row-quant launch for a bf16 lhs, torch ops for
an fp32 one, as the JAX package does in XLA) and launches the s8 kernel on
the pre-quantised A.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .int8_matmul import (_INV127, check_t, group_max, group_sum,
                          int8_matmul, int8_matmul_fused, int8_mm,
                          int8_quantize_rows)
from .split import int8_matmul_fused_split, int8_matmul_split

INT8_IMPLS = ("xla", "fused", "pallas")


def w8a8_dot(lhs: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             impl: str = "xla", w_t: torch.Tensor | None = None,
             group=None, whole: tuple | None = None) -> torch.Tensor:
    """``lhs [..., K] @ (w_q * w_scale) -> [..., N]`` in lhs's dtype.

    The absmax is taken on lhs's own dtype (bf16 -> fp32 is exact), the
    divide uses the scale floored at 1e-12, the rescale the unfloored one:
    ``(acc * a_scale) * w_scale``.

    ``impl="fused"`` and ``impl="pallas"`` take their kernels where the JAX
    package does on a TPU (``K % 128 == 0``, ``N % 128 == 0``, at least 32
    rows) and lhs lies on the card; elsewhere both are this plain path,
    which the kernels equal bit for bit ("fused" floors the rescale, which
    only differs on an all-zero row, whose product is zero either way).
    On the card "pallas" quantises a bf16 lhs in one launch
    (:func:`int8_quantize_rows`, bit-equal to the torch ops below) and
    starts the s8 kernel behind it early; an fp32 lhs keeps the torch ops,
    and the kernel writes fp32.  "fused" takes a bf16 or fp32 lhs and
    writes its dtype, as the JAX package's kernel does (``out_dtype``).  Both kernels read the weight K-major:
    ``w_t``, ``w_q.t()`` contiguous, made once by the caller
    (:class:`QuantDense` keeps it).

    ``group``: the tensor-parallel model group where ``lhs`` holds a
    rank's columns of the input (its heads) and ``w_q`` its rows of the
    kernel: the row scale is taken over the whole row and the int32
    partial products are summed before the rescale, so every rank gets
    the one-card product; on the card "fused" takes B4's split entry
    (:func:`int8_matmul_fused_split`) and "pallas" B14's
    (:func:`int8_matmul_split`).  ``whole``: the whole projection's ``(K,
    N)`` where ``lhs`` and ``w_q`` hold a rank's share (its rows under
    ``group``, else its columns): the kernel gate is then the whole
    width's, as JAX's, and where the whole width takes a kernel whose
    tiling the rank's share fails (N % 128 of a rank's columns, K % 16 of
    its rows) the card raises ``ValueError`` rather than change branch.
    """
    if impl not in INT8_IMPLS:
        raise ValueError(f"int8_impl={impl!r} not in {INT8_IMPLS}")
    check_t("w8a8_dot", w_q, w_t)
    K, N = w_q.shape
    Kw, Nw = whole or (K, N)
    lead = lhs.shape[:-1]
    M = lhs.numel() // K
    kernel = (lhs.device.type == "cuda" and Kw % 128 == 0 and Nw % 128 == 0
              and M >= 32)
    if kernel and impl != "xla" and (N % 128 or K % 16):
        raise ValueError(
            f"w8a8_dot(impl={impl!r}): a rank's [{K}, {N}] share of the "
            f"[{Kw}, {Nw}] kernel fails the card kernel's tiling (N % 128, "
            f"K % 16) that the whole width passes")
    if impl == "fused" and kernel:
        if group is None:
            out = int8_matmul_fused(lhs.reshape(M, K), w_q, w_scale,
                                    out_dtype=lhs.dtype, w_t=w_t)
        else:
            out = int8_matmul_fused_split(lhs.reshape(M, K), w_q, w_scale,
                                          group, out_dtype=lhs.dtype,
                                          w_t=w_t)
        return out.reshape(*lead, N)
    if impl == "pallas" and kernel and group is not None:
        out = int8_matmul_split(lhs.reshape(M, K), w_q, w_scale, group,
                                out_dtype=lhs.dtype, w_t=w_t)
        return out.reshape(*lead, N)
    if impl == "pallas" and kernel and lhs.dtype == torch.bfloat16:
        a_q, a_scale = int8_quantize_rows(lhs.reshape(M, K))
        out = int8_matmul(a_q, a_scale, w_q, w_scale, out_dtype=lhs.dtype,
                          w_t=w_t)
        return out.reshape(*lead, N)
    a_scale = group_max(group, lhs.abs().amax(dim=-1, keepdim=True).float()
                        ) * _INV127
    a_q = torch.round(lhs.float() / a_scale.clamp_min(1e-12)).to(torch.int8)
    if impl == "pallas" and kernel:
        out = int8_matmul(a_q.reshape(M, K), a_scale.reshape(M, 1), w_q,
                          w_scale, out_dtype=lhs.dtype, w_t=w_t)
        return out.reshape(*lead, N)
    acc = group_sum(group, int8_mm(a_q.reshape(-1, K), w_q))
    acc = acc.float().reshape(*lead, N)
    return (acc * a_scale * w_scale.reshape(N)).to(lhs.dtype)


class QuantDense(nn.Module):
    """Serving Dense with an int8 ``[K, N]`` kernel and fp32 ``[1, N]``
    per-column scales; in and out in ``dtype`` (the model's compute dtype,
    bf16 or fp32), the optional bias (in its parameter dtype) added in it.
    ``int8_impl`` is :func:`w8a8_dot`'s ``impl``; with ``"fused"`` or
    ``"pallas"`` the kernel is kept a second time K-major, ``kernel_t [N,
    K]`` (not in the state dict), which their kernels' s8 ``wgmma`` GEMM
    reads.  ``group``: a tensor-parallel model group where the module holds
    a rank's rows of a row-parallel kernel (:func:`w8a8_dot`'s ``group``;
    the bias, whole, added once after the sum).  ``whole``: the whole
    kernel's ``(K, N)`` where the module holds a rank's share
    (:func:`w8a8_dot`'s ``whole``)."""

    group = None
    whole = None

    def __init__(self, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                 bias: torch.Tensor | None = None, int8_impl: str = "xla",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", kernel_q.to(torch.int8))
        self.register_buffer("kernel_scale",
                             kernel_scale.float().reshape(1, -1))
        self.register_buffer("bias", bias)
        self.register_buffer(
            "kernel_t", self.kernel_q.t().contiguous()
            if int8_impl in ("fused", "pallas") else None, persistent=False)
        self.int8_impl = int8_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = w8a8_dot(x.to(self.dtype), self.kernel_q, self.kernel_scale,
                       impl=self.int8_impl, w_t=self.kernel_t,
                       group=self.group, whole=self.whole)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


def _quantize_kernel(kernel: torch.Tensor, group=None):
    """The kernel's per-output-column codes K-major, ``[N, K]`` int8, and
    its scales ``[N, 1]`` fp32 (``max|w| * _INV127``, unfloored).
    ``group``: the model group where ``kernel`` holds a rank's rows (the
    column maxima taken over the whole K)."""
    w_t = kernel.t().float()                       # [N, K]
    scale = group_max(group, w_t.abs().amax(dim=1, keepdim=True)) * _INV127
    codes = torch.round(w_t / scale.clamp_min(1e-12)).to(
        torch.int8).contiguous()
    return codes, scale


def _dynamic_dot(x: torch.Tensor, kernel: torch.Tensor, impl: str,
                 group=None, whole=None) -> torch.Tensor:
    codes, scale = _quantize_kernel(kernel, group)
    return w8a8_dot(x, codes.t(), scale.reshape(1, -1), impl=impl,
                    w_t=codes if impl in ("fused", "pallas") else None,
                    group=group, whole=whole)


def _max_abs_vjp(v: torch.Tensor, vmax: torch.Tensor, ct: torch.Tensor,
                 dim: int, group=None) -> torch.Tensor:
    """The cotangent of ``v`` through ``vmax = max(|v|, dim)`` given
    ``ct``, ``vmax``'s (both ``v``'s dtype): JAX's transposes of ``max``
    (the cotangent split equally among tied maxima, divided by their count
    in ``v``'s dtype) and of ``abs`` (``+ct`` where ``v >= 0``).
    ``group``: the model group whose ranks hold the rest of ``dim`` (the
    ties counted over every rank; the cotangent lands on this rank's)."""
    hit = (v.abs() == vmax).to(v.dtype)
    count = hit.sum(dim=dim, keepdim=True)
    if group is not None:
        count = group.sum_f32(count).to(v.dtype)
    share = hit * (ct / count)
    return torch.where(v >= 0, share, -share)


class _Int8DotGeneral(torch.autograd.Function):
    """:func:`int8_dot_general` under autograd, with the gradient JAX's
    ``jax.grad`` takes through the JAX package's function.  The codes pass
    through ``round``, an int8 cast and an int32 product, which carry no
    cotangent, so the two scales are the only paths:

    - the row scale ``a[m] = fp32(max_k |x[m, k]|) * _INV127``:
      ``ct_a[m] = sum_n acc[m, n] * (g * ws)[m, n]`` in fp32, times
      ``_INV127``, rounded to x's dtype, then ``max``'s and ``abs``'s
      transposes (:func:`_max_abs_vjp`);
    - the column scale ``ws[n] = max_k |w[k, n]| * _INV127`` (fp32):
      ``ct_ws[n] = sum_m (acc * a)[m, n] * g[m, n]``, times ``_INV127``,
      the same transposes in fp32, then rounded to the kernel's dtype.

    ``acc`` (the int32 product) is not kept: the backward quantises ``x``
    and the kernel again and recomputes it with :func:`int8_mm`, so the
    saved tensors are the two inputs, which a bf16 product saves too, and
    the backward pays one more int8 product and the quantisations.

    ``group`` with ``role`` "row" (a row-parallel rank: ``x`` its
    columns, ``kernel`` its rows) takes the row and column maxima over the
    model group (MAX) and sums the int32 partial products (SUM), in the
    forward and again in the backward, and counts the tied maxima over
    the group (SUM): the forward is the one-card product bit for bit, and
    each rank's cotangents are its share of the one-card ones.

    ``group`` with ``role`` "col" (a column-parallel rank: ``x`` whole,
    ``kernel`` its columns) sums the row scale's fp32 cotangent over the
    group before its rounding, as one card's sum over every column rounds
    once: every rank then holds x's whole one-card cotangent (Megatron's
    f folded into the product)."""

    @staticmethod
    def forward(ctx, x, kernel, impl, group, role, whole):
        ctx.save_for_backward(x, kernel)
        ctx.group, ctx.col = (group, None) if role == "row" else (None, group)
        return _dynamic_dot(x, kernel, impl, ctx.group, whole)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        group = ctx.group
        K, N = kernel.shape
        codes, ws = _quantize_kernel(kernel, group)  # [N, K], [N, 1]
        xs = x.reshape(-1, K)
        amax = xs.abs().amax(dim=-1, keepdim=True)  # x's dtype
        if group is not None:
            amax = group.max_(amax.float()).to(x.dtype)
        a = amax.float() * _INV127                  # [M, 1]
        a_q = torch.round(xs.float() / a.clamp_min(1e-12)).to(torch.int8)
        acc = group_sum(group, int8_mm(a_q, codes.t())).float()  # [M, N]
        gf = g.reshape(-1, N).float()
        ws_row = ws.reshape(1, N)
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            ct_a = (acc * (gf * ws_row)).sum(dim=1, keepdim=True)
            if ctx.col is not None:
                ct_a = ctx.col.sum_f32(ct_a)
            ct_amax = (ct_a * _INV127).to(x.dtype)
            grad_x = _max_abs_vjp(xs, amax, ct_amax, 1, group).reshape(
                x.shape)
        if ctx.needs_input_grad[1]:
            ct_ws = ((acc * a) * gf).sum(dim=0, keepdim=True)  # [1, N]
            w = kernel.float()
            wmax = group_max(group, w.abs().amax(dim=0, keepdim=True))
            grad_w = _max_abs_vjp(w, wmax, ct_ws * _INV127, 0, group).to(
                kernel.dtype)
        return grad_x, grad_w, None, None, None, None


def int8_dot_general(x: torch.Tensor, kernel: torch.Tensor, impl: str = "xla",
                     group=None, role: str = "row",
                     whole: tuple | None = None) -> torch.Tensor:
    """The dynamic W8A8 product of ``matmul_precision="int8"``: ``x [...,
    K] @ kernel [K, N]`` with the kernel quantised per output column at
    every call (JAX's ``int8_dot_general``; nothing is cached across calls,
    as there), then :func:`w8a8_dot`.

    ``kernel`` is the kernel after flax's cast to the compute dtype (bf16,
    or fp32, which keeps its values), so at bf16 the codes and scales equal
    :func:`quantize_params_static`'s bit for bit: ``s = max|w| * _INV127``, ``q = round(w / max(s, 1e-12))``, half
    to even.  Where ``impl`` is "fused" or "pallas" the codes are made
    K-major (``kernel.t()``, the layout their s8 ``wgmma`` GEMM reads) and
    ``w_q`` is that copy's transposed view, so one quantisation serves
    both.

    Where autograd records and ``x`` or ``kernel`` needs a gradient, the
    product is :class:`_Int8DotGeneral` (the forward the same, the
    backward JAX's cotangents); else nothing is saved.

    ``group``: the tensor-parallel model group, and ``role`` the
    projection's part.  "row": ``x`` holds a rank's columns and ``kernel``
    its rows; the maxima and the int32 product are taken over the group,
    so every rank gets the one-card product (on the card B4's split entry
    under "fused", B14's under "pallas").  "col": ``kernel`` holds a
    rank's columns; the forward needs no collective, the backward one (see
    :class:`_Int8DotGeneral`).  ``whole``: the whole kernel's ``(K, N)``,
    :func:`w8a8_dot`'s kernel gate."""
    if role not in ("row", "col"):
        raise ValueError(f"int8_dot_general: role {role!r}")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return _Int8DotGeneral.apply(x, kernel, impl, group, role, whole)
    return _dynamic_dot(x, kernel, impl, group if role == "row" else None,
                        whole)


def round_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round fp32 values to the nearest bf16 (ties to even), as fp32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _quantize_leaf(src: dict) -> dict:
    """``{kernel[, bias]}`` -> ``{kernel_q, kernel_scale[, bias]}``:
    per-output-column absmax int8 of ``[..., K, N]`` after the bf16 round
    the dynamic path's compute-dtype promotion applies."""
    w = round_to_bf16(np.asarray(src["kernel"], np.float32))
    s = np.abs(w).max(axis=-2, keepdims=True) * np.float32(_INV127)
    q = np.round(w / np.maximum(s, np.float32(1e-12))).astype(np.int8)
    leaf = {"kernel_q": q, "kernel_scale": s.astype(np.float32)}
    if "bias" in src:
        leaf["bias"] = src["bias"]
    return leaf


def quantize_params_static(params: dict, cfg) -> dict:
    """Convert a dense (bf16/fp32) DiT param tree, as nested dicts of numpy
    arrays, to the int8_static serving layout of ``cfg`` (a
    ``ModelConfig``), as the JAX package's version does for the static
    model's tree.

    With ``cfg.fused_qkv`` the q/k/v projections are concatenated on the
    feature axis into ``qkv_proj`` first (per-column scales keep that
    identical to three separate products); else they stay ``q_proj``,
    ``k_proj`` and ``v_proj``.  Every projection the static model holds as
    int8 (``patch_in``, ``patch_out``, the attention projections,
    ``mlp_in``, ``mlp_out``, and ``final_proj`` under
    ``cfg.quantize_head``) becomes ``{kernel_q, kernel_scale[, bias]}``,
    each kernel rounded through bf16 (the compute dtype) first.  Stacked
    ``[depth, K, N]`` kernels are fine.  Everything else (``pos_embed``
    too) is passed through unchanged.
    """
    fused = cfg.fused_qkv
    quantized = {"patch_in", "patch_out", "out_proj", "mlp_in", "mlp_out"}
    quantized |= {"qkv_proj"} if fused else {"q_proj", "k_proj", "v_proj"}
    if cfg.quantize_head:
        quantized.add("final_proj")
    return _quantize_tree(params, quantized, fused)


def _quantize_tree(params: dict, quantized: set, fused: bool) -> dict:
    out = {}
    for k, v in params.items():
        if fused and k == "q_proj":
            parts = [params[n] for n in ("q_proj", "k_proj", "v_proj")]
            merged = {"kernel": np.concatenate(
                [np.asarray(p["kernel"], np.float32) for p in parts], axis=-1)}
            if "bias" in parts[0]:
                merged["bias"] = np.concatenate(
                    [np.asarray(p["bias"]) for p in parts], axis=-1)
            out["qkv_proj"] = _quantize_leaf(merged)
        elif fused and k in ("k_proj", "v_proj"):
            continue
        elif k in quantized and isinstance(v, dict) and "kernel" in v:
            out[k] = _quantize_leaf(v)
        elif isinstance(v, dict):
            out[k] = _quantize_tree(v, quantized, fused)
        else:
            out[k] = v
    return out
